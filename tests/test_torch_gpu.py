"""On the card: each CUDA kernel against its plain version, byte for byte
(on the corpus, on edge scalars, and at batch sizes that leave partial
blocks and partial four-lane groups), and CudaBatchVerifier and the live
stack (VerifyService -> BackendSupervisor -> card) against the oracle.
Marked `gpu`; skipped where torch sees no CUDA device. Run on a machine with a card:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from stellar_core_tpu_torch.crypto import ed25519_ref as ref
from stellar_core_tpu_torch.ops import ed25519_kernel as EK
from stellar_core_tpu_torch.ops import ladder as LD
from stellar_core_tpu_torch.ops.testvectors import (edge_scalar_lanes,
                                                    make_differential_vectors,
                                                    oracle_results)
from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier, host_k

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    # decided here, not at import: every xdist worker collects the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def lanes():
    """The differential corpus plus random garbage lanes (invalid points,
    S >= L): (pubs, sigs, msgs, random 32-byte messages)."""
    items = make_differential_vectors(40)
    rng = np.random.default_rng(3)
    pubs = np.concatenate([
        np.frombuffer(b"".join(p for p, _, _ in items), np.uint8)
        .reshape(-1, 32), rng.integers(0, 256, (64, 32)).astype(np.uint8)])
    sigs = np.concatenate([
        np.frombuffer(b"".join(s for _, s, _ in items), np.uint8)
        .reshape(-1, 64), rng.integers(0, 256, (64, 64)).astype(np.uint8)])
    msgs = [m for _, _, m in items] + [bytes(rng.integers(0, 256, 32)
                                             .astype(np.uint8))
                                       for _ in range(64)]
    m32 = rng.integers(0, 256, (len(msgs), 32)).astype(np.uint8)
    return pubs, sigs, msgs, m32


def _on(dev, x):
    return torch.from_numpy(np.array(x)).to(dev)


@pytest.mark.parametrize("mode", [EK.MODE_MSG32, EK.MODE_K])
def test_prep_kernel_matches_plain(card, lanes, mode):
    pubs, sigs, msgs, m32 = lanes
    mk = m32 if mode == EK.MODE_MSG32 else host_k(pubs, sigs, msgs)
    args = [_on(card, x) for x in (pubs, sigs[:, :32], sigs[:, 32:], mk)]
    got = EK.prep(*args, mode)
    want = EK.prep_plain(*args, mode)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_ladder_kernel_matches_plain(card, lanes):
    pubs, sigs, msgs, _ = lanes
    a, r, s = (_on(card, x) for x in (pubs, sigs[:, :32], sigs[:, 32:]))
    k, neg_a, _ = EK.prep(a, r, s, _on(card, host_k(pubs, sigs, msgs)),
                          EK.MODE_K)
    nax, nay = neg_a[:, :32].contiguous(), neg_a[:, 32:].contiguous()
    got = LD.ladder(s, k, nax, nay)
    want = LD.ladder_plain(s, k, nax, nay)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ladder_kernel_matches_plain_on_edge_scalars(card):
    e = edge_scalar_lanes()
    args = [_on(card, e[key]) for key in ("s", "k", "neg_ax", "neg_ay")]
    got = LD.ladder(*args)
    want = LD.ladder_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("mode", [EK.MODE_MSG32, EK.MODE_K])
def test_prep_kernel_matches_plain_on_edge_scalars(card, mode):
    """The same S and k rows through prep, with A the encoding of the
    point whose negation the ladder lanes use and R that of 2A."""
    e = edge_scalar_lanes()
    args = [_on(card, e[key]) for key in ("a", "r", "s", "k")]
    got = EK.prep(*args, mode)
    want = EK.prep_plain(*args, mode)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n", [1, 7, 33])
def test_kernels_match_plain_on_tails(card, lanes, n):
    """n = 1, 7 and 33 leave a partial block of the ladder (32 signatures
    of four lanes each) and of prep, and dead four-lane groups."""
    pubs, sigs, msgs, m32 = lanes
    a, r, s, m = (_on(card, x[:n]) for x in (pubs, sigs[:, :32],
                                              sigs[:, 32:], m32))
    got = EK.prep(a, r, s, m, EK.MODE_MSG32)
    want = EK.prep_plain(a, r, s, m, EK.MODE_MSG32)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    k, neg_a, _ = got
    nax, nay = neg_a[:, :32].contiguous(), neg_a[:, 32:].contiguous()
    got = LD.ladder(s, k, nax, nay)
    want = LD.ladder_plain(s, k, nax, nay)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_verifier_matches_oracle_on_card(card):
    items = make_differential_vectors(40, seed=9)
    want = oracle_results(items)
    for sha in (True, False):
        got = CudaBatchVerifier(device=card, device_sha=sha).verify_tuples(
            items)
        assert got == want
    m32 = [it for it in items if len(it[2]) == 32]
    before = (EK.prep.launches, LD.ladder.launches)
    assert CudaBatchVerifier(device=card).verify_tuples(m32) == \
        [ref.verify(*it) for it in m32]
    assert (EK.prep.launches, LD.ladder.launches) == \
        (before[0] + 1, before[1] + 1)


def test_live_stack_on_card(card):
    """512 tuples through VerifyService -> BackendSupervisor ->
    CudaBatchVerifier at the node's defaults (max_batch 256, device
    cutoff 16, canary 16): verdicts equal the oracle, each kernel
    launches once per device dispatch of the supervisor, no failure
    and no fallback."""
    from stellar_core_tpu_torch.crypto.keys import clear_verify_cache
    from stellar_core_tpu_torch.ops.backend_supervisor import \
        BackendSupervisor
    from stellar_core_tpu_torch.ops.verify_service import VerifyService
    from stellar_core_tpu_torch.util.metrics import MetricsRegistry
    corpus = make_differential_vectors(40, seed=13)
    items = [corpus[i % len(corpus)] for i in range(512)]
    items = [(p, s, m + bytes([i % 251]) * (i % 2)) for i, (p, s, m)
             in enumerate(items)]           # distinct tuples, both modes
    reg = MetricsRegistry()
    sup = BackendSupervisor(CudaBatchVerifier(device=card,
                                              device_min_batch=16,
                                              metrics=reg),
                            metrics=reg, canary_batch=16)
    try:
        svc = VerifyService(sup, metrics=reg, max_batch=256)
        clear_verify_cache()
        before = (EK.prep.launches, LD.ladder.launches)
        got = [f.result() for f in svc.submit_many(items)]
        svc.drain()
        assert got == oracle_results(items)
        st = sup.status()
        launched = (EK.prep.launches - before[0],
                    LD.ladder.launches - before[1])
        assert st["dispatches"] >= 2 and launched == (st["dispatches"],) * 2
        assert st["state"] == "CLOSED" and st["transitions"] == []
        assert st["failures"] == {"transient": 0, "fatal": 0, "timeout": 0}
        assert svc.stats()["fallbacks"] == 0
    finally:
        sup.shutdown()
