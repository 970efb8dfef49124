"""On the card: each CUDA kernel against its plain version, byte for byte
(on the corpus, on edge scalars, and at batch sizes that leave partial
blocks and partial four-lane groups), and CudaBatchVerifier and the live
stack (VerifyService -> BackendSupervisor -> card), the sharded verifier
on a stand-in mesh of four positions, the v1 entry against the oracle, and
the txset validation path (chip_smoke.py phase 9 at 64 transactions),
the classic operation families on it (phase 10 at 64 transactions), the
contract auth-entry batches of phase 11 at 200 transactions and the wasm
contracts of phase 12 at 200 transactions.
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


def test_sharded_stand_in_mesh_on_card(card):
    """ShardedBatchVerifier over four positions on one card: verdicts equal
    the oracle over 4, (0, 2, 3) and (1,) active positions and a pinned
    probe, each kernel launched once per non-empty shard."""
    from stellar_core_tpu_torch.ops.verifier import ShardedBatchVerifier
    items = make_differential_vectors(40, seed=21)
    want = oracle_results(items)
    v = ShardedBatchVerifier([card] * 4)
    for active in ((0, 1, 2, 3), (0, 2, 3), (1,)):
        v.set_active_devices(active)
        before = (EK.prep.launches, LD.ladder.launches)
        assert v.verify_tuples(items) == want
        assert (EK.prep.launches - before[0],
                LD.ladder.launches - before[1]) == (len(active),) * 2
    before = LD.ladder.launches
    assert v.verify_tuples_async_on(3, items[:5])() == want[:5]
    assert LD.ladder.launches == before + 1 and v.active_indices() == (1,)


def test_v1_entry_on_card(card, lanes):
    """host_prepare -> verify_kernel on the card equals the same entry on
    the CPU (the plain ladder) and, with the host's flags, the oracle."""
    from stellar_core_tpu_torch.ops.verifier import host_prepare
    pubs, sigs, msgs, _ = lanes
    k, neg_a, ok = host_prepare(pubs, sigs, msgs)
    args = [np.ascontiguousarray(x) for x in (
        sigs[:, 32:], k, neg_a[:, :32], neg_a[:, 32:], sigs[:, :32])]
    got = EK.verify_kernel(*[_on(card, x) for x in args]).cpu()
    assert torch.equal(got, EK.verify_kernel(*[torch.from_numpy(x)
                                               for x in args]))
    assert (got & torch.from_numpy(ok)).tolist() == [
        ref.verify(bytes(p), bytes(s), m) for p, s, m in zip(pubs, sigs,
                                                             msgs)]


def test_txset_validation_on_card(card):
    """A 64-transaction set (chip_smoke.py phase 9's builder and runs,
    with its chosen mix) validated through the herder's prevalidator over
    BackendSupervisor(CudaBatchVerifier()) on the card equals the host
    path: verdicts, trim, result bytes and ledger hash. One device batch
    (prep 1 + ladder 1) of the paired signatures, equal to the oracle;
    the supervisor stays CLOSED with no failure and no skip."""
    import chip_smoke as cs
    from stellar_core_tpu_torch.ops.backend_supervisor import (
        CLOSED, BackendSupervisor)
    wl = cs.txset_workload(64)
    sup = BackendSupervisor(CudaBatchVerifier(device=card))
    try:
        rec = cs.RecordingVerifier(sup)
        before = (EK.prep.launches, LD.ladder.launches)
        a = cs.txset_run(wl, rec)
        launched = (EK.prep.launches - before[0],
                    LD.ladder.launches - before[1])
        st = sup.status()
    finally:
        sup.shutdown()
    b = cs.txset_run(wl)
    for key in ("contents_hash", "verdict", "kept", "dropped", "codes",
                "order", "results", "applied_ok", "ledger_hash"):
        assert a[key] == b[key], key
    assert launched == (1, 1) and len(rec.calls) == 1
    items, got, _ = rec.calls[0]
    assert got == [ref.verify(*t) for t in items]
    assert a["again_calls"] == 0 and a["again"].hits > 0
    assert st["state"] == CLOSED and not any(st["failures"].values())
    assert st["skips"] == 0 and st["transitions"] == []


def test_classic_txset_on_card(card):
    """chip_smoke.py phase 10's builder and runs at 64 transactions (the
    load generator's MIXED_CLASSIC and PRETEND traffic): the card path
    equals the host path on verdicts, trim, result bytes, resting offers
    and ledger hash, with one device batch (prep 1 + ladder 1) equal to
    the oracle; the flipped transaction alone is dropped, a path payment
    crossed an offer, and the supervisor stays CLOSED."""
    import chip_smoke as cs
    from stellar_core_tpu_torch.ops.backend_supervisor import (
        CLOSED, BackendSupervisor)
    wl = cs.classic_workload(64)
    sup = BackendSupervisor(CudaBatchVerifier(device=card))
    try:
        rec = cs.RecordingVerifier(sup)
        before = (EK.prep.launches, LD.ladder.launches)
        a = cs.txset_run(wl, rec)
        launched = (EK.prep.launches - before[0],
                    LD.ladder.launches - before[1])
        st = sup.status()
    finally:
        sup.shutdown()
    b = cs.txset_run(wl)
    for key in ("contents_hash", "verdict", "kept", "dropped", "codes",
                "order", "results", "applied_ok", "offers", "ledger_hash"):
        assert a[key] == b[key], key
    assert launched == (1, 1) and len(rec.calls) == 1
    items, got, _ = rec.calls[0]
    assert got == [ref.verify(*t) for t in items] and got.count(False) == 1
    by_hash = cs.kinds_by_hash(wl)
    assert [by_hash[h] for h in a["dropped"]] == ["flipped"]
    _, failed, crossed = cs.classic_outcomes(a, by_hash)
    assert not failed and crossed >= 1
    assert a["again_calls"] == 0 and a["again"].hits > 0
    assert st["state"] == CLOSED and not any(st["failures"].values())
    assert st["skips"] == 0 and st["transitions"] == []


def test_soroban_txset_on_card(card):
    """chip_smoke.py phase 11 at 200 transactions, with its checks: the
    validation batch and catchup's apply-time batch (envelope and
    auth-entry signatures) each one dispatch on the card equal to the
    oracle, false exactly on the flipped signatures; every auth verify
    of the host's a verify-cache hit; results by kind, nonces, and the
    card run equal to the native run on results, balances and ledger
    hash; the supervisor CLOSED with 0 failures and 0 skips."""
    import chip_smoke as cs
    try:
        launches = cs.soroban_phase(str(card), n=200)
    except SystemExit as e:
        pytest.fail(str(e))
    assert launches == {"msg32": 2, "k": 0, "ladder": 2}


def test_wasm_txset_on_card(card):
    """chip_smoke.py phase 12 at 200 transactions, with its checks: the
    validation batch and catchup's apply-time batch each one dispatch on
    the card equal to the oracle, false exactly on the flipped
    signatures; the host's auth verifies verify-cache hits and its
    contract-level verifies the only misses; results by kind, events,
    nonces, the counter and the module cache; the card run equal to the
    native run on results, events and ledger hash; the supervisor CLOSED
    with 0 failures and 0 skips."""
    import chip_smoke as cs
    try:
        launches = cs.wasm_phase(str(card), n=200)
    except SystemExit as e:
        pytest.fail(str(e))
    assert launches == {"msg32": 2, "k": 0, "ladder": 2}


def test_close_on_card(card):
    """chip_smoke.py phase 13 at 2 closes of 100 transactions over 200
    accounts, with its checks: the staged apply's per-stage prewarm
    through VerifyService(BackendSupervisor(CudaBatchVerifier())) on the
    card (stages of 98 and 2: one device dispatch and one native bypass
    per close), every verdict equal to the oracle; the verify cache's
    hits and misses during each close; the card run equal to the native
    run on every header, result, meta and bucket level and on the final
    rows; the reload; the supervisor CLOSED with 0 failures and 0
    skips."""
    import chip_smoke as cs
    try:
        launches = cs.close_phase(str(card), accounts=200, txs=100,
                                  ledgers=2)
    except SystemExit as e:
        pytest.fail(str(e))
    assert launches == {"msg32": 2, "k": 0, "ladder": 2}


def test_catchup_on_card(card):
    """chip_smoke.py phase 14 at a small size, with its checks: a
    port-published archive of two checkpoints (200 accounts, 59 closes
    of 5 and 65 of 100 payments) replayed by StreamingCatchupWork (run
    A1) and the sequential CatchupWork to ledger 80 (run A2), each
    checkpoint's signatures in one dispatch through
    BackendSupervisor(CudaBatchVerifier()) on the card: launches equal
    to the dispatches, hits equal to the publisher's signature checks,
    0 misses, 0 fallback calls, the native verdicts, the supervisor
    CLOSED."""
    import chip_smoke as cs
    try:
        launches, _ = cs.catchup_phase(str(card), accounts=200, txs=100,
                                       ledgers=65, quiet=59, quiet_txs=5)
    except SystemExit as e:
        pytest.fail(str(e))
    assert launches["k"] == 0
    assert 3 <= launches["msg32"] == launches["ladder"] <= 4
