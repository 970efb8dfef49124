"""On the card: each CUDA kernel against its plain version, byte for byte
(on the corpus, on edge scalars, and at batch sizes that leave partial
blocks and partial four-lane groups), and CudaBatchVerifier and the live
stack (VerifyService -> BackendSupervisor -> card), the sharded verifier
on a stand-in mesh of four positions, the v1 entry against the oracle, and
the txset validation path (chip_smoke.py phase 9 at 64 transactions),
the classic operation families on it (phase 10 at 64 transactions), the
contract auth-entry batches of phase 11 at 200 transactions, the wasm
contracts of phase 12 at 200 transactions, phases 13-17 (the close,
catchup, consensus and flood admission, the node, four node processes
over TCP) at small sizes, phase 18's profiled replays at 2 payments per
ledger, the native XDR codec and the native baseline beside the card, and
the JAX package's north-star catchup test rebound to the port on the
card.
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


def test_consensus_on_card(card):
    """chip_smoke.py phase 15 at 2 measured slots of 100 payments over
    200 accounts, with its checks: four port validators on one virtual
    clock, each admitting every transaction in one burst of 100 through
    its own VerifyService(BackendSupervisor(CudaBatchVerifier())) on the
    card (one device dispatch per node per measured slot), every flood
    verdict equal to the oracle and bad_sig true exactly on the flipped
    ones, every consensus verify counted by route, the same value
    externalized everywhere and the LCL equal to the native run's, the
    supervisors CLOSED with 0 failures and 0 skips; before the runs, both
    kernels held against their plain versions on that burst's 100 rows."""
    import chip_smoke as cs
    rate = (torch.cuda.get_device_properties(card).multi_processor_count
            * cs.IMAD_PER_SM_CLK
            * float(cs.smi("clocks.max.sm").split()[0]) * 1e6)
    try:
        launches, kernels = cs.consensus_phase(str(card), rate, accounts=200,
                                               txs=100, ledgers=2)
    except SystemExit as e:
        pytest.fail(str(e))
    assert launches == {"msg32": 8, "k": 0, "ladder": 8}
    assert {k: e["n"] for k, e in kernels.items()} == {"prep": 100,
                                                       "ladder": 100}


def test_node_on_card(card):
    """chip_smoke.py phase 16 at 2 ledgers, with its checks: four port
    Applications of the port's topologies.core(4) over the overlay's
    loopback links, node 0's load generator creating 1,000 accounts and
    submitting 1,000 payments, run A on SIGNATURE_VERIFY_BACKEND "cuda"
    (each Application builds its own supervisor and service on the card)
    against run B "native", then self_check on node 0. The counts it is
    held to come from tests/node_mix.py --backend on this machine's CPU
    at the same depth (a counting host verifier in place of the card's)."""
    import chip_smoke as cs
    import node_mix
    mix = node_mix.count(ledgers=2, load=cs.NODE_LOAD, port=True,
                         backend=True)
    expected = {k: mix[k] for k in cs.NODE_EXPECTED}
    rate = (torch.cuda.get_device_properties(card).multi_processor_count
            * cs.IMAD_PER_SM_CLK
            * float(cs.smi("clocks.max.sm").split()[0]) * 1e6)
    try:
        launches, kernels = cs.node_phase(str(card), rate, expected,
                                          ledgers=2)
    except SystemExit as e:
        pytest.fail(str(e))
    device = sum(v["device"]["msg32"] for v in expected["verifier"])
    # the phase's device dispatches, self_check's service warm-up of 16
    # and its two 1,024-signature batches
    assert launches == {"msg32": device + 3, "k": 0, "ladder": device + 3}
    assert kernels["prep"]["n"] % 32 and kernels["ladder"]["match"]


def test_cluster_on_card(card):
    """chip_smoke.py phase 17 at 200 accounts and 2 pay rounds of 200,
    with its checks: the command line's self-check on the card, then
    four `python -m stellar_core_tpu_torch run` processes of the port's
    simulation/cluster.py over TCP through the load, bad-signature flood
    and kill -9 churn legs, run A on SIGNATURE_VERIFY_BACKEND "cuda"
    (each node process builds its own supervisor and service on the
    card) against run B "native". The harness kills every process it
    started when a leg fails."""
    import chip_smoke as cs
    rate = (torch.cuda.get_device_properties(card).multi_processor_count
            * cs.IMAD_PER_SM_CLK
            * float(cs.smi("clocks.max.sm").split()[0]) * 1e6)
    try:
        launches, kernels = cs.cluster_phase(str(card), rate, accounts=200,
                                             rounds=2)
    except SystemExit as e:
        pytest.fail(str(e))
    assert launches > 0
    assert kernels["prep"]["match"] and kernels["ladder"]["match"]


def test_catchup_with_device_batch_prevalidation(card, tmp_path):
    """The JAX package's north-star test (tests/test_history_catchup.py
    ::test_catchup_with_tpu_batch_prevalidation) on the port with
    SIGNATURE_VERIFY_BACKEND "cuda": the reference's publishing node,
    rebound to the port, publishes checkpoints 63 and 127; a fresh port
    Application catches up through CatchupWork with each checkpoint's
    signatures batch-verified on the card before apply (the device cutoff
    lowered to 1, so that every batch is a device dispatch): the same
    chain, hits > 0, 0 misses, and kernel launches equal to the device
    dispatches."""
    import chip_smoke as cs
    import test_history_catchup as ref_hc
    from torch_rebind import helper_module
    from stellar_core_tpu_torch.catchup import (CatchupConfiguration,
                                                CatchupWork)
    from stellar_core_tpu_torch.main import Application, get_test_config
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    from stellar_core_tpu_torch.work import State, run_work_to_completion
    hc = helper_module(ref_hc)
    app_a, archive, _ = hc.make_publishing_app(tmp_path)
    try:
        hash_a = bytes(app_a.database.query_one(
            "SELECT ledgerhash FROM ledgerheaders WHERE ledgerseq=127")[0])
        cfg_b = get_test_config()
        cfg_b.NETWORK_PASSPHRASE = app_a.config.NETWORK_PASSPHRASE
        cfg_b.SIGNATURE_VERIFY_BACKEND = "cuda"
        # each of the publisher's checkpoints holds fewer signatures than
        # the node's device cutoff (16), so at the default every batch
        # would take the native bypass: here every batch goes to the card
        cfg_b.VERIFY_DEVICE_MIN_BATCH = 1
        app_b = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME),
                                   cfg_b)
        app_b.start()
        try:
            work = CatchupWork(app_b, archive,
                               CatchupConfiguration(to_ledger=0),
                               batch_grace=60.0)
            assert work.batch_verifier is app_b.batch_verifier
            cs.zero_launches()
            assert run_work_to_completion(app_b, work,
                                          timeout_virtual=3000) == \
                State.WORK_SUCCESS
            launches = cs.launch_counts()
            lm = app_b.ledger_manager
            assert lm.get_last_closed_ledger_num() == 127
            assert lm.get_last_closed_ledger_hash() == hash_a
            pv = [cw.prevalidated for cw in work.applied_checkpoints
                  if cw.prevalidated is not None]
            assert sum(p.hits for p in pv) > 0
            assert sum(p.misses for p in pv) == 0
            dispatches = app_b.metrics.to_json()[
                "crypto.verify.dispatch.batch"]["count"]
            assert dispatches > 0
            assert launches == {"msg32": dispatches, "k": 0,
                                "ladder": dispatches}
        finally:
            app_b.shutdown()
    finally:
        app_a.shutdown()


def test_profile_replays_on_card(card):
    """chip_smoke.py phase 18's replays at 2 payments per ledger, with
    its checks: profile_catchup's publisher, then R1 (SIGNATURE_VERIFY_
    BACKEND "cuda", the native XDR codec on) and R2 (SC_XDR_NATIVE=0),
    each a fresh process whose Application builds its supervisor on the
    card, and R3 (profile_catchup as it is): the publisher's hash at
    ledger 63 in all three, one dispatch of the 123 signatures in R1 and
    R2 with one prep msg32 and one ladder launch each, the supervisors
    CLOSED, the codec's calls in R1's profile only; both kernels held
    against their plain versions on R1's dispatch."""
    import chip_smoke as cs
    rate = (torch.cuda.get_device_properties(card).multi_processor_count
            * cs.IMAD_PER_SM_CLK
            * float(cs.smi("clocks.max.sm").split()[0]) * 1e6)
    try:
        launches, kernels = cs.profile_phase(str(card), rate, payments=2)
    except SystemExit as e:
        pytest.fail(str(e))
    assert launches == {"msg32": 2, "k": 0, "ladder": 2}
    assert kernels["prep"]["n"] == kernels["ladder"]["n"] == 123


def test_codec_and_native_baseline_beside_the_card(card):
    """The native XDR codec is live in a process that builds the kernels
    (a hashed build in native/build), and chip_smoke.py phase 18's native
    baseline gives the card's verdicts on rows a quarter of which the
    strict checks reject."""
    import chip_smoke as cs
    CudaBatchVerifier()
    assert "/native/build/_scxdr_" in cs.codec_path()
    items = make_differential_vectors(40)
    items = [t for t in items if len(t[2]) == 32]
    pubs, sigs, msgs = cs.rows(items)
    want = CudaBatchVerifier().verify_tuples(items)
    assert want == oracle_results(items) and 0 < sum(want) < len(want)
    try:
        out = cs.native_baseline(str(card), {"corpus": (pubs, sigs, msgs,
                                                        want)})
    except SystemExit as e:
        pytest.fail(str(e))
    assert out["corpus"]["n"] == len(items)


def test_differential_suite_on_card(card):
    """tests/test_tpu_hw_differential.py's card job on the port:
    cuda_differential orchestrate at 10,000 signatures plus the
    adversarial tail, the card and the CPU's plain versions in their own
    processes, card == CPU == oracle."""
    import subprocess
    import sys
    from pathlib import Path
    res = subprocess.run(
        [sys.executable, "-m",
         "stellar_core_tpu_torch.scripts.cuda_differential", "orchestrate",
         "--n", "10000"], capture_output=True, text=True,
        cwd=Path(__file__).resolve().parents[1], timeout=3600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "CUDA DIFFERENTIAL: PASS" in res.stdout


def test_differential_fast_on_card(card):
    """The fast tier: the card against the oracle at 200 signatures plus
    the whole adversarial tail."""
    import subprocess
    import sys
    from pathlib import Path
    res = subprocess.run(
        [sys.executable, "-m",
         "stellar_core_tpu_torch.scripts.cuda_differential", "fast"],
        capture_output=True, text=True,
        cwd=Path(__file__).resolve().parents[1], timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "FAST DIFFERENTIAL: PASS" in res.stdout
