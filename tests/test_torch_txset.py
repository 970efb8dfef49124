"""The port's txset layer against the JAX package's, on the CPU.

One mixed set of 44 one-Payment transactions (tests/torch_tx_parity.py:
multisig, fee bumps, a flipped signature byte, an unneeded signature,
bad sequence numbers, balances below the fee, payments that fail at
apply, two-transaction chains) is built with the JAX package and carried
into the port as bytes. Both packages give the same contents hash, apply
order, check_valid verdict, trim_invalid output, result bytes and ledger
after commit: through the native per-signature path, through the
herder's lazy prevalidator over an oracle-backed stand-in for the batch
verifier (no XLA, no kernel), and when that stand-in raises. One test
runs the port's plain kernels (`CudaBatchVerifier(device="cpu")`) under
the prevalidator; one runs chip_smoke.py's phase 9 functions on a small
set against the JAX package; one runs phase 10's (the load generator's
MIXED_CLASSIC and PRETEND traffic) through the port's plain kernels and
the native path, against the JAX package."""

import hashlib

import pytest

from torch_tx_parity import (J, NETWORK_ID, P, OracleVerifier,
                             clear_caches, frame_of, jax_mixed_set,
                             jax_root_copy, port_root, run_set)

RESULT_KEYS = ("excluded", "contents_hash", "set_bytes", "apply_order",
               "verdict", "kept", "dropped", "codes", "applied", "order",
               "results", "state")


@pytest.fixture(autouse=True)
def _fresh_verify_caches():
    clear_caches()
    yield
    clear_caches()


@pytest.fixture(scope="module")
def mixed():
    return jax_mixed_set()


def _same(a, b, keys=RESULT_KEYS):
    for k in keys:
        assert a[k] == b[k], k


def test_mixed_set_matches_jax_on_the_host_path(mixed):
    root, envs, kinds = mixed
    j = run_set(J, jax_root_copy(root), envs)
    p = run_set(P, port_root(root), envs)
    _same(j, p)
    # what the mix is for: the set is invalid as a whole, trim drops
    # exactly the txs that fail validation, apply fails only the
    # payments their sources cannot cover
    assert j["verdict"] is False and not j["excluded"]
    by_hash = {frame_of(J, e).full_hash(): k for e, k in zip(envs, kinds)}
    dropped = sorted(by_hash[h] for h in j["dropped"])
    assert dropped == sorted(["flipped", "extra_sig", "bad_seq", "bad_seq",
                              "low_balance", "low_balance"])
    failed = [by_hash[h] for h, ok in zip(j["order"], j["applied"])
              if not ok]
    assert failed == ["underfunded_op"] * 2
    assert len(j["kept"]) == len(envs) - 6


def test_mixed_set_matches_jax_through_the_prevalidator(mixed):
    """Both sides send the same single verify_tuples call (the tuples of
    collect_signature_tuples, the cache being empty) and end where the
    host path ends."""
    root, envs, _ = mixed
    host = run_set(P, port_root(root), envs)
    jv, pv = OracleVerifier(), OracleVerifier()
    j = run_set(J, jax_root_copy(root), envs, jv)
    p = run_set(P, port_root(root), envs, pv)
    _same(j, p, RESULT_KEYS + ("pv",))
    _same(host, p)
    assert jv.calls == pv.calls and len(pv.calls) == 1
    frames = [frame_of(P, e) for e in envs]
    assert sorted(pv.calls[0]) == \
        sorted(P.checker.collect_signature_tuples(frames))
    hits, misses = p["pv"]
    assert hits > 0 and misses > 0      # multisig second sigs, fee bumps


def test_batch_failure_falls_back_alike(mixed):
    """A stand-in that raises: both sides log it, validate and apply on
    the native per-signature path, and end as the host path does."""
    root, envs, _ = mixed
    host = run_set(P, port_root(root), envs)
    jv, pv = OracleVerifier(fail=True), OracleVerifier(fail=True)
    j = run_set(J, jax_root_copy(root), envs, jv)
    p = run_set(P, port_root(root), envs, pv)
    _same(j, p, RESULT_KEYS + ("pv",))
    _same(host, p)
    assert jv.calls == pv.calls and len(pv.calls) == 1
    assert p["pv"][0] == 0               # nothing came from the batch


def _validate_twice(pkg, root, envs):
    """check_valid through two fresh prevalidators in a row: the second
    finds every tuple in the verify cache the first seeded."""
    pkg.keys.clear_verify_cache()
    frames = [frame_of(pkg, e) for e in envs]
    _, applicable, _ = pkg.tx_set.make_tx_set_from_transactions(
        frames, root.get_header(), NETWORK_ID)
    stand_in = OracleVerifier()
    verdicts = []
    for _ in range(2):
        lazy = pkg.herder._LazyBatchPrevalidator(
            stand_in, applicable, pkg.checker.default_verify)
        verdicts.append(applicable.check_valid(root, verify=lazy))
    return stand_in.calls, verdicts, (lazy._pv.hits, lazy._pv.misses)


def test_second_validation_dispatches_nothing(mixed):
    root, envs, _ = mixed
    envs = [e for e, k in zip(envs, mixed[2]) if k in ("plain", "multisig")]
    j = _validate_twice(J, jax_root_copy(root), envs)
    p = _validate_twice(P, port_root(root), envs)
    assert p == j
    calls, verdicts, (hits, misses) = p
    assert len(calls) == 1 and verdicts == [True, True]
    # each tuple is checked twice (the tx's low threshold, then the op's
    # medium one); the two multisig second signatures miss the batch
    assert misses == 2 and hits == 2 * len(calls[0])


def test_collect_signature_tuples_matches(mixed):
    root, envs, _ = mixed
    jf = [frame_of(J, e) for e in envs]
    pf = [frame_of(P, e) for e in envs]
    for nid in (None, NETWORK_ID):
        assert P.checker.collect_signature_tuples(pf, nid) == \
            J.checker.collect_signature_tuples(jf, nid)


def test_prevalidated_verifier_matches():
    """Table hits, misses to the fallback, and counts, alike."""
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    sk = SecretKey.from_seed(b"\x05" * 32)
    good = (sk.public_key().raw, sk.sign(b"m" * 32), b"m" * 32)
    bad = (good[0], good[1], b"n" * 32)
    other = (good[0], sk.sign(b"o" * 32), b"o" * 32)
    outs = []
    for pkg in (J, P):
        pv = pkg.checker.PrevalidatedVerifier(
            fallback=pkg.checker.default_verify)
        pv.add_results([good, bad], [False, True])    # the table wins
        outs.append(([pv(*t) for t in (good, bad, other, other)],
                     pv.hits, pv.misses))
    assert outs[0] == outs[1] == ([False, True, True, True], 2, 2)


def test_plain_kernels_under_the_prevalidator():
    """The port's CudaBatchVerifier on the CPU (the plain prep and ladder,
    one dispatch) under the herder's prevalidator: an 8-transaction set
    ends as the JAX package's host path does."""
    import chip_smoke as cs
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    root, envs, _ = jax_mixed_set(
        8, seed=3, mix=(("multisig", 1), ("fee_bump", 1), ("flipped", 1),
                        ("extra_sig", 1)))
    j = run_set(J, jax_root_copy(root), envs)
    rec = cs.RecordingVerifier(CudaBatchVerifier(device="cpu",
                                                 device_min_batch=1))
    p = run_set(P, port_root(root), envs, rec)
    _same(j, p)
    assert len(rec.calls) == 1 and len(rec.calls[0][0]) == 7
    assert rec.calls[0][1].count(False) == 1        # the flipped byte


def test_chip_smoke_txset_phase_functions_match_jax():
    """chip_smoke.py phase 9's workload builder and run, on a small set
    through the native path, against the JAX package on the same bytes:
    the same verdicts, trim, results and ledger."""
    import chip_smoke as cs
    wl = cs.txset_workload(40)
    got = cs.txset_run(wl)
    jroot = J.ledger_txn.InMemoryLedgerTxnRoot(
        J.ledger.LedgerHeader.from_bytes(wl["header"]))
    for e in wl["entries"]:
        le = J.entries.LedgerEntry.from_bytes(e)
        jroot._entries[J.entries.ledger_entry_key(le).to_bytes()] = le
    want = run_set(J, jroot, wl["envelopes"], network_id=wl["network_id"])
    for key in ("contents_hash", "verdict", "kept", "dropped", "codes",
                "order", "results"):
        assert got[key] == want[key], key
    assert got["applied_ok"] == want["applied"]
    header = want["state"][-1][1]
    assert got["ledger_hash"] == hashlib.sha256(header + b"".join(
        kb + eb for kb, eb in want["state"][:-1])).digest()
    assert len(got["dropped"]) == 2 and all(got["applied_ok"])


def _jax_run_of(wl):
    """The JAX package's txset path on the workload's bytes."""
    jroot = J.ledger_txn.InMemoryLedgerTxnRoot(
        J.ledger.LedgerHeader.from_bytes(wl["header"]))
    for e in wl["entries"]:
        le = J.entries.LedgerEntry.from_bytes(e)
        jroot._entries[J.entries.ledger_entry_key(le).to_bytes()] = le
    return run_set(J, jroot, wl["envelopes"], network_id=wl["network_id"])


def test_chip_smoke_classic_phase_functions_match_jax():
    """chip_smoke.py phase 10's workload at 60 transactions: run A
    through the herder's prevalidator over the port's plain kernels (one
    dispatch), run B through the native path, and the JAX package on the
    same bytes: the same verdicts, trim, result bytes and ledger. The
    flipped transaction alone is dropped, every offer rests, and the
    path payment crossed one."""
    import chip_smoke as cs
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    wl = cs.classic_workload(60)
    rec = cs.RecordingVerifier(CudaBatchVerifier(device="cpu",
                                                 device_min_batch=1))
    a = cs.txset_run(wl, rec)
    b = cs.txset_run(wl)
    want = _jax_run_of(wl)
    for key in ("contents_hash", "verdict", "kept", "dropped", "codes",
                "order", "results"):
        assert a[key] == b[key] == want[key], key
    assert a["applied_ok"] == b["applied_ok"] == want["applied"]
    header = want["state"][-1][1]
    assert a["ledger_hash"] == b["ledger_hash"] == hashlib.sha256(
        header + b"".join(kb + eb for kb, eb in want["state"][:-1])).digest()
    assert len(rec.calls) == 1 and len(rec.calls[0][0]) == 60
    assert rec.calls[0][1].count(False) == 1        # the flipped byte
    by_hash = cs.kinds_by_hash(wl)
    assert [by_hash[h] for h in a["dropped"]] == ["flipped"]
    codes, failed, crossed = cs.classic_outcomes(a, by_hash)
    assert not failed and crossed == 1
    assert a["offers"] == wl["kinds"].count("offer") == 24
    ops = {op for op, _ in codes}
    assert ops == {"MANAGE_SELL_OFFER", "PAYMENT", "SET_OPTIONS",
                   "MANAGE_DATA", "PATH_PAYMENT_STRICT_SEND",
                   "CHANGE_TRUST", "CREATE_ACCOUNT"}
