"""The port's persistence and ledger close (db/, the SQL LedgerTxnRoot,
bucket/, history/archive.py, main/persistent_state.py, herder/upgrades.py,
ledger/{completion,parallel_apply,ledger_manager}.py) against the JAX
package's, on the CPU.

Each package runs a node of its own: LedgerManager(db=Database(a sqlite
file in tmp_path), bucket_manager=BucketManager(a directory in tmp_path))
with the persistent state and network passphrase the Application gives
it, genesis at protocol 21, a close that votes maxTxSetSize, a close that
creates 40 accounts, then 8 closes of 20 payments (chip_smoke.close_run).
The transactions are built and signed by the JAX package
(tests/txtest_utils.py) and cross into the port as envelope bytes. Per
close: equal header bytes and hash, result pairs, LedgerCloseMeta bytes,
bucket-list hash and the hashes of every bucket level; at the end equal
rows of every entry table, storestate and the history tables, and equal
bucket files. Both in the sequential apply and in the node's staged apply
(4 workers from 8 transactions), where each stage's prewarm tuples are
the same multiset in both packages (a stand-in service on the JAX side,
the port's VerifyService(BackendSupervisor(OracleVerifier())) on its
own). The port reloads its own files and the JAX package's, and closes on
from them. chip_smoke.py phase 13's workload crosses the other way, and
its prewarm runs once through CudaBatchVerifier(device="cpu"): the one
plain-kernel dispatch of this file.
"""

import collections
import hashlib
import shutil

import numpy as np
import pytest

import chip_smoke as cs
from torch_tx_parity import J as JP, P as PP, OracleVerifier, clear_caches
from txtest_utils import op_create_account, op_payment, sign_frame

NETWORK_ID = hashlib.sha256(cs.CLOSE_PASSPHRASE.encode()).digest()
ACCOUNTS, TXS, LEDGERS = 40, 20, 8
CONFLICT_AT, FLIPPED_AT = 3, 5          # measured closes with those kinds


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_caches()
    yield
    clear_caches()


def jax_workload(seed=13):
    """The closes as envelope bytes, built and signed by the JAX package:
    the maxTxSetSize vote, one close creating ACCOUNTS accounts from the
    master, LEDGERS closes of TXS payments over disjoint pairs of a
    seeded permutation (close CONFLICT_AT has two transactions paying
    one destination, close FLIPPED_AT one flipped signature byte), and
    a close in which each account pays the next (one conflict chain)."""
    from stellar_core_tpu.crypto.keys import SecretKey
    from stellar_core_tpu.tx.frame import make_frame
    from stellar_core_tpu.xdr.ledger import LedgerUpgrade, LedgerUpgradeType
    from stellar_core_tpu.xdr.transaction import (
        MuxedAccount, Preconditions, Transaction, TransactionEnvelope,
        TransactionV1Envelope)
    from stellar_core_tpu.xdr.types import EnvelopeType, PublicKey

    rng = np.random.default_rng(seed)
    master = SecretKey.from_seed(NETWORK_ID)
    keys = [SecretKey.from_seed(hashlib.sha256(b"close test %d" % i)
                                .digest()) for i in range(ACCOUNTS)]
    seqs = {}

    def envelope(sk, seq, ops, flip=False):
        tx = Transaction(
            sourceAccount=MuxedAccount.from_ed25519(sk.public_key().raw),
            fee=100 * len(ops), seqNum=seq, cond=Preconditions(0),
            operations=list(ops))
        frame = make_frame(TransactionEnvelope(
            EnvelopeType.ENVELOPE_TYPE_TX,
            TransactionV1Envelope(tx=tx, signatures=[])), NETWORK_ID)
        sign_frame(frame, sk)
        if flip:
            sig = bytearray(frame.signatures[0].signature)
            sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
            frame.signatures[0].signature = bytes(sig)
        return frame.envelope.to_bytes()

    def pay(i, j, amount):
        seqs[i] += 1
        return envelope(keys[i], seqs[i], [op_payment(
            MuxedAccount.from_ed25519(keys[j].public_key().raw), amount)],
            flip=False)

    up = LedgerUpgrade(LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE,
                       cs.CLOSE_MAX_TX_SET)
    closes = [dict(tag="upgrade", envelopes=[], upgrades=[up.to_bytes()])]
    closes.append(dict(tag="create", upgrades=[], envelopes=[envelope(
        master, (1 << 32) + 1,
        [op_create_account(PublicKey.ed25519(k.public_key().raw),
                           10 ** 10) for k in keys])]))
    seqs.update({i: 3 << 32 for i in range(ACCOUNTS)})
    for n in range(LEDGERS):
        perm = [int(x) for x in rng.permutation(ACCOUNTS)]
        envs = []
        for j in range(TXS):
            src, dst = perm[2 * j], perm[2 * j + 1]
            if n == CONFLICT_AT and j == 1:
                dst = perm[1]           # pays tx 0's destination
            amount = 1000 + int(rng.integers(10 ** 6))
            if n == FLIPPED_AT and j == 2:
                seqs[src] += 1
                envs.append(envelope(keys[src], seqs[src], [op_payment(
                    MuxedAccount.from_ed25519(keys[dst].public_key().raw),
                    amount)], flip=True))
            else:
                envs.append(pay(src, dst, amount))
        closes.append(dict(tag="measured", envelopes=envs, upgrades=[]))
    closes.append(dict(tag="control", upgrades=[], envelopes=[
        pay(i, (i + 1) % ACCOUNTS, 777) for i in range(TXS)]))
    return {"network_id": NETWORK_ID, "passphrase": cs.CLOSE_PASSPHRASE,
            "closes": closes}


WL = jax_workload()


def assert_runs_equal(a, b):
    assert len(a["ledgers"]) == len(b["ledgers"]) > 0
    assert a["genesis"] == b["genesis"]
    for la, lb in zip(a["ledgers"], b["ledgers"]):
        for key in ("header", "hash", "results", "meta", "buckets",
                    "widths"):
            assert la[key] == lb[key], (la["tag"], key)
    assert a["rows"] == b["rows"]
    assert a["files"] == b["files"]
    assert a["lcl"] == b["lcl"]


def results_by_code(run):
    from stellar_core_tpu_torch.xdr.results import TransactionResultPair
    return [collections.Counter(
        TransactionResultPair.from_bytes(r).result.result.disc.name
        for r in led["results"]) for led in run["ledgers"]]


class RecordingService:
    """A verify service that records each stage's prewarm tuples (one
    submit_many per stage) and passes them to `inner` (a VerifyService),
    or resolves them without verifying when there is none."""

    def __init__(self, inner=None):
        self.inner = inner
        self.stages = []

    def submit_many(self, items):
        self.stages.append(sorted(items))
        if self.inner is not None:
            return self.inner.submit_many(items)
        done = type("Done", (), {"result": lambda self: True})()
        return [done] * len(items)


@pytest.fixture(scope="module")
def sequential(tmp_path_factory):
    d = tmp_path_factory.mktemp("sequential")
    return (cs.close_run(WL, str(d / "jax"), pkg=JP, staged=False),
            cs.close_run(WL, str(d / "port"), staged=False), d)


def test_sequential_closes_equal(sequential):
    j, p, _ = sequential
    assert_runs_equal(j, p)
    assert [led["tag"] for led in p["ledgers"]] == \
        ["upgrade", "create"] + ["measured"] * LEDGERS + ["control"]
    assert all(len(led["widths"]) == len(c["envelopes"])
               for led, c in zip(p["ledgers"], WL["closes"]))
    codes = results_by_code(p)
    assert codes[2 + FLIPPED_AT] == {"txSUCCESS": TXS - 1, "txBAD_AUTH": 1}
    assert all(c == {"txSUCCESS": TXS} for i, c in enumerate(codes[2:])
               if i != FLIPPED_AT)
    header = PP.ledger.LedgerHeader.from_bytes(p["ledgers"][-1]["header"])
    assert header.maxTxSetSize == cs.CLOSE_MAX_TX_SET
    assert header.ledgerSeq == len(WL["closes"]) + 1


def test_port_reloads_its_own_files_and_the_jax_packages(sequential):
    j, p, d = sequential
    want = (True, j["lcl"], len(WL["closes"]) + 1)
    assert cs.close_reload(str(d / "port"), cs.CLOSE_PASSPHRASE) == want
    # state crossing as files: the JAX package's database and bucket
    # directory, copied, loaded by the port's LedgerManager
    shutil.copytree(d / "jax", d / "jax_copy")
    assert cs.close_reload(str(d / "jax_copy"), cs.CLOSE_PASSPHRASE) == want
    assert cs.close_reload(str(d / "jax"), cs.CLOSE_PASSPHRASE,
                           pkg=JP) == want


def _close_on(pkg, directory, envelopes, close_time):
    """Reload the node in `directory` and close one more ledger of
    `envelopes`: (header bytes, hash, meta bytes)."""
    metas = []
    lm = cs.close_node(pkg, directory, cs.CLOSE_PASSPHRASE, metas.append)
    try:
        assert lm.load_last_known_ledger()
        lcl = lm.get_last_closed_ledger_header()
        frames = [pkg.frame.make_frame(
            pkg.transaction.TransactionEnvelope.from_bytes(b), NETWORK_ID)
            for b in envelopes]
        frame, _, _ = pkg.tx_set.make_tx_set_from_transactions(
            frames, lcl, NETWORK_ID)
        lm.close_ledger(pkg.ledger_manager.LedgerCloseData(
            lcl.ledgerSeq + 1, frame, pkg.ledger.StellarValue(
                txSetHash=frame.get_contents_hash(), closeTime=close_time)))
        lm.join_completion()
        return (lm.get_last_closed_ledger_header().to_bytes(),
                lm.get_last_closed_ledger_hash(), metas[-1].to_bytes())
    finally:
        lm.bucket_manager.shutdown()
        lm.db.close()


def test_port_closes_on_from_the_jax_packages_files(sequential, tmp_path):
    """The port, over a copy of the JAX package's database and bucket
    directory, closes the next ledger as the JAX package does over its
    own."""
    _, _, d = sequential
    for name in ("jax_a", "jax_b"):
        shutil.copytree(d / "jax", tmp_path / name)
    from stellar_core_tpu.crypto.keys import SecretKey
    from stellar_core_tpu.tx.frame import make_frame
    from stellar_core_tpu.xdr.transaction import (
        MuxedAccount, Preconditions, Transaction, TransactionEnvelope,
        TransactionV1Envelope)
    from stellar_core_tpu.xdr.types import EnvelopeType
    master = SecretKey.from_seed(NETWORK_ID)
    dest = SecretKey.from_seed(hashlib.sha256(b"close test 0").digest())
    frame = make_frame(TransactionEnvelope(
        EnvelopeType.ENVELOPE_TYPE_TX, TransactionV1Envelope(
            tx=Transaction(
                sourceAccount=MuxedAccount.from_ed25519(
                    master.public_key().raw),
                fee=100, seqNum=(1 << 32) + 2, cond=Preconditions(0),
                operations=[op_payment(MuxedAccount.from_ed25519(
                    dest.public_key().raw), 12345)]),
            signatures=[])), NETWORK_ID)
    sign_frame(frame, master)
    envs = [frame.envelope.to_bytes()]
    assert _close_on(JP, str(tmp_path / "jax_a"), envs, 1_800_000_000) == \
        _close_on(PP, str(tmp_path / "jax_b"), envs, 1_800_000_000)


def test_staged_closes_equal_with_equal_prewarm_stages(sequential,
                                                        tmp_path):
    """The node's staged apply in both packages, each with a verify
    service: equal closes (and equal to the sequential runs), and each
    stage's prewarm tuples the same multiset in both."""
    from stellar_core_tpu_torch.ops.backend_supervisor import \
        BackendSupervisor
    from stellar_core_tpu_torch.ops.verify_service import VerifyService
    seq_run = sequential[1]
    jsvc = RecordingService()
    oracle = OracleVerifier()
    psvc = RecordingService(VerifyService(BackendSupervisor(oracle),
                                          max_batch=8))
    j = cs.close_run(WL, str(tmp_path / "jax"), pkg=JP,
                     verify_service=jsvc)
    p = cs.close_run(WL, str(tmp_path / "port"), verify_service=psvc)
    assert_runs_equal(j, p)
    for ls, lp in zip(seq_run["ledgers"], p["ledgers"]):
        for key in ("header", "hash", "results", "meta", "buckets"):
            assert ls[key] == lp[key]
    assert jsvc.stages == psvc.stages
    # every measured close prewarms TXS tuples (one stage of them; the
    # conflict close two); the creation and control closes nothing
    widths = [led["widths"] for led in p["ledgers"]]
    assert widths[2 + CONFLICT_AT] == [TXS - 1, 1]
    assert all(w == [TXS] for i, w in enumerate(widths[2:2 + LEDGERS])
               if i != CONFLICT_AT)
    assert widths[-1] == [1] * TXS
    assert [len(s) for s in psvc.stages] == \
        [w[0] for w in widths[2:2 + LEDGERS]]
    # the service flushed every stage through the supervisor in batches
    # of at most 8 (its max_batch), in order
    assert sorted(t for c in oracle.calls for t in c) == \
        sorted(t for s in psvc.stages for t in s)
    assert max(len(c) for c in oracle.calls) == 8
    st = psvc.inner._verifier.status()
    assert not any(st["failures"].values()) and st["skips"] == 0
    # every prewarm verified, save the flipped signature
    from stellar_core_tpu_torch.crypto import ed25519_ref
    bad = [t for s in psvc.stages for t in s
           if not ed25519_ref.verify(*t)]
    assert len(bad) == 1


def test_phase13_workload_closes_equal(tmp_path):
    """chip_smoke.py phase 13's workload at 40 accounts and 2 closes of
    20 transactions, built by the port, through the JAX package's node
    and the port's, staged: equal closes; stages and the cache counts
    the phase expects (close_expected); results by kind."""
    wl = cs.close_workload(accounts=40, txs=20, ledgers=2)
    assert [c["tag"] for c in wl["closes"]] == \
        ["upgrade", "create", "measured", "measured", "control"]
    j = cs.close_run(wl, str(tmp_path / "jax"), pkg=JP)
    clear_caches()
    p = cs.close_run(wl, str(tmp_path / "port"))
    assert_runs_equal(j, p)
    codes = results_by_code(p)
    for c, led, code in zip(wl["closes"], p["ledgers"], codes):
        if c["tag"] == "measured":
            assert c["kinds"].count("conflict") == 1
            assert c["kinds"].count("flipped") == 1
            assert led["widths"] == [19, 1]
            assert code == {"txSUCCESS": 19, "txBAD_AUTH": 1}
        if c["tag"] == "control":
            assert led["widths"] == [1] * 20
        # no verify service: every transaction's first check misses
        assert led["cache"][1] == len(c["envelopes"])


def test_close_expected_counts():
    """The prediction rule of phase 13: stages of 980 and 20 at the
    node's max_batch 256 and device cutoff 16; 98 and 2 at 100 per
    close; width-1 stages only."""
    assert cs.close_expected([980, 20], 256, 16) == dict(
        tuples=1000, batch_full=3, demand=2, device=5, bypass=0,
        cache=(1000, 0))
    assert cs.close_expected([98, 2], 256, 16) == dict(
        tuples=100, batch_full=0, demand=2, device=1, bypass=1,
        cache=(100, 0))
    assert cs.close_expected([1] * 7, 256, 16) == dict(
        tuples=0, batch_full=0, demand=0, device=0, bypass=0,
        cache=(0, 7))
    assert cs.close_expected([512, 3, 1], 256, 16) == dict(
        tuples=515, batch_full=2, demand=1, device=2, bypass=1,
        cache=(515, 1))


def test_prewarm_through_the_plain_kernels(tmp_path):
    """One measured close of phase 13's workload (20 transactions, stages
    of 19 and 1) with the port's prewarm through
    VerifyService(BackendSupervisor(CudaBatchVerifier(device="cpu"))):
    one dispatch of the 19 tuples on the plain kernels, equal to the
    oracle, written through to the verify cache (19 hits more than the
    run without a service, 1 miss), and the closes equal the JAX
    package's."""
    from stellar_core_tpu_torch.crypto import ed25519_ref
    from stellar_core_tpu_torch.ops.backend_supervisor import (
        CLOSED, BackendSupervisor)
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    from stellar_core_tpu_torch.ops.verify_service import VerifyService
    wl = cs.close_workload(accounts=40, txs=20, ledgers=1)
    sup = BackendSupervisor(CudaBatchVerifier(device="cpu"))
    rec = cs.RecordingVerifier(sup)
    p = cs.close_run(wl, str(tmp_path / "port"),
                     verify_service=VerifyService(rec))
    clear_caches()
    j = cs.close_run(wl, str(tmp_path / "jax"), pkg=JP)
    assert_runs_equal(j, p)
    assert len(rec.calls) == 1
    items, got, _ = rec.calls[0]
    assert len(items) == 19
    assert got == [ed25519_ref.verify(*t) for t in items]
    assert got.count(False) == 1
    st = sup.status()
    assert st["state"] == CLOSED and not any(st["failures"].values())
    measured = [(lp, lj) for lp, lj in zip(p["ledgers"], j["ledgers"])
                if lp["tag"] == "measured"]
    for lp, lj in measured:
        assert lp["cache"] == (lj["cache"][0] + 19, 1)
