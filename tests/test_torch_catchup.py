"""The port's catchup (process/, work/, history/manager.py, catchup/ and
ops/verifier.prevalidate_coalesce) against the JAX package's, on the CPU.

The JAX package's own publishing node (tests/test_history_catchup.py
make_publishing_app: 130 ledgers with scattered payments, checkpoints 63
and 127 published to a tmpdir archive through `cp`) is built once per
module. The port has no Application yet, so its side runs on
chip_smoke.CatchupApp, a stand-in holding what catchup reads from `app`
(the JAX package's config defaults, a virtual clock, a LedgerManager
over a sqlite file and a bucket directory in tmp_path, the history and
process managers, a work scheduler, the batch verifier). Held equal:
- prevalidate_coalesce on the reference's cases and on seeded count
  lists;
- the work and process scenarios of test_history_catchup.py:53-121
  (attempts, states, order, virtual time, exit codes);
- publish: the port's node re-closes the JAX node's ledgers from its
  txsethistory and each header's scpValue, and its archive equals the
  JAX node's path for path and byte for byte;
- catchup over the JAX archive, sequential (complete and to ledger 80),
  streaming and minimal (ApplyBucketsWork), against a fresh JAX node:
  ledgerheaders rows, LCL, state tables, bucket levels, PipelineStats
  items;
- the batch path at batch_grace 60 with one recording verifier answering
  with the native verifier: the tuples of each checkpoint in order, the
  hits and misses, every streaming batch as prevalidate_coalesce fused
  it;
- failures (a flipped byte in an archived ledger file, results that do
  not match the headers): both fail at the same LCL;
- CatchupManager over a stand-in herder: triggers, targets, archive
  rotation and the seeded suppression windows.
One port-only run goes through BackendSupervisor(CudaBatchVerifier(
device="cpu")), the plain kernels.
"""

import gzip
import importlib
import os
import shutil
import tempfile
import time
from types import SimpleNamespace

import pytest
from hypothesis import given, settings, strategies as st

import chip_smoke as cs
import test_history_catchup as hc

from stellar_core_tpu.main import Application, get_test_config

JAX, PORT = "stellar_core_tpu", "stellar_core_tpu_torch"
PP = cs.close_modules()
ENTRY_TABLES = ("accounts", "trustlines", "offers", "accountdata",
                "claimablebalance", "liquiditypool", "contractdata",
                "contractcode", "configsettings", "ttl", "txhistory",
                "txfeehistory", "txsethistory")


def mod(root, name):
    return importlib.import_module(f"{root}.{name}")


@pytest.fixture(autouse=True)
def _own_tmpdir(tmp_path, monkeypatch):
    """The catchup works' download directories (tempfile.mkdtemp, never
    removed by the sequential work) go under the test's tmp_path."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


# --------------------------------------------------------------- archive --

@pytest.fixture(scope="module")
def published(tmp_path_factory):
    """The JAX package's publishing node and its archive (checkpoints 63
    and 127), kept for the module."""
    app, archive, root = hc.make_publishing_app(
        tmp_path_factory.mktemp("jax-publisher"))
    try:
        assert app.history_manager.published_count == 2
        yield SimpleNamespace(app=app, root=root,
                              passphrase=app.config.NETWORK_PASSPHRASE)
    finally:
        app.shutdown()


def archive_copy(published, tmp_path):
    """A copy of the JAX archive that a test may damage."""
    root = str(tmp_path / "archive")
    shutil.copytree(published.root, root)
    return root


def tree(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def jax_node(published, start=True):
    """A fresh JAX node on the publisher's network
    (test_catchup_pipeline.py:43 `_fresh_node`), started (genesis)
    unless `start` is False (the node ApplyBucketsWork fills)."""
    cfg = get_test_config()
    cfg.NETWORK_PASSPHRASE = published.passphrase
    timer = mod(JAX, "util.timer")
    app = Application.create(
        timer.VirtualClock(timer.ClockMode.VIRTUAL_TIME), cfg)
    if start:
        app.start()
    return app


def node_state(app):
    """What catchup must leave alike: the LCL, the ledgerheaders rows,
    the entry and history tables and the bucket levels."""
    lm, db = app.ledger_manager, app.database
    return dict(
        lcl=(lm.get_last_closed_ledger_num(),
             lm.get_last_closed_ledger_hash()),
        headers=[(int(r[0]), bytes(r[1]), bytes(r[2])) for r in db.query_all(
            "SELECT ledgerseq, ledgerhash, data FROM ledgerheaders "
            "ORDER BY ledgerseq")],
        rows={t: sorted(tuple(bytes(v) if isinstance(v, memoryview) else v
                              for v in r)
                        for r in db.query_all(f"SELECT * FROM {t}"))
              for t in ENTRY_TABLES},
        buckets=[(bytes(lvl.curr.hash), bytes(lvl.snap.hash))
                 for lvl in app.bucket_manager.bucket_list.levels])


def port_node(published, directory, genesis=True, history=None):
    return cs.CatchupApp(str(directory), published.passphrase,
                         history=history, genesis=genesis)


def run_catchup(root, app, archive_root, mode, to_ledger=0, **work_kw):
    """Catchup of `app` in package `root` from the tmpdir archive: mode
    "sequential" (CatchupWork), "streaming" (StreamingCatchupWork) or
    "minimal" (the HAS, then ApplyBucketsWork). Returns (final state,
    the work)."""
    cu, wk = mod(root, "catchup"), mod(root, "work")
    archive = mod(root, "history").make_tmpdir_archive("test", archive_root)
    if mode == "minimal":
        has_work = cu.GetHistoryArchiveStateWork(app, archive)
        assert wk.run_work_to_completion(app, has_work) == \
            wk.State.WORK_SUCCESS
        work = cu.ApplyBucketsWork(app, archive, has_work.has,
                                   os.path.join(archive_root + "-dl"))
    else:
        cls = cu.StreamingCatchupWork if mode == "streaming" \
            else cu.CatchupWork
        work = cls(app, archive, cu.CatchupConfiguration(
            to_ledger=to_ledger), **work_kw)
    return wk.run_work_to_completion(app, work, timeout_virtual=3000), work


# ------------------------------------------------------------ coalescing --

@pytest.mark.parametrize("counts,window,k", [
    ([], 4, 0), ([300, 300], 4, 2), ([512, 10], 4, 1), ([300, 0, 300], 4, 3),
    ([0, 0, 5], 4, 3), ([5, 0, 0, 0, 0, 0], 3, 3)])
def test_prevalidate_coalesce_reference_cases(counts, window, k):
    """test_catchup_pipeline.py:62's cases, in both packages."""
    from stellar_core_tpu.ops.verifier import prevalidate_coalesce as jc
    from stellar_core_tpu_torch.ops.verifier import prevalidate_coalesce as pc
    assert jc(counts, window) == pc(counts, window) == k


@settings(max_examples=400, derandomize=True, deadline=None)
@given(st.lists(st.integers(0, 70_000), max_size=10), st.integers(1, 8))
def test_prevalidate_coalesce_agrees_on_seeded_counts(counts, window):
    from stellar_core_tpu.ops import verifier as jv
    from stellar_core_tpu_torch.ops import verifier as pv
    assert pv.prevalidate_coalesce(counts, window) == \
        jv.prevalidate_coalesce(counts, window)
    for n in counts:
        assert pv._bucket_size(n) == jv._bucket_size(n)
    assert pv.MIN_BUCKET == jv.MIN_BUCKET


def test_phase_14_checkpoints_fuse_when_both_pending():
    """Phase 14's two checkpoints fuse when both are pending at one
    dispatch: bucket(64,610) = 65,536 is no more than bucket(610) +
    bucket(64,000) = 1,024 + 65,536. Whether both are pending depends on
    when the verify worker hands over checkpoint 127's bundle."""
    from stellar_core_tpu_torch.ops.verifier import (_bucket_size,
                                                     prevalidate_coalesce)
    assert _bucket_size(64_610) == _bucket_size(64_000) == 65_536
    assert prevalidate_coalesce([610, 64_000], 4) == 2


# ------------------------------------------------------ work and process --

def work_scenario(root, name, tmp_path):
    """One of test_history_catchup.py:53-121's scenarios in package
    `root`, on a stand-in app holding only a virtual clock. Returns what
    it saw: final states, attempts, order, the virtual time at the end,
    exit codes."""
    timer, wk = mod(root, "util.timer"), mod(root, "work")
    app = SimpleNamespace(clock=timer.VirtualClock(
        timer.ClockMode.VIRTUAL_TIME))

    class Flaky(wk.BasicWork):
        def __init__(self, app, fail_times, max_retries=5):
            super().__init__(app, "flaky", max_retries)
            self.fail_times, self.attempts = fail_times, 0

        def on_run(self):
            self.attempts += 1
            return wk.State.WORK_FAILURE if self.attempts <= \
                self.fail_times else wk.State.WORK_SUCCESS

    if name in ("retries", "max_retries"):
        w = Flaky(app, 2) if name == "retries" else \
            Flaky(app, 10, max_retries=2)
        state = wk.run_work_to_completion(app, w)
        return dict(state=state.name, attempts=w.attempts,
                    now=app.clock.now(), status=w.get_status())
    if name == "sequence":
        order = []

        class W(wk.BasicWork):
            def __init__(self, app, tag):
                super().__init__(app, f"w{tag}", 0)
                self.tag = tag

            def on_run(self):
                order.append(self.tag)
                return wk.State.WORK_SUCCESS

        seq = wk.WorkSequence(app, "seq", [W(app, i) for i in range(4)])
        state = wk.run_work_to_completion(app, seq)
        return dict(state=state.name, order=order, now=app.clock.now())
    pm = mod(root, "process").ProcessManager(app)
    codes = []
    try:
        for cmd in (f"touch {tmp_path / root}", "false", "exit 3"):
            done = []
            ev = pm.run_process(cmd, done.append)
            deadline = time.monotonic() + 10
            while not done and time.monotonic() < deadline:
                app.clock.crank(False)
                time.sleep(0.005)      # subprocesses run in real time
            codes.append((done, ev.exit_code, ev.running))
        return dict(codes=codes, touched=(tmp_path / root).exists(),
                    running=pm.num_running(), pending=pm.num_pending())
    finally:
        pm.shutdown()


@pytest.mark.parametrize("name", ["retries", "max_retries", "sequence",
                                  "process"])
def test_work_and_process_scenarios_alike(name, tmp_path):
    j = work_scenario(JAX, name, tmp_path)
    p = work_scenario(PORT, name, tmp_path)
    assert j == p
    want = {"retries": dict(state="WORK_SUCCESS", attempts=3),
            "max_retries": dict(state="WORK_FAILURE", attempts=3),
            "sequence": dict(state="WORK_SUCCESS", order=[0, 1, 2, 3]),
            "process": dict(touched=True, running=0, pending=0)}[name]
    assert {k: p[k] for k in want} == want
    if name == "process":
        assert [c[:2] for c in p["codes"]] == [([0], 0), ([1], 1),
                                               ([3], 3)]


# --------------------------------------------------------------- publish --

def test_publish_writes_identical_archive(published, tmp_path):
    """The port's node closes the JAX node's ledgers 2..130 (each
    ledger's txsethistory set, prepared on the port's LCL, with the
    header's scpValue) and publishes with its HistoryManager: the same
    files, byte for byte, the HAS included. The standalone JAX node
    persists no SCP envelope, so both nodes' scp files are empty."""
    jdb = published.app.database
    assert not jdb.query_all("SELECT * FROM scphistory")
    nid = published.app.config.network_id()
    root = str(tmp_path / "archive")
    app = port_node(published, tmp_path / "node",
                    history=cs.archive_commands(root))
    lm, x = app.ledger_manager, PP.ledger
    try:
        for seq in range(2, 131):
            gen, blob = jdb.query_one(
                "SELECT isgeneralized, txset FROM txsethistory "
                "WHERE ledgerseq=?", (seq,))
            data = jdb.query_one(
                "SELECT data FROM ledgerheaders WHERE ledgerseq=?", (seq,))[0]
            header = x.LedgerHeader.from_bytes(bytes(data))
            xset = (x.GeneralizedTransactionSet if gen else
                    x.TransactionSet).from_bytes(bytes(blob))
            applicable = PP.tx_set.TxSetFrame(xset, nid).prepare_for_apply(
                lm.get_last_closed_ledger_header())
            lm.close_ledger(PP.ledger_manager.LedgerCloseData(
                seq, applicable, header.scpValue))
            lm.join_completion()
            assert lm.get_last_closed_ledger_hash() == bytes(jdb.query_one(
                "SELECT ledgerhash FROM ledgerheaders WHERE ledgerseq=?",
                (seq,))[0])
        assert app.history_manager.published_count == 2
        assert app.history_manager.publish_queue_length() == 0
    finally:
        app.shutdown()
    mine, theirs = tree(root), tree(published.root)
    assert sorted(mine) == sorted(theirs)
    assert [p for p in mine if mine[p] != theirs[p]] == []
    has = PP.history.HistoryArchiveState.from_json(
        mine[".well-known/stellar-history.json"].decode())
    assert has.current_ledger == 127


# --------------------------------------------------------------- catchup --

@pytest.mark.parametrize("mode,to_ledger,lcl", [
    ("sequential", 0, 127), ("sequential", 80, 80), ("streaming", 0, 127),
    ("minimal", 0, 127)])
def test_catchup_over_jax_archive_alike(published, tmp_path, mode,
                                        to_ledger, lcl):
    """A fresh node of each package catches up from the JAX archive in
    the same mode and lands on the same ledgerheaders rows, LCL, tables
    and bucket levels; the pipeline's stages saw the same items."""
    j = jax_node(published, start=mode != "minimal")
    p = port_node(published, tmp_path / "port", genesis=mode != "minimal")
    try:
        js, jw = run_catchup(JAX, j, published.root, mode, to_ledger)
        ps, pw = run_catchup(PORT, p, published.root, mode, to_ledger)
        assert js.name == ps.name == "WORK_SUCCESS"
        jst, pst = node_state(j), node_state(p)
        assert pst["lcl"] == jst["lcl"]
        assert pst["lcl"][0] == lcl
        assert pst["lcl"][1] == bytes(published.app.database.query_one(
            "SELECT ledgerhash FROM ledgerheaders WHERE ledgerseq=?",
            (lcl,))[0])
        for key in ("headers", "rows", "buckets"):
            assert pst[key] == jst[key], key
        assert len(pst["rows"]["accounts"]) == 6
        assert len(pst["headers"]) == (1 if mode == "minimal" else lcl)
        if mode == "streaming":
            jr, pr = jw.stats.report(), pw.stats.report()
            assert {s: v["items"] for s, v in pr["stages"].items()} == \
                {s: v["items"] for s, v in jr["stages"].items()} == \
                {"download": 2, "verify": 2, "prevalidate": 0,
                 "apply": 126}
            assert pr["queues"]["byte_budget"] == \
                jr["queues"]["byte_budget"] == 64 * 1024 * 1024
    finally:
        j.shutdown()
        p.shutdown()


def checkpoint_tuples(dispatches, batches, coalesce):
    """{checkpoint: its tuples in dispatch order}: a sequential batch is
    one checkpoint's; a streaming batch is split by the counts of the
    prevalidate_coalesce call that fused it."""
    calls = [c for c in coalesce or () if sum(c[0][:c[2]])]
    out = {}
    for i, (d, cps) in enumerate(zip(dispatches, batches)):
        counts = calls[i][0][:calls[i][2]] if coalesce is not None \
            else [len(d[0])]
        assert len(counts) == len(cps) and sum(counts) == len(d[0])
        at = 0
        for cp, n in zip(cps, counts):
            out[cp] = d[0][at:at + n]
            at += n
    return out


def batch_run(root, app, archive_root, mode):
    """`mode` catchup of `app` at batch_grace 60 with a RecordingVerifier
    over the native verifier as the batch verifier; prevalidate_coalesce
    and PrevalidatedVerifier recorded (chip_smoke.recorded_catchup)."""
    rec = cs.RecordingVerifier(cs.NativeBatchVerifier())
    coalesce, undo = cs.recorded_catchup(mod(root, "ops.verifier"),
                                         mod(root, "tx.signature_checker"))
    try:
        state, work = run_catchup(root, app, archive_root, mode,
                                  batch_verifier=rec, batch_grace=60.0)
    finally:
        undo()
    batches = cs.work_batches(work, mode == "streaming")
    assert all(b["landed"] and not b["failed"] for b in batches)
    return dict(state=state.name, dispatches=rec.calls,
                cps=[b["cps"] for b in batches],
                hits=sum(b["hits"] for b in batches),
                misses=sum(b["misses"] for b in batches),
                coalesce=coalesce if mode == "streaming" else None,
                lcl=app.ledger_manager.get_last_closed_ledger_num())


@pytest.mark.parametrize("mode", ["sequential", "streaming"])
def test_batch_path_alike(published, tmp_path, mode):
    """One recording verifier answering with the native verifier, given
    to both packages' works at batch_grace 60: each checkpoint's tuples
    equal byte for byte and in order, each checkpoint in exactly one
    batch, every streaming batch as prevalidate_coalesce fused it, the
    same hits and 0 misses."""
    j = jax_node(published)
    p = port_node(published, tmp_path / "port")
    try:
        jr = batch_run(JAX, j, published.root, mode)
        pr = batch_run(PORT, p, published.root, mode)
    finally:
        j.shutdown()
        p.shutdown()
    assert jr["state"] == pr["state"] == "WORK_SUCCESS"
    assert jr["lcl"] == pr["lcl"] == 127
    jt = checkpoint_tuples(jr["dispatches"], jr["cps"], jr["coalesce"])
    pt = checkpoint_tuples(pr["dispatches"], pr["cps"], pr["coalesce"])
    assert list(pt) == list(jt) == [63, 127]
    assert pt == jt
    assert sorted(cp for cps in pr["cps"] for cp in cps) == [63, 127]
    assert all(got == [True] * len(items)
               for items, got, _ in pr["dispatches"])
    assert pr["hits"] == jr["hits"] > sum(map(len, pt.values()))
    assert pr["misses"] == jr["misses"] == 0


# -------------------------------------------------------------- failures --

def flip_ledger_byte(root, checkpoint):
    """Flip a byte of the first archived header's previousLedgerHash in
    the checkpoint's ledger file (re-gzipped with mtime 0)."""
    path = os.path.join(root, mod(PORT, "history.archive").file_path(
        "ledger", checkpoint))
    with gzip.open(path, "rb") as f:
        data = bytearray(f.read())
    data[4 + 32 + 4 + 5] ^= 0x01     # record mark, hash, ledgerVersion
    mod(PORT, "history.archive").write_gz(path, bytes(data))


def diverge_results(root, checkpoint):
    """test_history_catchup.py:476's tamper: the first archived result's
    feeCharged + 1."""
    hc._rewrite_results_file(
        root, checkpoint,
        lambda entries: setattr(entries[0].txResultSet.results[0].result,
                                "feeCharged", entries[0].txResultSet
                                .results[0].result.feeCharged + 1))


@pytest.mark.parametrize("mode,damage,checkpoint,lcl", [
    ("sequential", flip_ledger_byte, 127, 1),
    ("sequential", diverge_results, 127, 63),
    ("streaming", flip_ledger_byte, 63, 1),
    ("streaming", diverge_results, 63, 1)])
def test_damaged_archive_fails_alike(published, tmp_path, caplog, mode,
                                     damage, checkpoint, lcl):
    """Both packages fail on the same damaged archive, at the same LCL
    (the checkpoint chosen so that the LCL does not depend on how far
    the streaming pipeline ran ahead), with the same reason logged."""
    root = archive_copy(published, tmp_path)
    damage(root, checkpoint)
    out = []
    for pkg_root in (JAX, PORT):
        app = jax_node(published) if pkg_root == JAX else \
            port_node(published, tmp_path / "port")
        caplog.clear()
        try:
            with caplog.at_level("ERROR"):
                state, _ = run_catchup(pkg_root, app, root, mode)
            out.append((state.name, app.ledger_manager
                        .get_last_closed_ledger_num(),
                        [r.getMessage() for r in caplog.records
                         if r.name.endswith("History")][:1]))
        finally:
            app.shutdown()
    assert out[0] == out[1]
    assert out[1][:2] == ("WORK_FAILURE", lcl)
    assert out[1][2], "no reason logged"


# ------------------------------------------------------- catchup manager --

class StandInHerder:
    """The herder fields CatchupManager reads: buffered externalized
    values by slot, the drain and the verify it hands catchup."""

    def __init__(self):
        self._buffered_values = {}
        self._verify = None
        self.drains = 0

    def _apply_buffered(self):
        self.drains += 1


class StandInClock:
    """now() under the test's control; the work scheduler's poller is
    never run, so no catchup the manager starts makes progress."""

    def __init__(self):
        self.t = 0.0

    def now(self):
        return self.t

    def add_io_poller(self, poll):
        pass

    def remove_io_poller(self, poll):
        pass


def manager_scenario(root, tmp_path):
    """CatchupManager of package `root` over a stand-in app (three
    archives, one of them put-only, an LCL and a clock the script sets):
    each step's trigger decision, the work it started (class, target,
    archive), the jittered suppression window and the drains."""
    hist, wk = mod(root, "history"), mod(root, "work")
    herder, clock, lcl = StandInHerder(), StandInClock(), [1]
    app = SimpleNamespace(
        config=cs.catchup_config("catchup manager", jitter_seed=0x5eed),
        herder=herder, clock=clock,
        history_manager=SimpleNamespace(archives=[
            hist.HistoryArchive("a", get_cmd="cp a/{0} {1}"),
            hist.HistoryArchive("put-only", put_cmd="cp {0} p/{1}"),
            hist.HistoryArchive("b", get_cmd="cp b/{0} {1}")]),
        ledger_manager=SimpleNamespace(
            get_last_closed_ledger_num=lambda: lcl[0]))
    app.work_scheduler = wk.WorkScheduler(app)
    mgr = mod(root, "catchup.manager").CatchupManager(app)
    seen, started = [], []

    def step(tag):
        ok = mgr.maybe_trigger_catchup()
        work = mgr._running._sequence[0] if ok else None
        if work is not None:
            started.append(mgr._running)
        seen.append((tag, ok, mgr.catchups_started,
                     type(work).__name__ if work else None,
                     work.catchup_config.to_ledger if work else None,
                     work.archive.name if work else None,
                     mgr._suppression_window, mgr.is_catchup_running()))

    try:
        step("nothing buffered")
        herder._buffered_values = {100: "v100", 101: "v101"}
        step("gap")
        step("while running")
        mgr._running.shutdown()                  # ended, not failed
        step("suppressed")
        clock.t += mgr._suppression_window + 1
        step("window passed")
        mgr._running._state = mod(root, "work.basic_work") \
            .InternalState.FAILURE
        step("after a failure")
        mgr._running._sequence[1]._cb()           # catchup done: drain
        lcl[0] = 99
        step("contiguous")
        lcl[0], herder._buffered_values = 120, {200: "v200"}
        app.config.CATCHUP_PIPELINE = False
        step("sequential work")
        mgr._running.shutdown()
        app.config.MODE_DOES_CATCHUP = False
        clock.t += 1000
        step("mode off")
        app.config.MODE_DOES_CATCHUP = True
        app.history_manager.archives = app.history_manager.archives[1:2]
        step("no readable archive")
        return seen, herder.drains
    finally:
        for s in started:
            s.shutdown()
        app.work_scheduler.shutdown()


def test_catchup_manager_alike(tmp_path):
    j, p = manager_scenario(JAX, tmp_path), manager_scenario(PORT, tmp_path)
    assert j == p
    steps = {s[0]: s for s in p[0]}
    assert [s[1] for s in p[0]] == [False, True, False, False, True, True,
                                    False, True, False, False]
    assert steps["gap"][3:6] == ("StreamingCatchupWork", 99, "a")
    assert steps["window passed"][5] == "b"
    assert steps["after a failure"][5] == "a"
    assert steps["sequential work"][3:6] == ("CatchupWork", 199, "b")
    windows = {s[6] for s in p[0] if s[1]}
    assert len(windows) == 4 and all(300 <= w < 375 for w in windows)
    assert p[1] == 1


# ------------------------------------------ the plain kernels, port only --

def test_streaming_over_plain_kernels(published, tmp_path, monkeypatch):
    """StreamingCatchupWork over BackendSupervisor(CudaBatchVerifier(
    device="cpu")): the plain versions verify every batch (one plain
    prep and one plain ladder per supervisor dispatch, no kernel
    launch), every signature check of the replay hits the batch, no
    miss, no fallback call, the breaker CLOSED."""
    from stellar_core_tpu_torch.ops import ed25519_kernel as EK
    from stellar_core_tpu_torch.ops import ladder as LD
    from stellar_core_tpu_torch.ops.backend_supervisor import (
        CLOSED, BackendSupervisor)
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    plain = {"prep": 0, "ladder": 0}
    for m, name, key in ((EK, "prep_plain", "prep"),
                         (LD, "ladder_plain", "ladder")):
        def counted(*a, _f=getattr(m, name), _k=key, **kw):
            plain[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(m, name, counted)
    sups = []

    def verifier(app):
        sups.append(BackendSupervisor(CudaBatchVerifier(device="cpu"),
                                      clock=app.clock))
        return sups[0]
    cs.zero_launches()
    run = cs.catchup_run(published.root, published.passphrase,
                         str(tmp_path / "port"), True, 0, verifier)
    st_ = sups[0].status()
    sups[0].shutdown()
    assert run["state"].name == "WORK_SUCCESS" and run["lcl"] == 127
    n = len(run["dispatches"])
    assert n in (1, 2) and sum(len(b["cps"]) for b in run["batches"]) == 2
    assert plain == {"prep": n, "ladder": n}
    assert cs.launch_counts() == {"msg32": 0, "k": 0, "ladder": 0}
    assert st_["dispatches"] == n and st_["state"] == CLOSED
    assert not any(st_["failures"].values()) and not st_["skips"]
    assert sum(b["hits"] for b in run["batches"]) > 0
    assert not any(b["misses"] or b["failed"] for b in run["batches"])
    assert run["fallbacks"] == 0
    assert all(got == [True] * len(items)
               for items, got, _ in run["dispatches"])
