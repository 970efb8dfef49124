"""Seeded multinode chaos scenarios: topology + fault schedule in,
liveness/safety/reproducibility verdicts out.

The reference validates this class of behavior with simulation tests
(lost/restored nodes, stop-mid-catchup — src/simulation); here the
fault side is generalized through util/chaos.py and the verdicts are
made byte-exact:

- **liveness** — after the fault window clears, every SURVIVING node
  keeps externalizing ledgers up to the target;
- **safety** — surviving nodes' per-ledger header hashes are
  byte-identical to a fault-free run of the same scenario (close times
  are pinned via ARTIFICIALLY_SET_CLOSE_TIME_FOR_TESTING so header
  bytes cannot drift with consensus timing);
- **reproducibility** — running the same seeded schedule twice injects
  the same faults at the same points (ChaosEngine.log equality) and
  converges to the same final hashes.

Determinism prerequisites (see docs/CHAOS.md): nodes run single-threaded
— inline close completion, synchronous bucket merges — so chaos hit
ordinals are well-defined.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ..crypto.keys import SecretKey
from ..herder.tx_queue import AddResult
from ..tx.frame import make_frame
from ..util import chaos
from ..util.chaos import (ChaosEngine, FaultSpec, SimulatedChurn,
                          SimulatedCrash)
from ..util.logging import get_logger
from ..xdr.ledger_entries import Asset, AssetType, LedgerKey
from ..xdr.transaction import (DecoratedSignature, Memo, MemoType,
                               MuxedAccount, Operation, OperationType,
                               PaymentOp, Preconditions, PreconditionType,
                               Transaction, TransactionEnvelope,
                               TransactionV1Envelope, _OperationBody,
                               _TxExt)
from ..xdr.types import EnvelopeType
from . import topologies

log = get_logger("Chaos")

DEFAULT_TARGET = 12
FIRST_LOADED_LEDGER = 3      # ledger 2 closes clean before load starts


# device-outage window on node 0's supervised backend: long
# enough that consecutive dispatch failures trip the circuit breaker
# (threshold 3) AND the first HALF_OPEN canary probes still land inside
# the window — the probes consume the remaining fault hits, so the
# breaker must trip, back off, and re-close before the run ends
DEVICE_OUTAGE_FAULTS = 6


def default_schedule(node_ids: List[bytes]) -> List[FaultSpec]:
    """The canonical ≥5-class schedule over a 4-node core quorum:
    message drops (node 1's sends), reordering (node 2's sends), byte
    corruption on the n1→n2 link (lands as an HMAC failure → the
    standard peer-drop path), a SimulatedCrash at a close-phase
    boundary on node 3, a device-outage window on node 0's supervised
    backend (breaker trips OPEN, degraded native mode, canary probes,
    re-close), and a first-attempt archive fetch failure."""
    n0, n1, n2, n3 = (nid.hex() for nid in node_ids[:4])
    return [
        # message loss: a window of node 1's sends vanish (pre-MAC, so
        # the link survives the loss — SCP retransmission recovers)
        FaultSpec("overlay.message", "drop", start=30, count=20,
                  match={"node": n1}),
        # latency/reorder: node 2's messages get held one slot back
        FaultSpec("overlay.message", "reorder", start=8, count=15,
                  match={"node": n2}),
        # transport corruption INTO node 2 from node 1: MAC check fails,
        # the link dies through send_error_and_drop — the peer-drop class
        FaultSpec("overlay.recv", "corrupt", start=30, count=2,
                  match={"node": n2, "peer": n1}),
        # crash node 3 between applyTx and upgrades on its 5th close
        # (seq 6): the close transaction rolls back, the node is dead
        FaultSpec("ledger.close.crash.applyTx", "crash", start=4,
                  count=1, match={"node": n3}),
        # device outage on node 0: every supervised dispatch inside the
        # window fails. The breaker trips after the threshold (zero
        # device attempts while OPEN — pure native degraded mode), the
        # backoff probes burn the rest of the window, then a probe
        # succeeds and the breaker re-closes. Validation must stay
        # byte-identical throughout.
        FaultSpec("ops.backend.dispatch", "io_error", start=0,
                  count=DEVICE_OUTAGE_FAULTS, match={"node": n0}),
        # first archive fetch attempt fails; the work system retries
        FaultSpec("history.get", "fail", start=0, count=1),
    ]


class _RootPayer:
    """Deterministic per-ledger load: one root self-payment, submitted
    to EVERY alive node so any slot leader proposes the identical tx
    set regardless of which flood messages chaos ate."""

    def __init__(self, sim, network_id: bytes):
        self.sim = sim
        self.network_id = network_id
        self.key = SecretKey.from_seed(network_id)
        app = sim.apps()[0]
        from ..ledger.ledger_txn import LedgerTxn
        from ..xdr.types import PublicKey
        with LedgerTxn(app.ledger_manager.root) as ltx:
            le = ltx.load_without_record(LedgerKey.account(
                PublicKey.ed25519(self.key.public_key().raw)))
            self.seq = le.data.value.seqNum
        self.submitted = 0

    def submit_one(self) -> None:
        self.seq += 1
        muxed = MuxedAccount.from_ed25519(self.key.public_key().raw)
        tx = Transaction(
            sourceAccount=muxed, fee=100, seqNum=self.seq,
            cond=Preconditions(PreconditionType.PRECOND_NONE),
            memo=Memo(MemoType.MEMO_NONE),
            operations=[Operation(sourceAccount=None, body=_OperationBody(
                OperationType.PAYMENT, PaymentOp(
                    destination=muxed,
                    asset=Asset(AssetType.ASSET_TYPE_NATIVE),
                    amount=1)))],
            ext=_TxExt(0))
        env = TransactionEnvelope(
            EnvelopeType.ENVELOPE_TYPE_TX,
            TransactionV1Envelope(tx=tx, signatures=[]))
        probe = make_frame(env, self.network_id)
        sig = self.key.sign(probe.contents_hash())
        env.value.signatures = [DecoratedSignature(
            hint=self.key.public_key().hint(), signature=sig)]
        raw = env.to_bytes()
        for app in self.sim.alive_apps():
            # fresh frame per node: frames carry mutable per-node state
            frame = make_frame(TransactionEnvelope.from_bytes(raw),
                               self.network_id)
            # batched admission path: with a verify service installed
            # the envelope signature rides the supervised device
            # backend (admission load must survive a device
            # outage); without one it falls back to the sync path
            res = app.herder.recv_transactions([frame])[0]
            if res not in (AddResult.ADD_STATUS_PENDING,
                           AddResult.ADD_STATUS_DUPLICATE):
                raise RuntimeError(f"chaos load tx rejected: {res}")
        self.submitted += 1


def _build_sim(n_nodes: int = 4):
    def configure(cfg):
        # pinned close times → header bytes identical across runs
        cfg.ARTIFICIALLY_SET_CLOSE_TIME_FOR_TESTING = 1
        # single-threaded node: merge schedule on the calling thread
        cfg.ARTIFICIALLY_PESSIMIZE_MERGES_FOR_TESTING = True

    sim = topologies.core(n_nodes, configure=configure)
    for app in sim.apps():
        # inline completion: chaos hit ordinals stay deterministic
        app.ledger_manager.defer_completion = False
    return sim


def _crank_with_crashes(sim, pred, timeout: float,
                        churned: Optional[List[bytes]] = None
                        ) -> List[bytes]:
    """crank_until that treats SimulatedCrash as a node death: the
    crashed node is buried (links severed, timers silenced) and the
    rest of the network cranks on. A SimulatedChurn — a crash the
    caller will resurrect via Simulation.restart_node — is buried the
    same way but lands in `churned` (when given) instead of the
    returned permanent-death list. Shared with simulation/byzantine.py."""
    crashed: List[bytes] = []
    deadline = sim.clock.now() + timeout
    while not pred() and sim.clock.now() < deadline:
        try:
            if sim.clock.crank(False) == 0:
                sim.clock.crank(True)
        except SimulatedCrash as cr:
            node = bytes.fromhex(cr.ctx.get("node", ""))
            is_churn = isinstance(cr, SimulatedChurn)
            log.info("chaos: node %s %s at %s", node.hex()[:8],
                     "churned" if is_churn else "crashed", cr.point)
            sim.crash_node(node)
            if is_churn and churned is not None:
                churned.append(node)
            else:
                crashed.append(node)
    return crashed


def _collect_hashes(sim, upto: int) -> Dict[bytes, List[bytes]]:
    """node id -> [header hash for seq 2..upto] for surviving nodes."""
    out: Dict[bytes, List[bytes]] = {}
    for nid, app in sim.nodes.items():
        if nid in sim.crashed:
            continue
        hashes = []
        for seq in range(2, upto + 1):
            row = app.database.query_one(
                "SELECT ledgerhash FROM ledgerheaders WHERE ledgerseq=?",
                (seq,))
            hashes.append(bytes(row[0]) if row else b"")
        out[nid] = hashes
    return out


def _archive_fetch_leg(app, archive_dir: str) -> dict:
    """Exercise archive-get failure + retry through the real work
    machinery: seed a HAS into a tmpdir archive, fetch it via
    GetHistoryArchiveStateWork while the chaos schedule fails the first
    attempt."""
    from ..catchup.catchup_work import GetHistoryArchiveStateWork
    from ..history.archive import (HAS_PATH, HistoryArchiveState,
                                   make_tmpdir_archive)
    from ..work import run_work_to_completion
    from ..work.basic_work import State

    archive = make_tmpdir_archive("chaos", archive_dir)
    has_path = os.path.join(archive_dir, HAS_PATH)
    os.makedirs(os.path.dirname(has_path), exist_ok=True)
    if not os.path.exists(has_path):
        with open(has_path, "w") as f:
            f.write(HistoryArchiveState(
                current_ledger=1,
                network_passphrase=app.config.NETWORK_PASSPHRASE)
                .to_json())
    work = GetHistoryArchiveStateWork(app, archive)
    final = run_work_to_completion(app, work)
    return {"ok": final == State.WORK_SUCCESS and work.has is not None,
            "fetched_ledger": work.has.current_ledger
            if work.has is not None else None}


def _run_leg(seed: int, target: int, archive_dir: Optional[str],
             with_faults: bool) -> dict:
    """One full scenario leg. Returns hashes + chaos evidence."""
    # every leg starts with a COLD process-wide verify cache: the
    # coalescing verify service probes it on submit, so a cache warmed
    # by an earlier leg would change which verifies enqueue → which
    # flushes fire → which chaos hit ordinals match, breaking the
    # leg-to-leg reproducibility the verdict asserts
    from ..crypto.keys import clear_verify_cache
    clear_verify_cache()
    sim = _build_sim()
    node_ids = list(sim.nodes.keys())
    eng = None
    if with_faults:
        eng = ChaosEngine(seed, default_schedule(node_ids))
        chaos.install(eng)
    try:
        sim.start_all_nodes()
        # crash-aware from the first crank: a schedule may legally
        # crash a node before ledger 2
        crashed: List[bytes] = []
        crashed += _crank_with_crashes(
            sim, lambda: sim.have_alive_externalized(2), timeout=60.0)
        if not sim.have_alive_externalized(2):
            raise RuntimeError("network never closed ledger 2")
        payer = _RootPayer(sim, sim.apps()[0].config.network_id())
        if with_faults:
            # only the faulted legs carry the device stack — the FULL
            # stack on EVERY node: batch verifier behind
            # the backend supervisor, plus the coalescing verify
            # service, so SCP envelope and StellarValue verifies ride
            # micro-batches through the circuit breaker. Node 0's
            # outage window (DEVICE_OUTAGE_FAULTS dispatch failures)
            # trips its breaker OPEN — degraded native mode with ZERO
            # device attempts — then the seeded-backoff canary probes
            # burn the window and the breaker re-closes, all while
            # accept/reject stays identical (safety leg) and the
            # schedule reproduces (repro leg). device_min_batch=16 and
            # canary_batch=4 keep every dispatch on the host: the
            # scenario must not depend on kernel builds. Probe backoff
            # jitter is seeded by node id — deterministic per node,
            # decorrelated across nodes.
            from ..ops.backend_supervisor import BackendSupervisor
            from ..ops.verifier import CudaBatchVerifier
            from ..ops.verify_service import VerifyService
            for vapp in sim.alive_apps():
                inner = CudaBatchVerifier(perf=vapp.perf,
                                          device_min_batch=16)
                sup = BackendSupervisor(
                    inner, clock=sim.clock, metrics=vapp.metrics,
                    perf=vapp.perf, failure_threshold=3,
                    probe_base_ms=500.0, probe_max_ms=2000.0,
                    canary_batch=4,
                    jitter_seed=vapp.config.jitter_seed(),
                    chaos_label=vapp.config.node_id().hex())
                vapp.batch_verifier = sup
                vapp.herder.batch_verifier = sup
                vapp.verify_service = VerifyService(
                    sup, clock=sim.clock, metrics=vapp.metrics,
                    perf=vapp.perf)
                vapp.herder.verify_service = vapp.verify_service
        for seq in range(FIRST_LOADED_LEDGER, target + 1):
            payer.submit_one()
            if with_faults:
                # drive a candidate set with the fresh payment through
                # node 0's full validation path (its own proposals are
                # validity-cache-seeded, so a foreign-set validation is
                # modeled explicitly): the device-verifier fault fires
                # and the native fallback must still accept the set.
                # Cold verify cache first — the prevalidator only
                # dispatches cache misses, and admission warmed it
                # (deterministic: every faulted leg clears at the same
                # points)
                clear_verify_cache()
                from ..herder import make_tx_set_from_transactions
                app0 = sim.apps()[0]
                lcl = app0.ledger_manager.get_last_closed_ledger_header()
                frame, _, _ = make_tx_set_from_transactions(
                    app0.herder.tx_queue.get_transactions(), lcl,
                    app0.config.network_id())
                if not app0.herder._check_tx_set_valid(frame):
                    raise RuntimeError(
                        "native fallback rejected a valid tx set")
            crashed += _crank_with_crashes(
                sim, lambda s=seq: sim.have_alive_externalized(s),
                timeout=120.0)
            if not sim.have_alive_externalized(seq):
                raise RuntimeError(
                    f"liveness lost: survivors stalled before {seq}")
        breaker = None
        if with_faults:
            # let node 0's breaker settle: its outage window is sized
            # so the backoff probes exhaust it and re-close the breaker
            # — crank until that happens (probe timers keep the clock
            # moving even after the target ledger externalized)
            sup0 = sim.apps()[0].batch_verifier
            crashed += _crank_with_crashes(
                sim, lambda: sup0.state == "CLOSED", timeout=30.0)
            breaker = sup0.status()
        hashes = _collect_hashes(sim, target)
        # every surviving node must serve a valid clusterstatus
        # snapshot (mesh observatory): the structured health document
        # the multi-process harness (ROADMAP item 4) will collect over
        # HTTP instead of poking app objects
        import json as _json
        cluster: Dict[str, bool] = {}
        for nid, vapp in sim.nodes.items():
            if nid in sim.crashed:
                continue
            try:
                doc = vapp.command_handler.handle("clusterstatus")
                _json.dumps(doc)            # must be valid JSON
                cs = doc["clusterstatus"]
                cluster[nid.hex()[:8]] = bool(
                    cs["ledger"]["num"] >= target
                    and "close" in cs and "flood" in cs)
            except Exception:               # noqa: BLE001 — verdict data
                cluster[nid.hex()[:8]] = False
        archive_leg = None
        if archive_dir is not None:
            archive_leg = _archive_fetch_leg(sim.apps()[0], archive_dir)
        return {
            "hashes": hashes,
            "clusterstatus": cluster,
            "crashed": [n.hex() for n in crashed],
            "survivors": [n.hex() for n in sim.nodes
                          if n not in sim.crashed],
            "injected": dict(eng.injected) if eng else {},
            "log": list(eng.log) if eng else [],
            "virtual_end": sim.clock.now(),
            "archive": archive_leg,
            "breaker": breaker,
        }
    finally:
        if with_faults:
            chaos.uninstall()
        sim.stop_all_nodes()


def _breaker_verdict(status: Optional[dict]) -> dict:
    """Judge one node's breaker evidence (per
    device): some device must have tripped OPEN,
    probed via HALF_OPEN, re-closed (aggregate back to CLOSED), and
    made ZERO dispatch attempts while OPEN — per DEVICE: the device's
    own dispatch-counter snapshot at each of its OPEN→HALF_OPEN
    transitions equals the snapshot at its preceding →OPEN one.
    Sibling devices and probes of other chips may dispatch in between
    (that is the point of the mesh); the OPEN device itself must not."""
    if not status:
        return {"ok": False, "reason": "no breaker evidence"}
    trans = status["transitions"]
    tripped = any(t["to"] == "OPEN" for t in trans)
    probed = any(t["to"] == "HALF_OPEN" for t in trans)
    # re-close is judged PER DEVICE: the aggregate reads CLOSED the
    # moment any one chip serves, so it alone would certify a mesh
    # with a sibling stuck OPEN — every device that ever tripped must
    # have been readmitted by the end of the run
    tripped_devices = {t.get("device", 0) for t in trans
                       if t["to"] == "OPEN"}
    rows = {d["device"]: d["state"]
            for d in status.get("devices", [])}
    devices_reclosed = all(rows.get(d, "CLOSED") == "CLOSED"
                           for d in tripped_devices)
    reclosed = tripped and status["state"] == "CLOSED" \
        and devices_reclosed
    quiet = True
    last_open: Dict[int, int] = {}       # device -> snapshot at →OPEN
    for t in trans:
        dev = t.get("device", 0)
        snap = t.get("device_dispatches", t["dispatches"])
        if t["to"] == "OPEN":
            last_open[dev] = snap
        elif t["to"] == "HALF_OPEN" and dev in last_open:
            quiet = quiet and snap == last_open[dev]
    return {
        "ok": tripped and probed and reclosed and quiet,
        "tripped": tripped,
        "probed": probed,
        "reclosed": reclosed,
        "quiet_while_open": quiet,
        "transitions": trans,
        "skips": status["skips"],
        "dispatches": status["dispatches"],
        "failures": status["failures"],
    }


def run_scenario(seed: int = 6, target: int = DEFAULT_TARGET,
                 archive_dir: Optional[str] = None,
                 check_repro: bool = True) -> dict:
    """Run the canonical chaos scenario: a fault-free baseline, the
    seeded chaos leg, and (optionally) a second chaos leg to prove the
    schedule reproduces. Returns a verdict dict; every `*_ok` flag must
    be True for the scenario to count as converged."""
    # a baseline failure is a broken harness, not a chaos verdict —
    # let it raise
    baseline = _run_leg(seed, target, None, with_faults=False)
    try:
        chaos_a = _run_leg(seed, target, archive_dir, with_faults=True)
    except (RuntimeError, SimulatedCrash) as e:
        # survivors stalled / load rejected under faults — or a crash
        # fired outside the crash-aware crank (e.g. inside submission):
        # liveness lost, recorded as a verdict rather than an abort
        log.error("chaos leg failed: %r", e)
        return {"seed": seed, "target": target, "liveness_ok": False,
                "safety_ok": False, "repro_ok": False,
                "archive_ok": False, "breaker_ok": False,
                "clusterstatus_ok": False, "error": repr(e)}

    # safety: every surviving node's chain is byte-identical to the
    # fault-free run's (any baseline node is a reference — they agree)
    ref = next(iter(baseline["hashes"].values()))
    safety_ok = all(h == ref for h in chaos_a["hashes"].values()) and \
        all(h != b"" for h in ref)
    # the chaos leg reached `target` without raising; liveness still
    # requires somebody to have survived to do it
    liveness_ok = bool(chaos_a["survivors"])

    repro_ok = True
    if check_repro:
        try:
            chaos_b = _run_leg(seed, target, archive_dir,
                               with_faults=True)
        except (RuntimeError, SimulatedCrash) as e:
            # same schedule, different outcome: not reproducible
            log.error("repro leg failed: %r", e)
            chaos_b = None
        repro_ok = (chaos_b is not None and
                    chaos_b["log"] == chaos_a["log"] and
                    chaos_b["hashes"] == chaos_a["hashes"] and
                    chaos_b["injected"] == chaos_a["injected"])

    classes = sorted(k.split(".")[-1] for k in chaos_a["injected"])
    # the archive leg is part of the verdict (see below for the
    # single-node device-outage leg, run_device_outage): a fetch that
    # never recovers from the injected failure is a failed fault class
    archive_ok = chaos_a["archive"] is None or \
        bool(chaos_a["archive"]["ok"])
    # node 0's circuit breaker must have tripped on the outage window,
    # probed on the backoff schedule and re-closed — with zero device
    # dispatch attempts while OPEN
    breaker = _breaker_verdict(chaos_a.get("breaker"))
    return {
        "seed": seed,
        "target": target,
        "liveness_ok": liveness_ok,
        "safety_ok": safety_ok,
        "repro_ok": repro_ok,
        "archive_ok": archive_ok,
        "breaker_ok": breaker["ok"],
        "breaker": breaker,
        # every survivor served a valid clusterstatus document
        "clusterstatus_ok": bool(chaos_a["clusterstatus"]) and
        all(chaos_a["clusterstatus"].values()),
        "clusterstatus": chaos_a["clusterstatus"],
        "survivors": chaos_a["survivors"],
        "crashed": chaos_a["crashed"],
        "injected": chaos_a["injected"],
        "fault_classes": classes,
        "archive_retry": chaos_a["archive"],
        "virtual_seconds": chaos_a["virtual_end"],
        "baseline_virtual_seconds": baseline["virtual_end"],
    }


def run_device_outage(seed: int = 9, ledgers: int = 14,
                      outage_at: int = 4) -> dict:
    """Single-node device-outage leg for ``bench.py --chaos``:
    fail the supervised backend mid-run and measure the
    operational envelope the breaker buys — time-to-trip (how long the
    node pays failure latency), degraded-mode tps (ledgers closed while
    the breaker is OPEN and every verify is native), and
    time-to-recovery (outage end → breaker re-CLOSED via a canary
    probe).

    A MANUAL_CLOSE standalone node closes `ledgers` ledgers, each
    carrying one root self-payment admitted through
    ``herder.recv_transactions`` so the envelope signature rides the
    verify service into the supervised backend (one dispatch per
    ledger). From ledger `outage_at` a seeded chaos schedule fails
    ``DEVICE_OUTAGE_FAULTS`` consecutive dispatches; between ledgers
    the virtual clock advances one second so the breaker's backoff
    probes fire on schedule. Times are VIRTUAL seconds (deterministic);
    tps is wall-clock (the artifact's measurement)."""
    import time as _time

    from ..ledger.ledger_txn import LedgerTxn
    from ..main import Application, get_test_config
    from ..util.timer import ClockMode, VirtualClock
    from ..xdr.types import PublicKey

    from ..crypto.keys import clear_verify_cache
    clear_verify_cache()
    cfg = get_test_config()
    cfg.SIGNATURE_VERIFY_BACKEND = "tpu"
    # every dispatch stays on the host (no kernel builds in the bench
    # leg); the breaker semantics under test are identical either way
    cfg.VERIFY_DEVICE_MIN_BATCH = 1 << 20
    cfg.VERIFY_BREAKER_CANARY_BATCH = 4
    cfg.VERIFY_BREAKER_PROBE_BASE_MS = 500.0
    cfg.VERIFY_BREAKER_PROBE_MAX_MS = 2000.0
    clock = VirtualClock(ClockMode.VIRTUAL_TIME)
    app = Application.create(clock, cfg)
    app.start()
    sup = app.batch_verifier
    key = SecretKey.from_seed(cfg.network_id())
    with LedgerTxn(app.ledger_manager.root) as ltx:
        le = ltx.load_without_record(LedgerKey.account(
            PublicKey.ed25519(key.public_key().raw)))
        seq = le.data.value.seqNum
    phase_wall: Dict[str, List[float]] = {}
    outage_started_at = None
    try:
        for i in range(ledgers):
            if i == outage_at:
                chaos.install(ChaosEngine(seed, [FaultSpec(
                    "ops.backend.dispatch", "io_error", start=0,
                    count=DEVICE_OUTAGE_FAULTS,
                    match={"node": cfg.node_id().hex()})]))
                outage_started_at = clock.now()
            seq += 1
            muxed = MuxedAccount.from_ed25519(key.public_key().raw)
            tx = Transaction(
                sourceAccount=muxed, fee=100, seqNum=seq,
                cond=Preconditions(PreconditionType.PRECOND_NONE),
                memo=Memo(MemoType.MEMO_NONE),
                operations=[Operation(
                    sourceAccount=None,
                    body=_OperationBody(
                        OperationType.PAYMENT, PaymentOp(
                            destination=muxed,
                            asset=Asset(AssetType.ASSET_TYPE_NATIVE),
                            amount=1)))],
                ext=_TxExt(0))
            env = TransactionEnvelope(
                EnvelopeType.ENVELOPE_TYPE_TX,
                TransactionV1Envelope(tx=tx, signatures=[]))
            probe = make_frame(env, cfg.network_id())
            env.value.signatures = [DecoratedSignature(
                hint=key.public_key().hint(),
                signature=key.sign(probe.contents_hash()))]
            frame = make_frame(env, cfg.network_id())
            # classify by breaker state AT DISPATCH: the ledger whose
            # failing verify trips the breaker pays failure latency
            # with the breaker still CLOSED on entry — it belongs in
            # "failing", not in the degraded-tps "open" bucket
            state = sup.state
            tripped = any(t[2] == "OPEN" for t in sup.transitions)
            t0 = _time.perf_counter()
            res = app.herder.recv_transactions([frame])[0]
            if res != AddResult.ADD_STATUS_PENDING:
                raise RuntimeError(f"outage-leg tx rejected: {res}")
            app.manual_close()
            if outage_started_at is None:
                ph = "before"
            elif state != "CLOSED":
                ph = "open"                # degraded mode: native, no
                #                            device attempt
            elif tripped:
                ph = "after"               # breaker re-closed, healthy
            else:
                ph = "failing"             # outage active, not yet
                #                            tripped: the full failure
                #                            latency the breaker exists
                #                            to eliminate
            phase_wall.setdefault(ph, []).append(
                _time.perf_counter() - t0)
            # advance virtual time so backoff probe timers fire
            clock.crank_for(1.0)
        verdict = _breaker_verdict(sup.status())
        trans = {(t["from"], t["to"]): t["t"]
                 for t in reversed(verdict.get("transitions", []))}
        tripped_at = trans.get(("CLOSED", "OPEN"))
        reclosed_at = None
        for t in verdict.get("transitions", []):
            if t["to"] == "CLOSED":
                reclosed_at = t["t"]
        tps = {ph: round(len(v) / sum(v), 1)
               for ph, v in phase_wall.items() if v}
        return {
            "ok": bool(verdict["ok"]),
            "ledgers": ledgers,
            "outage_faults": DEVICE_OUTAGE_FAULTS,
            "time_to_trip_s": round(tripped_at - outage_started_at, 3)
            if tripped_at is not None and outage_started_at is not None
            else None,
            "time_to_recovery_s": round(reclosed_at - tripped_at, 3)
            if reclosed_at is not None and tripped_at is not None
            else None,
            "degraded_tps": tps.get("open"),
            "tps": tps,
            "breaker": verdict,
        }
    finally:
        chaos.uninstall()
        app.shutdown()


class _HostMeshVerifier:
    """N-device mesh stand-in with host-side verify (no kernels): the
    sick-device window's subject is the supervisor's breaker/mesh
    machinery, and the soak must not pay kernel compiles. Duck-types
    the ShardedBatchVerifier mesh surface the supervisor drives."""

    def __init__(self, ndev: int):
        self.ndev = ndev
        self._active = tuple(range(ndev))
        self.active_log: List[tuple] = []

    def set_active_devices(self, indices) -> None:
        self._active = tuple(sorted(int(i) for i in indices))
        self.active_log.append(self._active)

    def active_indices(self):
        return self._active

    def verify_tuples_async(self, items):
        from ..crypto.keys import verify_sig_uncached
        res = [verify_sig_uncached(p, s, m) for p, s, m in items]
        return lambda: res

    def verify_tuples_async_on(self, device_index, items):
        return self.verify_tuples_async(items)


def run_sick_device_window(seed: int = 11, ndev: int = 4, sick: int = 2,
                           flushes: int = 10) -> dict:
    """Sick-device chaos window (the chaos_soak leg): a
    device-index-matched ``io_error`` window on the per-device dispatch
    seam (``ops.backend.dispatch.device``, match={"device": sick})
    must trip exactly ONE chip of an N-device mesh — the mesh shrinks
    to the survivors, the open device sees ZERO further dispatches
    while its siblings keep serving and every result stays exact —
    and once the window is exhausted the canary probes must readmit
    it, regrowing the mesh to N/N. Deterministic: same seed → same
    injected faults → same transition log (the soak asserts repro by
    running it twice)."""
    from ..crypto.keys import SecretKey, verify_sig_uncached
    from ..ops.backend_supervisor import BackendSupervisor

    threshold = 2
    window = threshold + 1      # trip consumes 2 hits, first probe 1
    inner = _HostMeshVerifier(ndev)
    sup = BackendSupervisor(inner, clock=None,
                            failure_threshold=threshold,
                            probe_base_ms=100.0, probe_max_ms=400.0,
                            canary_batch=4, jitter_seed=seed,
                            chaos_label="sickdev")
    sk = SecretKey.pseudo_random_for_testing(seed)
    items = []
    for i in range(6):
        msg = (b"sick-%d" % i).ljust(32, b".")
        items.append((sk.public_key().raw, sk.sign(msg), msg))
    items[4] = (items[4][0], b"\x01" * 64, items[4][2])   # one invalid
    want = [verify_sig_uncached(p, s, m) for p, s, m in items]
    eng = ChaosEngine(seed, [FaultSpec(
        "ops.backend.dispatch.device", "io_error", start=0,
        count=window, match={"device": sick})])
    chaos.install(eng)
    exact = True
    agg_during_outage = []
    try:
        for _ in range(flushes):
            exact = exact and sup.verify_tuples(items) == want
            if sup.status()["devices"][sick]["state"] == "OPEN":
                agg_during_outage.append(sup.state)
        st = sup.status()
        survivors = [d for d in st["devices"] if d["device"] != sick]
        sick_row = st["devices"][sick]
        tripped = sick_row["state"] == "OPEN"
        siblings_closed = all(d["state"] == "CLOSED" for d in survivors)
        # zero dispatches to the open device: its counter froze at the
        # trip snapshot while the siblings kept dispatching
        trip_snap = next((t["device_dispatches"]
                          for t in reversed(st["transitions"])
                          if t["device"] == sick and t["to"] == "OPEN"),
                         None)
        quiet = trip_snap is not None and \
            sick_row["dispatches"] == trip_snap
        siblings_served = all(d["dispatches"] > trip_snap
                              for d in survivors) if tripped else False
        shrunk = inner.active_indices() == tuple(
            i for i in range(ndev) if i != sick)
        # first probe burns the window's last hit, the second readmits
        probe1 = sup.probe_now(device=sick)
        probe2 = sup.probe_now(device=sick)
        regrown = inner.active_indices() == tuple(range(ndev)) and \
            sup.status()["devices"][sick]["state"] == "CLOSED"
        return {
            "ok": bool(exact and tripped and siblings_closed and quiet
                       and siblings_served and shrunk
                       and not probe1 and probe2 and regrown
                       and all(s == "CLOSED"
                               for s in agg_during_outage)),
            "exact": bool(exact),
            "tripped": bool(tripped),
            "siblings_closed": bool(siblings_closed),
            "quiet_while_open": bool(quiet),
            "siblings_served": bool(siblings_served),
            "shrunk": bool(shrunk),
            "probe_in_window_failed": bool(not probe1),
            "regrown": bool(regrown),
            "aggregate_stayed_closed": bool(
                all(s == "CLOSED" for s in agg_during_outage)),
            "injected": dict(eng.injected),
            "log": list(eng.log),
            "transitions": sup.status()["transitions"],
        }
    finally:
        chaos.uninstall()
        sup.shutdown()
