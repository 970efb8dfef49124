"""The canonical recorded scenario: a 4-node seeded chaos run with
every node's inputs captured for replay.

This is the tier-1 round-trip fixture AND the `bench.py --replay`
workload: record once live, replay each node twice, assert the header
chains and controller decision logs match the live run byte-for-byte
and the two replays' flight-recorder traces are zero-diff.

The chaos schedule is deliberately RESTRICTED to fault classes that
replay faithfully (docs/REPLAY.md, "what is not captured"):

- transport faults (the n1→n2 ``corrupt``) need no scripting — the
  mangled bytes were recorded verbatim at ``recv_bytes`` and the HMAC
  verdict rides a MACFAIL record;
- node-seam faults are limited to kinds the scripted replay engine can
  reproduce from (point, ordinal) alone: ``drop``/``reorder`` on
  ``overlay.message`` and the ``crash`` at a close-phase boundary.
  No ``io_error`` on the device seams (the scenario runs without the
  device stack) and no no-context seams (``history.get`` etc. fire
  without a ``node`` key, so neither side can attribute them).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..crypto.keys import SecretKey, clear_verify_cache
from ..herder.tx_queue import AddResult
from ..main.config import QuorumSetConfig
from ..simulation.chaos import _crank_with_crashes
from ..simulation.simulation import Simulation
from ..simulation.topologies import _seeds
from ..tx.frame import make_frame
from ..util import chaos
from ..util.chaos import ChaosEngine, FaultSpec
from ..util.logging import get_logger
from ..xdr.ledger_entries import Asset, AssetType, LedgerKey
from ..xdr.transaction import (DecoratedSignature, Memo, MemoType,
                               MuxedAccount, Operation, OperationType,
                               PaymentOp, Preconditions, PreconditionType,
                               Transaction, TransactionEnvelope,
                               TransactionV1Envelope, _OperationBody,
                               _TxExt)
from ..xdr.types import EnvelopeType
from . import log as rlog
from .replayer import normalize_trace

log = get_logger("Replay")

DEFAULT_TARGET = 8
FIRST_LOADED_LEDGER = 3      # ledger 2 closes clean before load starts


def restricted_schedule(node_ids: List[bytes]) -> List[FaultSpec]:
    n1, n2, n3 = (nid.hex() for nid in node_ids[1:4])
    return [
        FaultSpec("overlay.message", "drop", start=30, count=20,
                  match={"node": n1}),
        FaultSpec("overlay.message", "reorder", start=8, count=15,
                  match={"node": n2}),
        # transport corruption INTO node 2: recorded verbatim, the MAC
        # failure verdict rides a MACFAIL record
        FaultSpec("overlay.recv", "corrupt", start=30, count=2,
                  match={"node": n2, "peer": n1}),
        # crash node 3 mid-close: its log ends mid-stream (no END)
        FaultSpec("ledger.close.crash.applyTx", "crash", start=4,
                  count=1, match={"node": n3}),
    ]


class _RecordingRootPayer:
    """simulation/chaos.py's deterministic per-ledger root payment,
    with each node's submission recorded as an INJECT: one identical
    tx to every alive node, fresh frame per node."""

    def __init__(self, sim: Simulation, network_id: bytes):
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
            rec = getattr(app, "input_recorder", None)
            if rec is not None and rec.active:
                rec.record_inject([raw])
            frame = make_frame(TransactionEnvelope.from_bytes(raw),
                               self.network_id)
            res = app.herder.recv_transactions([frame])[0]
            if res not in (AddResult.ADD_STATUS_PENDING,
                           AddResult.ADD_STATUS_DUPLICATE):
                raise RuntimeError(f"replay scenario tx rejected: {res}")
        self.submitted += 1


class ScenarioResult:
    """The live run's ground truth plus every node's input log."""

    def __init__(self):
        self.node_ids: List[bytes] = []
        self.logs: Dict[str, rlog.InputLog] = {}       # node hex -> log
        self.chains: Dict[str, List[str]] = {}         # survivors only
        self.decisions: Dict[str, list] = {}
        self.traces: Dict[str, list] = {}              # normalized
        self.lcl: Dict[str, tuple] = {}                # (seq, hash hex)
        self.crashed: List[str] = []
        self.target = 0


def run_recorded_scenario(seed: int = 7,
                          target: int = DEFAULT_TARGET,
                          trace: bool = True) -> ScenarioResult:
    """Run the recorded chaos scenario live and return the logs plus
    everything replay must reproduce."""
    # cold process-wide verify cache, exactly like a chaos leg: a warm
    # cache changes which admissions enqueue verifies → chaos ordinals
    clear_verify_cache()

    def configure(cfg):
        cfg.ARTIFICIALLY_SET_CLOSE_TIME_FOR_TESTING = 1
        cfg.ARTIFICIALLY_PESSIMIZE_MERGES_FOR_TESTING = True

    # built by hand rather than topologies.core: recorders must attach
    # BEFORE connections wire, or the handshakes are off-log and every
    # conn is flagged unreplayable
    sim = Simulation()
    seeds = _seeds(4, b"core")
    ids = [s.public_key().raw for s in seeds]
    qset = QuorumSetConfig(threshold=3, validators=ids)
    for s in seeds:
        sim.add_node(s, qset, configure=configure)
    for app in sim.apps():
        # inline close completion: deterministic chaos hit ordinals
        app.ledger_manager.defer_completion = False
    sim.record_all(extras={"defer_completion": False})
    for i in range(4):
        for j in range(i + 1, 4):
            sim.add_pending_connection(ids[i], ids[j])

    res = ScenarioResult()
    res.node_ids = ids
    res.target = target
    engine = ChaosEngine(seed, restricted_schedule(ids))
    chaos.install(engine)
    try:
        sim.start_all_nodes()
        if trace:
            sim.start_tracing()
        crashed: List[bytes] = []
        crashed += _crank_with_crashes(
            sim, lambda: sim.have_alive_externalized(2), timeout=60.0)
        if not sim.have_alive_externalized(2):
            raise RuntimeError("network never closed ledger 2")
        payer = _RecordingRootPayer(sim, sim.apps()[0].config.network_id())
        for seq in range(FIRST_LOADED_LEDGER, target + 1):
            payer.submit_one()
            crashed += _crank_with_crashes(
                sim, lambda s=seq: sim.have_alive_externalized(s),
                timeout=120.0)
            if not sim.have_alive_externalized(seq):
                raise RuntimeError(
                    f"liveness lost: survivors stalled before {seq}")
        res.crashed = [nid.hex() for nid in crashed]
        # orderly END for survivors; the crashed node's recorder was
        # aborted mid-stream by crash_node — its log has no END marker
        sim.finish_recording()
        for nid, app in sim.nodes.items():
            hx = nid.hex()
            rec = app.input_recorder
            res.logs[hx] = rec.to_log()
            if nid in sim.crashed:
                continue
            lm = app.ledger_manager
            res.lcl[hx] = (lm.get_last_closed_ledger_num(),
                           lm.get_last_closed_ledger_hash().hex())
            chain = []
            for seq in range(2, res.lcl[hx][0] + 1):
                row = app.database.query_one(
                    "SELECT ledgerhash FROM ledgerheaders "
                    "WHERE ledgerseq=?", (seq,))
                chain.append(bytes(row[0]).hex() if row else "")
            res.chains[hx] = chain
            res.decisions[hx] = [dict(d) for d in app.controller.decisions]
            if trace:
                res.traces[hx] = normalize_trace(app.flight_recorder)
    finally:
        chaos.uninstall()
        try:
            sim.stop_all_nodes()
        except Exception:       # noqa: BLE001 — teardown best-effort
            log.exception("ignoring scenario teardown error")
    return res
