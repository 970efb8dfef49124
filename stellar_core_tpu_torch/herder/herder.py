"""Herder — drives ledger close from transaction submission.

Reference: src/herder/HerderImpl.{h,cpp}. This class owns the
TransactionQueue and the Upgrades table and turns queue contents into tx
sets (`triggerNextLedger`, HerderImpl.cpp:1266) and externalized values
into `LedgerManager::closeLedger` calls (`valueExternalized` :380).

In RUN_STANDALONE/MANUAL_CLOSE mode (milestone M1, SURVEY.md §7 step 4)
there is no SCP: `trigger_next_ledger` externalizes its own proposal
immediately, exactly like the reference's standalone manual-close path
(Herder::setInSyncAndTriggerNextLedger via the `manualclose` command).
The SCP binding (HerderSCPDriver) layers on top without changing this
pipeline.
"""

from __future__ import annotations

import time
from enum import Enum
from typing import List, Optional

from ..ledger.ledger_manager import LedgerCloseData, LedgerManager
from ..util import chaos, tracing
from ..util.logging import get_logger
from ..xdr.ledger import StellarValue, StellarValueType, _StellarValueExt
from .tx_queue import AddResult, TransactionQueue
from .tx_set import make_tx_set_from_transactions, trim_invalid
from .upgrades import Upgrades

log = get_logger("Herder")

# reference: Herder.h MAX_SCP_TIMEOUT_SECONDS etc.
MAX_TIME_SLIP_SECONDS = 60
# reference: Herder.h LEDGER_VALIDITY_BRACKET — max slots ahead of LCL we
# accept envelopes for
LEDGER_VALIDITY_BRACKET = 100
# reference: Herder.h CONSENSUS_STUCK_TIMEOUT_SECONDS
CONSENSUS_STUCK_TIMEOUT_SECONDS = 35.0
# reference: out-of-sync recovery cadence (HerderImpl::outOfSyncRecovery)
OUT_OF_SYNC_RECOVERY_TIMER_SECONDS = 10.0

# slot phase timelines kept in memory (mesh observatory): enough for
# MAX_SLOTS_TO_REMEMBER-scale introspection, bounded regardless
SLOT_TIMELINE_MAX = 64


class HerderState(Enum):
    # reference: Herder.h State
    HERDER_BOOTING_STATE = 0
    HERDER_SYNCING_STATE = 1
    HERDER_TRACKING_NETWORK_STATE = 2


class Herder:
    SLOT_TIMELINE_MAX = SLOT_TIMELINE_MAX

    def __init__(self, config, ledger_manager: LedgerManager,
                 metrics=None, verify=None, batch_verifier=None,
                 verify_service=None):
        self.batch_verifier = batch_verifier
        # coalescing verify service (ops/verify_service.py): the live
        # per-signature paths — SCP envelopes, StellarValue signatures,
        # batched flood admission — route through it when present
        self.verify_service = verify_service
        self.config = config
        self.ledger_manager = ledger_manager
        self.network_id = config.network_id()
        self.upgrades = Upgrades(
            current_protocol_version=config.LEDGER_PROTOCOL_VERSION)
        self.tx_queue = TransactionQueue(
            pending_depth=config.TRANSACTION_QUEUE_PENDING_DEPTH,
            ban_depth=config.TRANSACTION_QUEUE_BAN_DEPTH,
            pool_ledger_multiplier=config.TRANSACTION_QUEUE_SIZE_MULTIPLIER,
            metrics=metrics,
            limit_source_account=config.LIMIT_TX_QUEUE_SOURCE_ACCOUNT)
        self.state = HerderState.HERDER_BOOTING_STATE
        self._verify = verify
        self._metrics = metrics
        self._clock = None  # set by Application
        # budgeted flood lanes (reference: FLOOD_TX_PERIOD_MS et al.);
        # bounded deques — overload drops the OLDEST adverts, which are
        # the ones peers least need (their txs age out of the queue)
        from collections import deque
        self._flood_classic = deque(maxlen=50_000)
        self._flood_soroban = deque(maxlen=50_000)
        self._flood_timer = None
        self._flood_last_drain: dict = {}
        if metrics is not None:
            self._tx_recv_meter = metrics.meter("herder", "tx", "received")
            self._tx_accept_meter = metrics.meter("herder", "tx", "accepted")
            # tx end-to-end latency: first-seen (submit/flood recv) →
            # externalized in a closed ledger, on THIS node's clock
            self.tx_e2e_timer = metrics.timer("ledger", "transaction",
                                              "e2e")
        else:
            self._tx_recv_meter = self._tx_accept_meter = None
            self.tx_e2e_timer = None
        # tx hash -> perf_counter at first acceptance; consumed by
        # _ledger_closed for the e2e timer + trace track, pruned so
        # never-externalized txs cannot grow it without bound
        self._tx_submit_times: dict = {}
        # hash-keyed propagation tracker (overlay/propagation.py), set
        # by Application; admission/externalize stamps land here so the
        # mesh observatory sees the full flood→admit→externalize path
        self.propagation = None
        # adaptive control plane (ops/controller.py), set by
        # Application: the tx-submit surge gate consults its shed
        # probability before any validation work is paid
        self.controller = None
        # per-slot consensus phase timeline (herder/scp_driver.py):
        # slot -> {phase: perf_counter, "_open": phase|None}, bounded
        self.slot_timelines: dict = {}

        # SCP binding (reference: HerderImpl owns SCP + PendingEnvelopes +
        # HerderSCPDriver); live whenever the node has an identity.
        from .pending_envelopes import PendingEnvelopes
        from .scp_driver import HerderSCPDriver
        self.pending_envelopes = PendingEnvelopes(self.network_id)
        self.scp = None
        self.scp_driver = None
        self.broadcast_cb = None      # set by overlay manager / simulation
        self.ledger_closed_cb = None  # set by overlay manager
        self.tx_advert_cb = None      # set by overlay manager
        self._tx_sets_for_slot = {}   # slot -> proposed TxSetFrame
        self._buffered_values = {}    # slot -> (StellarValue, tx_set)
        self._applicable_cache = {}   # txset hash -> (lcl seq, applicable)
        self._batch_pv_cache = {}     # txset hash -> (lcl seq, lazy pv)
        self._tx_set_valid_cache = {}  # (lcl hash, txset hash) -> bool
        self.trigger_timer = None
        self.catchup_manager = None   # set by Application
        self.out_of_sync_cb = None    # set by overlay manager
        from ..util.perf import default_registry
        self.perf = default_registry  # per-app registry set by Application
        self._tracking_timer = None
        if config.NODE_SEED is not None:
            from ..scp import SCP
            qset = config.QUORUM_SET.to_scp_quorum_set()
            from ..scp.quorum_set_utils import normalize_qset
            normalize_qset(qset)
            self.scp_driver = HerderSCPDriver(self)
            self.scp = SCP(self.scp_driver, config.node_id(),
                           config.NODE_IS_VALIDATOR, qset)
            self.pending_envelopes.put_local_qset(qset)
            from .quorum_tracker import QuorumTracker
            self.quorum_tracker = QuorumTracker(config.node_id(), qset)
        else:
            self.quorum_tracker = None

    # ------------------------------------------------------------ lifecycle --
    def start(self) -> None:
        """reference: Herder::start / bootstrap for FORCE_SCP."""
        self.state = HerderState.HERDER_TRACKING_NETWORK_STATE
        if self._tracks_network():
            self._arm_tracking_timer()

    def set_clock(self, clock) -> None:
        self._clock = clock

    def _now(self) -> int:
        if self._clock is not None:
            return int(self._clock.system_now())
        return int(time.time())

    def _next_close_time(self, lcl_header) -> int:
        """closeTime for the next proposed value. With
        ARTIFICIALLY_SET_CLOSE_TIME_FOR_TESTING (reference: Config.h)
        the clock drops out entirely — closeTime advances exactly one
        second per ledger from the configured base, so header bytes are
        reproducible run-to-run regardless of consensus timing
        (chaos-convergence scenarios diff header hashes across runs)."""
        fixed = self.config.ARTIFICIALLY_SET_CLOSE_TIME_FOR_TESTING
        if fixed:
            return max(int(fixed), lcl_header.scpValue.closeTime + 1)
        return max(self._now(), lcl_header.scpValue.closeTime + 1)

    # ----------------------------------------------------------- submission --
    def recv_transaction(self, tx, verify=None) -> AddResult:
        """Admit a tx to the pending queue (reference:
        Herder::recvTransaction :523). `verify` overrides the
        per-signature backend for this admission (the batched flood
        path passes a PrevalidatedVerifier seeded by one device
        batch)."""
        if verify is None and self.controller is not None and \
                self.controller.roll_tx_shed():
            # surge shedding (ops/controller.py): an overloaded node
            # turns direct submissions away BEFORE paying signature
            # verification or queue work — TRY_AGAIN_LATER is the
            # honest good-enough-answer-now (Tail at Scale). Only the
            # direct-submit path rolls here: flood admission sheds at
            # the overlay seam, upstream of the batched verify
            # dispatch, and arrives with a prevalidated `verify`.
            return AddResult.ADD_STATUS_TRY_AGAIN_LATER
        if self._tx_recv_meter is not None:
            self._tx_recv_meter.mark()
        max_ops = (self.config.TRANSACTION_QUEUE_SIZE_MULTIPLIER
                   * self._max_tx_set_ops())
        res = self.tx_queue.try_add(tx, self.ledger_manager.root, max_ops,
                                    verify=verify if verify is not None
                                    else self._verify)
        if res == AddResult.ADD_STATUS_PENDING:
            if self._tx_accept_meter is not None:
                self._tx_accept_meter.mark()
            h = tx.full_hash()
            if self.propagation is not None:
                # admission stamp on the propagation timeline (also
                # first-seen for a locally-submitted tx)
                self.propagation.on_admitted(h)
            if h not in self._tx_submit_times:
                self._tx_submit_times[h] = time.perf_counter()
                if tracing.ENABLED:
                    rec = self.perf.tracer
                    if rec is not None and rec.active:
                        # async track: begin here, end at externalize —
                        # possibly a different thread
                        rec.async_begin("tx.e2e", h.hex()[:16])
            # flood the acceptance (reference: recvTransaction →
            # OverlayManager broadcast, pull-mode advert) — rate-limited
            # per lane when FLOOD_*_PERIOD_MS is set
            if self.tx_advert_cb is not None:
                self._advert_or_queue(tx)
        return res

    def recv_transactions(self, frames,
                          bad_sig: Optional[List[bool]] = None
                          ) -> List[AddResult]:
        """Batched flood admission: the overlay collects the
        burst of TRANSACTION bodies received in one crank and admits
        them here as ONE prevalidated batch — every envelope signature
        of the burst goes through the coalescing verify service in a
        single device dispatch, and the per-tx try_add validation
        consumes the results via a PrevalidatedVerifier (misses fall
        back to the sync path, exact semantics). The service writes the
        results through the verify cache, so close-time re-verification
        of these txs is free.

        `bad_sig`, when given, receives one bool per frame: True iff
        the frame carried source-key envelope signatures and at least
        one verified False — the overlay's per-peer flooder accounting.
        Filled on the service path AND, since the
        multi-process harness runs native-backend nodes, on the
        serviceless path (per-signature verify, results prevalidated
        into try_add so nothing verifies twice)."""
        verify = self._verify
        svc = self.verify_service
        if frames and (svc is not None or bad_sig is not None):
            from ..tx.signature_checker import (PrevalidatedVerifier,
                                                collect_signature_tuples,
                                                default_verify)
            # envelope signatures only, like the txset prevalidator:
            # try_add's check_valid never verifies soroban auth
            # entries. On the serviceless path, skip frames try_add
            # will dedupe/ban anyway — with real-wire duplicate ratios
            # >1.5, most flood deliveries carry nothing to verify (a
            # duplicate with a bad signature is still not charged:
            # the FIRST delivery already was)
            if svc is None:
                per_frame = [
                    [] if self.tx_queue.is_pending(h := f.full_hash())
                    or self.tx_queue.is_banned(h)
                    else collect_signature_tuples([f]) for f in frames]
            else:
                per_frame = [collect_signature_tuples([f])
                             for f in frames]
            tuples = [t for ts in per_frame for t in ts]
            results: list = []
            if tuples:
                if svc is not None:
                    futures = svc.submit_many(tuples)
                    results = [f.result() for f in futures]
                else:
                    sync_verify = self._verify or default_verify
                    results = [sync_verify(p, s, m)
                               for p, s, m in tuples]
                pv = PrevalidatedVerifier(
                    fallback=self._verify or default_verify)
                pv.add_results(tuples, results)
                verify = pv
            if bad_sig is not None:
                # the contract is one bool per frame even when nothing
                # needed verifying (all duplicates / no signatures) —
                # the overlay's zip-based per-peer accounting must
                # never silently truncate
                it = iter(results)
                for ts in per_frame:
                    rs = [next(it) for _ in ts]
                    bad_sig.append(bool(ts) and not all(rs))
        return [self.recv_transaction(f, verify=verify) for f in frames]

    def _advert_or_queue(self, tx) -> None:
        """Advert now, or queue into the lane's budgeted flood drain
        (reference: TransactionQueue::broadcast — opsToFloodLedger =
        FLOOD_OP_RATE_PER_LEDGER * maxOps, drained every
        FLOOD_TX_PERIOD_MS; soroban rides its own lane)."""
        soroban = tx.is_soroban()
        period = (self.config.FLOOD_SOROBAN_TX_PERIOD_MS if soroban
                  else self.config.FLOOD_TX_PERIOD_MS)
        if period <= 0 or self._clock is None:
            self.tx_advert_cb(tx.full_hash())
            return
        lane = self._flood_soroban if soroban else self._flood_classic
        # a fresh lane's clock starts at first enqueue: the first drain
        # also waits the lane's full period
        self._flood_last_drain.setdefault(soroban, self._clock.now())
        lane.append((tx.full_hash(), max(1, tx.num_operations())))
        if self._flood_timer is None:
            self._arm_flood_timer()

    def _lane_due(self, soroban: bool, period_ms: float) -> bool:
        last = self._flood_last_drain.get(soroban)
        now = self._clock.now()
        if last is not None and (now - last) * 1000.0 < period_ms * 0.999:
            return False
        self._flood_last_drain[soroban] = now
        return True

    def _flood_budget(self, soroban: bool, period_ms: float) -> int:
        rate = (self.config.FLOOD_SOROBAN_RATE_PER_LEDGER if soroban
                else self.config.FLOOD_OP_RATE_PER_LEDGER)
        per_ledger = rate * self._max_tx_set_ops()
        ledger_s = max(0.001, self.config.EXPECTED_LEDGER_CLOSE_TIME)
        return max(1, int(per_ledger * (period_ms / 1000.0) / ledger_s))

    def _arm_flood_timer(self) -> None:
        from ..util.timer import VirtualTimer
        period = min(p for p in (self.config.FLOOD_TX_PERIOD_MS,
                                 self.config.FLOOD_SOROBAN_TX_PERIOD_MS)
                     if p > 0)
        t = VirtualTimer(self._clock)
        t.expires_from_now(period / 1000.0)
        t.async_wait(self._drain_floods)
        self._flood_timer = t

    def _drain_floods(self) -> None:
        self._flood_timer = None
        for soroban, lane, period in (
                (False, self._flood_classic,
                 self.config.FLOOD_TX_PERIOD_MS),
                (True, self._flood_soroban,
                 self.config.FLOOD_SOROBAN_TX_PERIOD_MS)):
            if not lane or period <= 0:
                continue
            # the shared timer fires at min(period); each lane drains
            # only when ITS OWN period has elapsed, else the slower
            # lane would flood at a multiple of its configured rate
            if not self._lane_due(soroban, period):
                continue
            budget = self._flood_budget(soroban, period)
            while lane and budget > 0:
                h, ops = lane.popleft()
                budget -= ops
                self.tx_advert_cb(h)
        if self._flood_classic or self._flood_soroban:
            self._arm_flood_timer()

    def _max_tx_set_ops(self) -> int:
        return self.ledger_manager.get_last_closed_ledger_header().maxTxSetSize

    # -------------------------------------------------------------- closing --
    def trigger_next_ledger(self) -> None:
        """Build a proposal from the queue (reference:
        Herder::triggerNextLedger :1266). Standalone mode externalizes it
        directly; under SCP this is where nomination starts."""
        lcl_header = self.ledger_manager.get_last_closed_ledger_header()
        next_seq = lcl_header.ledgerSeq + 1
        candidates, invalid = trim_invalid(
            self.tx_queue.get_transactions(), self.ledger_manager.root,
            verify=self._verify)
        if invalid:
            # reference: Herder::triggerNextLedger bans trimInvalid's
            # output so stale txs stop being re-validated every trigger
            self.tx_queue.ban(invalid)
        frame, applicable, excluded = make_tx_set_from_transactions(
            candidates, lcl_header, self.network_id)

        close_time = self._next_close_time(lcl_header)
        upgrade_steps = self._propose_upgrades(lcl_header, close_time)
        value = StellarValue(
            txSetHash=frame.get_contents_hash(),
            closeTime=close_time,
            upgrades=[u.to_bytes() for u in upgrade_steps],
            ext=_StellarValueExt(StellarValueType.STELLAR_VALUE_BASIC))
        self.externalize_value(next_seq, value, applicable)
        # manual/standalone close is a synchronous contract: the caller
        # (admin `manualclose`, tests) reads close artifacts the moment
        # this returns, so join the deferred completion tail. The
        # SCP-driven path keeps the pipeline — the next close's own
        # barrier gates it instead.
        self.ledger_manager.join_completion()

    def _propose_upgrades(self, lcl_header, close_time: int):
        """Vote upgrades against current ledger state (the Soroban
        config votes read CONFIG_SETTING entries)."""
        from ..ledger.ledger_txn import LedgerTxn
        with LedgerTxn(self.ledger_manager.root) as ltx_read:
            return self.upgrades.create_upgrades_for(
                lcl_header, close_time, ltx=ltx_read)

    def externalize_value(self, ledger_seq: int, value: StellarValue,
                          tx_set) -> None:
        """Apply an agreed value (reference: Herder::valueExternalized
        :380 → LedgerManager::valueExternalized)."""
        lcd = LedgerCloseData(ledger_seq, tx_set, value)
        kwargs = {}
        if self._verify is not None:
            kwargs["verify"] = self._verify
        self.ledger_manager.close_ledger(lcd, **kwargs)
        self._ledger_closed(tx_set)

    def _ledger_closed(self, tx_set) -> None:
        """Queue maintenance after close (reference:
        TransactionQueue::removeApplied + shift, called from
        HerderImpl::updateTransactionQueue)."""
        self._record_tx_e2e(tx_set)
        self.tx_queue.remove_applied(tx_set.txs)
        self.tx_queue.shift()
        if self.ledger_closed_cb is not None:
            self.ledger_closed_cb(
                self.ledger_manager.get_last_closed_ledger_num())

    # how long a first-seen stamp may outlive its tx before the prune
    # sweep drops it (banned / evicted txs never externalize)
    TX_E2E_STAMP_TTL_SECONDS = 300.0
    _TX_E2E_PRUNE_THRESHOLD = 10_000

    def _record_tx_e2e(self, tx_set) -> None:
        """Close the submit→externalize latency loop for every tx in
        the just-applied set: one `ledger.transaction.e2e` timer sample
        plus (when tracing) the async-track end event."""
        now = time.perf_counter()
        if self.propagation is not None and len(self.propagation):
            # propagation stamps are independent of the e2e submit
            # times (clearmetrics may have dropped those mid-flood);
            # update-only, so nodes that never saw the flood (catchup
            # replay) record nothing
            for tx in tx_set.txs:
                self.propagation.on_externalized(tx.full_hash(), now)
        if not self._tx_submit_times:
            return
        seq = self.ledger_manager.get_last_closed_ledger_num()
        rec = None
        if tracing.ENABLED:
            rec = self.perf.tracer
            if rec is not None and not rec.active:
                rec = None
        for tx in tx_set.txs:
            t0 = self._tx_submit_times.pop(tx.full_hash(), None)
            if t0 is None:
                continue
            if self.tx_e2e_timer is not None:
                self.tx_e2e_timer.update(now - t0)
            if rec is not None:
                rec.async_end("tx.e2e", tx.full_hash().hex()[:16],
                              {"seq": seq})
        if len(self._tx_submit_times) > self._TX_E2E_PRUNE_THRESHOLD:
            cutoff = now - self.TX_E2E_STAMP_TTL_SECONDS
            for h in [h for h, t in self._tx_submit_times.items()
                      if t < cutoff]:
                del self._tx_submit_times[h]

    # ------------------------------------------------- SCP-driven consensus --
    # reference: HerderImpl binds SCP↔overlay↔ledger; the methods below are
    # that binding. The standalone manual-close path above bypasses them.

    def bootstrap(self) -> None:
        """FORCE_SCP startup: start proposing on the next slot
        (reference: HerderImpl::bootstrap :814-822)."""
        assert self.scp is not None
        self.state = HerderState.HERDER_TRACKING_NETWORK_STATE
        if self._tracks_network():
            self._arm_tracking_timer()
        self._arm_trigger_timer(0.0)

    def emit_envelope(self, envelope) -> None:
        if tracing.ENABLED:
            rec = self.perf.tracer
            if rec is not None and rec.active:
                rec.instant("scp.envelope.emit", {
                    "slot": envelope.statement.slotIndex,
                    "type": envelope.statement.pledges.disc.name})
        if chaos.ENABLED:
            # Byzantine equivocation seam: an `equivocate`
            # fault makes this node sign and flood TWO conflicting SCP
            # envelopes for the same slot — the original plus a twin
            # whose values differ (Mazières 2015: exactly the
            # ill-behaved node SCP's quorum intersection must survive).
            # The equivocator's OWN SCP state machine only ever saw the
            # original; honest peers receive both.
            out = chaos.point(
                "scp.emit", envelope,
                node=self.config.node_id().hex()
                if self.config.NODE_SEED is not None else "",
                slot=envelope.statement.slotIndex)
            if out is chaos.DROP:
                # silent validator: the statement was produced (local
                # SCP state advanced) but never leaves the node
                return
            if out is chaos.EQUIVOCATE and self.broadcast_cb is not None:
                twin = self._equivocate_envelope(envelope)
                if twin is not None:
                    self.broadcast_cb(envelope)
                    self.broadcast_cb(twin)
                    return
        if self.broadcast_cb is not None:
            self.broadcast_cb(envelope)

    def _equivocate_envelope(self, envelope):
        """Forge the conflicting twin of `envelope`: same node, same
        slot, same statement type, every carried consensus value warped
        (closeTime+1, nomination values re-signed with this node's own
        key so they pass proposer-signature validation) and the
        envelope re-signed. Returns None if the statement carries no
        warpable value."""
        from ..xdr.ledger import StellarValueType
        from ..xdr.scp import SCPEnvelope, SCPStatementType
        from ..xdr.types import PublicKey
        from .scp_driver import (scp_envelope_sign_bytes,
                                 stellar_value_sign_bytes)
        sk = self.config.NODE_SEED
        if sk is None:
            return None

        def warp(raw: bytes) -> bytes:
            sv = StellarValue.from_bytes(bytes(raw))
            sv.closeTime += 1
            if sv.ext.disc == StellarValueType.STELLAR_VALUE_SIGNED:
                # a nomination value must carry a valid proposer
                # signature — the equivocator signs its forged value
                # like any proposal of its own
                lcs = sv.ext.value
                lcs.nodeID = PublicKey.ed25519(self.config.node_id())
                lcs.signature = sk.sign(stellar_value_sign_bytes(
                    self.network_id, bytes(sv.txSetHash), sv.closeTime))
            return sv.to_bytes()

        env = SCPEnvelope.from_bytes(envelope.to_bytes())
        t = env.statement.pledges.disc
        p = env.statement.pledges.value
        try:
            if t == SCPStatementType.SCP_ST_NOMINATE:
                if not p.votes and not p.accepted:
                    return None
                p.votes = [warp(v) for v in p.votes]
                p.accepted = [warp(v) for v in p.accepted]
            elif t == SCPStatementType.SCP_ST_PREPARE:
                p.ballot.value = warp(p.ballot.value)
                if p.prepared is not None:
                    p.prepared.value = warp(p.prepared.value)
                if p.preparedPrime is not None:
                    p.preparedPrime.value = warp(p.preparedPrime.value)
            elif t == SCPStatementType.SCP_ST_CONFIRM:
                p.ballot.value = warp(p.ballot.value)
            elif t == SCPStatementType.SCP_ST_EXTERNALIZE:
                p.commit.value = warp(p.commit.value)
            else:
                return None
        except Exception:
            # a value that isn't a StellarValue (foreign test driver):
            # nothing meaningful to equivocate about
            return None
        env.signature = sk.sign(scp_envelope_sign_bytes(
            self.network_id, env.statement))
        return env

    def verify_envelope(self, envelope) -> bool:
        """reference: HerderImpl::verifyEnvelope :2272 — done here, not in
        SCP. With the coalescing verify service installed, the verify
        rides the shared micro-batch queue (cache probe + write-through
        keep semantics identical to verify_sig)."""
        from .scp_driver import scp_envelope_sign_bytes
        node_raw = bytes(envelope.statement.nodeID.value)
        sig = bytes(envelope.signature)
        msg = scp_envelope_sign_bytes(self.network_id, envelope.statement)
        if self.verify_service is not None:
            return self.verify_service.verify(node_raw, sig, msg)
        from ..crypto.keys import PubKeyUtils
        return PubKeyUtils.verify_sig(node_raw, sig, msg)

    def recv_scp_envelope(self, envelope):
        """Verify, classify, and (when ready) feed SCP (reference:
        HerderImpl::recvSCPEnvelope :690)."""
        targs = None
        if tracing.ENABLED:
            targs = {"slot": envelope.statement.slotIndex,
                     "type": envelope.statement.pledges.disc.name}
        with self.perf.zone("herder.recvSCPEnvelope", targs=targs):
            return self._recv_scp_envelope(envelope)

    def _recv_scp_envelope(self, envelope):
        from .pending_envelopes import RecvState
        node_id = getattr(envelope.statement, "nodeID", None)
        if node_id is not None and self.config.NODE_SEED is not None \
                and bytes(node_id.value) == self.config.node_id():
            # reference: ENVELOPE_STATUS_SKIPPED_SELF — our own
            # statements enter SCP on the emit path, never from the
            # network. Critical after a churn restart: peers echo the
            # node's PRE-CRASH statements back, and ingesting them
            # would outrank the fresh ballot protocol's own state
            # ("moved to a bad state" on the next self-emit).
            return RecvState.ENVELOPE_STATUS_DISCARDED
        if not self.verify_envelope(envelope):
            return RecvState.ENVELOPE_STATUS_DISCARDED
        slot = envelope.statement.slotIndex
        lcl_seq = self.ledger_manager.get_last_closed_ledger_num()
        # reference: accept only slots within the validity window
        if slot <= max(0, lcl_seq -
                       self.config.MAX_SLOTS_TO_REMEMBER) or \
                slot > lcl_seq + LEDGER_VALIDITY_BRACKET:
            return RecvState.ENVELOPE_STATUS_DISCARDED
        status = self.pending_envelopes.recv_scp_envelope(envelope)
        if status == RecvState.ENVELOPE_STATUS_READY:
            self.process_scp_queue()
        return status

    def process_scp_queue(self) -> None:
        for slot in self.pending_envelopes.ready_slots():
            for env in self.pending_envelopes.pop_ready(slot):
                self.scp.receive_envelope(env)
                # after receive: a rebuild's qset lookup then sees this
                # envelope as the node's latest message
                self._update_quorum_tracker(env)

    def _update_quorum_tracker(self, env) -> None:
        """Track the transitive quorum from processed envelopes (reference:
        HerderImpl::updateTransitiveQuorum via QuorumTracker::expand, with
        full rebuild on inconsistency)."""
        if self.quorum_tracker is None:
            return
        from .pending_envelopes import _statement_qset_hash
        qh = _statement_qset_hash(env.statement)
        if qh is None:
            return
        qset = self.pending_envelopes.get_qset(qh)
        if qset is None:
            return
        node = bytes(env.statement.nodeID.value)
        if not self.quorum_tracker.expand(node, qset):
            self.quorum_tracker.rebuild(self._lookup_node_qset)

    def _lookup_node_qset(self, node_id: bytes):
        """Best-known quorum set of a node, from its latest SCP statement."""
        if self.scp is None:
            return None
        env = self.scp.get_latest_message(node_id)
        if env is None:
            return None
        from .pending_envelopes import _statement_qset_hash
        qh = _statement_qset_hash(env.statement)
        return self.pending_envelopes.get_qset(qh) if qh else None

    def recv_tx_set(self, tx_set_hash: bytes, tx_set) -> None:
        self.pending_envelopes.add_tx_set(tx_set_hash, tx_set)
        self.process_scp_queue()

    def recv_scp_quorum_set(self, qset_hash: bytes, qset) -> None:
        self.pending_envelopes.add_scp_quorum_set(qset_hash, qset)
        self.process_scp_queue()

    # ------------------------------------------------------ value plumbing --
    def make_stellar_value(self, tx_set_hash: bytes, close_time: int,
                           upgrade_steps) -> StellarValue:
        """Signed StellarValue (reference: HerderImpl::makeStellarValue)."""
        from ..xdr.ledger import LedgerCloseValueSignature
        from ..xdr.types import PublicKey
        from .scp_driver import stellar_value_sign_bytes
        sk = self.config.NODE_SEED
        sig = sk.sign(stellar_value_sign_bytes(
            self.network_id, tx_set_hash, close_time))
        return StellarValue(
            txSetHash=tx_set_hash, closeTime=close_time,
            upgrades=[u.to_bytes() for u in upgrade_steps],
            ext=_StellarValueExt(
                StellarValueType.STELLAR_VALUE_SIGNED,
                LedgerCloseValueSignature(
                    nodeID=PublicKey.ed25519(self.config.node_id()),
                    signature=sig)))

    def verify_stellar_value_signature(self, sv: StellarValue) -> bool:
        from .scp_driver import stellar_value_sign_bytes
        lcs = sv.ext.value
        pub = bytes(lcs.nodeID.value)
        sig = bytes(lcs.signature)
        msg = stellar_value_sign_bytes(self.network_id,
                                       bytes(sv.txSetHash), sv.closeTime)
        if self.verify_service is not None:
            return self.verify_service.verify(pub, sig, msg)
        from ..crypto.keys import PubKeyUtils
        return PubKeyUtils.verify_sig(pub, sig, msg)

    def applicable_for(self, tx_set_frame):
        """Prepared ApplicableTxSet for a wire frame against the LCL,
        memoized by contents hash."""
        h = tx_set_frame.get_contents_hash()
        cached = self._applicable_cache.get(h)
        lcl = self.ledger_manager.get_last_closed_ledger_header()
        if cached is not None and cached[0] == lcl.ledgerSeq:
            return cached[1]
        applicable = tx_set_frame.prepare_for_apply(lcl)
        # drop stale entries so the cache tracks only the live ledger
        for k in [k for k, (seq, _) in self._applicable_cache.items()
                  if seq < lcl.ledgerSeq]:
            del self._applicable_cache[k]
        self._applicable_cache[h] = (lcl.ledgerSeq, applicable)
        return applicable

    def is_tx_set_valid(self, tx_set_frame) -> bool:
        """Validity of a proposed txset against the LCL, memoized by
        (LCL hash, txset hash) like the reference's TxSetValidityKey
        cache (herder/HerderSCPDriver.cpp checkAndCacheTxSetValid):
        a quorum's worth of SCP envelopes all naming the same set must
        validate it once, not once per envelope."""
        h = tx_set_frame.get_contents_hash()
        lcl_hash = self.ledger_manager.get_last_closed_ledger_hash()
        key = (lcl_hash, h)
        cached = self._tx_set_valid_cache.get(key)
        if cached is not None:
            return cached
        valid = self._check_tx_set_valid(tx_set_frame)
        if len(self._tx_set_valid_cache) >= 1000:
            self._tx_set_valid_cache.clear()
        self._tx_set_valid_cache[key] = valid
        return valid

    def _check_tx_set_valid(self, tx_set_frame) -> bool:
        applicable = self.applicable_for(tx_set_frame)
        if applicable is None:
            return False
        verify = self._verify
        if self.batch_verifier is not None:
            # one device batch for the whole proposed set; per-signature
            # results seed the lookup the per-tx checkValid consumes
            # (reference collection point: txset validation,
            # herder/TxSetUtils.cpp:200 — SURVEY.md §3.2). Lazy: the
            # batch dispatches only when check_valid reaches its first
            # signature (structurally invalid sets never pay for crypto)
            # and is memoized per (txset hash, lcl) so a quorum's worth
            # of envelopes re-validating the same set verify once.
            h = tx_set_frame.get_contents_hash()
            lcl_seq = self.ledger_manager.get_last_closed_ledger_num()
            cached = self._batch_pv_cache.get(h)
            if cached is None or cached[0] != lcl_seq:
                lazy = _LazyBatchPrevalidator(self.batch_verifier,
                                              applicable, verify)
                for k in [k for k, (seq, _) in
                          self._batch_pv_cache.items() if seq < lcl_seq]:
                    del self._batch_pv_cache[k]
                cached = (lcl_seq, lazy)
                self._batch_pv_cache[h] = cached
            verify = cached[1]
        kwargs = {"verify": verify} if verify else {}
        return applicable.check_valid(self.ledger_manager.root, **kwargs)

    # ---------------------------------------------------------- triggering --
    def trigger_next_ledger_scp(self) -> None:
        """Propose the next slot's value through SCP (reference:
        HerderImpl::triggerNextLedger :1266)."""
        assert self.scp is not None
        lcl_header = self.ledger_manager.get_last_closed_ledger_header()
        slot = lcl_header.ledgerSeq + 1
        candidates, invalid = trim_invalid(
            self.tx_queue.get_transactions(), self.ledger_manager.root,
            verify=self._verify)
        if invalid:
            self.tx_queue.ban(invalid)
        frame, applicable, _ = make_tx_set_from_transactions(
            candidates, lcl_header, self.network_id)
        h = frame.get_contents_hash()
        self.pending_envelopes.add_tx_set(h, frame)
        self._tx_sets_for_slot[slot] = frame
        if tracing.ENABLED:
            rec = self.perf.tracer
            if rec is not None and rec.active:
                # the txset hop of the tx e2e pipeline: submit → queue
                # → TXSET → apply → externalize
                rec.instant("herder.txset.proposed",
                            {"slot": slot, "txs": applicable.size_tx()})
        # trim_invalid above IS a full per-tx validation pass against
        # this LCL, so seed the validity cache: our own proposal must
        # not be re-validated tx-by-tx when SCP hands it back
        # (reference: the trimmed makeFromTransactions output feeds the
        # same TxSetValidityKey cache its checkValid would)
        self._applicable_cache[h] = (lcl_header.ledgerSeq, applicable)
        self._tx_set_valid_cache[(
            self.ledger_manager.get_last_closed_ledger_hash(), h)] = True

        close_time = self._next_close_time(lcl_header)
        upgrade_steps = self._propose_upgrades(lcl_header, close_time)
        sv = self.make_stellar_value(frame.get_contents_hash(), close_time,
                                     upgrade_steps)
        prev_value = lcl_header.scpValue.to_bytes()
        self.scp.nominate(slot, sv.to_bytes(), prev_value)

    def _arm_trigger_timer(self, delay: float) -> None:
        if self._clock is None:
            return
        from ..util.timer import VirtualTimer
        if self.trigger_timer is not None:
            self.trigger_timer.cancel()
        self.trigger_timer = VirtualTimer(self._clock)
        self.trigger_timer.expires_from_now(delay)
        self.trigger_timer.async_wait(self.trigger_next_ledger_scp)

    # ------------------------------------------------------- externalizing --
    def value_externalized_from_scp(self, slot: int, value: bytes) -> None:
        """SCP agreed on `value` for `slot` (reference:
        HerderImpl::valueExternalized :380 → processExternalized)."""
        if tracing.ENABLED:
            rec = self.perf.tracer
            if rec is not None and rec.active:
                rec.instant("scp.externalize", {"slot": slot})
        sv = StellarValue.from_bytes(value)
        tx_set = self.pending_envelopes.get_tx_set(bytes(sv.txSetHash))
        if tx_set is None:
            log.error("externalized value with unknown txset for slot %d",
                      slot)
            return
        lcl_seq = self.ledger_manager.get_last_closed_ledger_num()
        if slot <= lcl_seq:
            return  # already closed (restart / catchup overlap)
        self._buffered_values[slot] = (sv, tx_set)
        self._apply_buffered()

    def _apply_buffered(self) -> None:
        self._drain_buffered()
        # a remaining gap means we can't follow the network; hand off to
        # the catchup manager (reference: CatchupManagerImpl)
        if self._buffered_values and self.catchup_manager is not None:
            lcl = self.ledger_manager.get_last_closed_ledger_num()
            if min(self._buffered_values) > lcl + 1:
                self.catchup_manager.maybe_trigger_catchup()

    def _drain_buffered(self) -> None:
        applied = 0
        while True:
            lcl = self.ledger_manager.get_last_closed_ledger_num()
            # drop stale entries (a node can land past buffered slots,
            # e.g. after a catchup clamped to the archive's tip)
            for slot in [s for s in self._buffered_values if s <= lcl]:
                del self._buffered_values[slot]
                self._tx_sets_for_slot.pop(slot, None)
            next_seq = lcl + 1
            buffered = self._buffered_values.pop(next_seq, None)
            if buffered is None:
                break
            sv, tx_set = buffered
            applicable = self.applicable_for(tx_set)
            self.externalize_value(next_seq, sv, applicable)
            applied += 1
            self._persist_scp_history(next_seq)
            self._tx_sets_for_slot.pop(next_seq, None)
            self.pending_envelopes.slot_closed(
                next_seq, self.config.MAX_SLOTS_TO_REMEMBER)
            if self.scp is not None:
                self.scp.purge_slots(
                    max(1, next_seq + 1 -
                        self.config.MAX_SLOTS_TO_REMEMBER))
                if self.config.NODE_IS_VALIDATOR and \
                        not self.config.MANUAL_CLOSE:
                    self._arm_trigger_timer(
                        self.config.EXPECTED_LEDGER_CLOSE_TIME)
        if applied:
            self.state = HerderState.HERDER_TRACKING_NETWORK_STATE
            if self._tracks_network():
                self._arm_tracking_timer()

    # --------------------------------------------------- sync state machine --
    def _tracks_network(self) -> bool:
        """Whether the consensus-stuck watchdog applies: only when
        following a live network, not standalone/manual-close."""
        return self.scp is not None and not self.config.MANUAL_CLOSE \
            and not self.config.RUN_STANDALONE
    def _arm_tracking_timer(self, delay: float =
                            CONSENSUS_STUCK_TIMEOUT_SECONDS) -> None:
        """Consensus-stuck watchdog (reference: herder/readme.md:23-40,
        trackingConsensusTimer): no externalize within the timeout drops
        us to SYNCING and starts periodic recovery."""
        if self._clock is None:
            return
        from ..util.timer import VirtualTimer
        if self._tracking_timer is not None:
            self._tracking_timer.cancel()
        self._tracking_timer = VirtualTimer(self._clock)
        self._tracking_timer.expires_from_now(delay)
        self._tracking_timer.async_wait(self._lost_sync)

    def _lost_sync(self) -> None:
        """reference: HerderImpl::lostSync :181 + outOfSyncRecovery
        :432 — ask peers for SCP state and keep retrying."""
        self.state = HerderState.HERDER_SYNCING_STATE
        log.warning("lost consensus sync; starting recovery")
        if self.out_of_sync_cb is not None:
            self.out_of_sync_cb()
        if self.catchup_manager is not None and self._buffered_values:
            self.catchup_manager.maybe_trigger_catchup()
        self._arm_tracking_timer(OUT_OF_SYNC_RECOVERY_TIMER_SECONDS)

    def _persist_scp_history(self, slot: int) -> None:
        """Store the slot's externalizing envelopes + quorum sets
        (reference: herder/HerderPersistence — scphistory/scpquorums
        tables, republished in checkpoint scp files)."""
        db = self.ledger_manager.db
        if db is None or self.scp is None:
            return
        from ..scp import local_node as ln
        for env in self.scp.get_externalizing_state(slot):
            db.execute(
                "INSERT INTO scphistory (nodeid, ledgerseq, envelope) "
                "VALUES (?,?,?)",
                (ln.node_key(env.statement.nodeID), slot, env.to_bytes()))
        qset = self.scp.local_node.qset
        db.execute(
            "INSERT OR REPLACE INTO scpquorums "
            "(qsethash, lastledgerseq, qset) VALUES (?,?,?)",
            (ln.qset_hash(qset), slot, qset.to_bytes()))

    def reset_observability(self) -> None:
        """`clearmetrics` hook: drop the hash-keyed stamp dicts (tx
        e2e submit times, slot timelines) so bench legs sharing one
        process measure each window from a clean slate. The herder
        owns this invariant — remote callers must not reach into the
        stamp bookkeeping directly."""
        self._tx_submit_times.clear()
        self.slot_timelines.clear()

    def shutdown(self) -> None:
        if self.trigger_timer is not None:
            self.trigger_timer.cancel()
            self.trigger_timer = None
        if self._tracking_timer is not None:
            self._tracking_timer.cancel()
            self._tracking_timer = None
        if self._flood_timer is not None:
            self._flood_timer.cancel()
            self._flood_timer = None
        if self.scp_driver is not None:
            # pending ballot timers must not fire into a dead app (the
            # chaos crash path shuts nodes down mid-consensus)
            self.scp_driver.cancel_all_timers()
        if self.verify_service is not None:
            # cancel the deadline timer and drop pending verifies: a
            # killed node loses in-flight work, and sync callers always
            # resolved their futures before returning
            self.verify_service.abandon()

    # ----------------------------------------------------------- inspection --
    def get_state(self) -> HerderState:
        return self.state

    def quorum_json(self, analyze: bool = False) -> dict:
        if self.scp is None:
            return {"node": "none", "qset": {}}
        from ..crypto.strkey import StrKey
        out = {
            "node": StrKey.encode_ed25519_public(self.config.node_id()),
            "qset": _qset_json(self.scp.local_node.qset),
        }
        if self.quorum_tracker is not None:
            out["transitive"] = self.quorum_tracker.transitive_json()
            if analyze and self.config.QUORUM_INTERSECTION_CHECKER:
                out["transitive"]["intersection"] = \
                    self.check_quorum_intersection()
        return out

    def check_quorum_intersection(self, max_calls: int = 200_000) -> dict:
        """Run the branch-and-bound intersection checker over the
        transitive quorum map (reference:
        HerderImpl::checkAndMaybeReanalyzeQuorumMap →
        QuorumIntersectionChecker::create/run).  The default call bound
        keeps the admin route's worst case to a few seconds — this runs
        on the request path, so an adversarially-shaped quorum map must
        hit the bound and report "interrupted" rather than stall the
        node (the reference offloads to a thread; here the org-collapse
        + orbit reductions do the heavy lifting and the bound is the
        backstop)."""
        from ..crypto.strkey import StrKey
        from .quorum_intersection import (QICInterrupted,
                                          QuorumIntersectionChecker)
        qmap = {nid: info.qset
                for nid, info in self.quorum_tracker.quorum_map.items()
                if info.qset is not None}
        # call bound AND wall-clock budget: the route must answer in
        # bounded time no matter how the map is shaped
        checker = QuorumIntersectionChecker(qmap, max_calls=max_calls,
                                            max_seconds=5.0)
        try:
            ok = checker.network_enjoys_quorum_intersection()
        except QICInterrupted:
            return {"intersection": None, "status": "interrupted",
                    "node_count": len(qmap), "calls": checker.calls}
        out = {"intersection": ok, "node_count": len(qmap),
               "calls": checker.calls,
               "last_check_ledger":
                   self.ledger_manager.get_last_closed_ledger_num()}
        if not ok and checker.potential_split is not None:
            a, b = checker.potential_split
            out["potential_split"] = [
                sorted(StrKey.encode_ed25519_public(n) for n in a),
                sorted(StrKey.encode_ed25519_public(n) for n in b)]
        return out


class _LazyBatchPrevalidator:
    """Per-txset lazy device batch: dispatches the batch verify the first
    time a signature is actually checked, then serves per-signature
    lookups; misses fall back to the sync path (exact semantics)."""

    def __init__(self, batch_verifier, applicable, fallback):
        from ..tx.signature_checker import default_verify
        self._batch_verifier = batch_verifier
        self._applicable = applicable
        self._fallback = fallback or default_verify
        self._pv = None

    def __call__(self, pub: bytes, sig: bytes, msg: bytes) -> bool:
        if self._pv is None:
            from ..crypto.keys import probe_verify_cache, seed_verify_cache
            from ..tx.signature_checker import (PrevalidatedVerifier,
                                                collect_signature_tuples)
            pv = PrevalidatedVerifier(fallback=self._fallback)
            # envelope signatures only: check_valid never verifies auth
            # entries (those are consumed by catchup's apply-time batch)
            tuples = collect_signature_tuples(self._applicable.txs)
            # the verify cache already holds every signature this node
            # admitted through the live path (flood admission / HTTP
            # submit write through it), so only the cache MISSES ride
            # the device batch — a fully-admitted txset dispatches
            # nothing
            cached, missing = [], []
            for t in tuples:
                hit = probe_verify_cache(*t)
                (missing if hit is None else cached).append(
                    (t, hit))
            if cached:
                pv.add_results([t for t, _ in cached],
                               [ok for _, ok in cached])
            if missing:
                miss_tuples = [t for t, _ in missing]
                try:
                    results = self._batch_verifier.verify_tuples(
                        miss_tuples)
                    pv.add_results(miss_tuples, results)
                    # write-through: apply-time re-verification of the
                    # externalized set hits the cache instead of
                    # re-verifying natively
                    for (p, s, m), ok in zip(miss_tuples, results):
                        seed_verify_cache(p, s, m, ok)
                except Exception:
                    # device verifier down: accept/reject semantics are
                    # identical on the native path, so validation
                    # continues per-signature through the fallback
                    log.warning("batch verifier failed; falling back to "
                                "native per-signature verify",
                                exc_info=True)
            self._pv = pv
            self._applicable = None   # drop the reference once consumed
        return self._pv(pub, sig, msg)


def _qset_json(qset) -> dict:
    from ..crypto.strkey import StrKey
    return {
        "t": qset.threshold,
        "v": [StrKey.encode_ed25519_public(bytes(v.value))
              for v in qset.validators],
        "i": [_qset_json(s) for s in qset.innerSets],
    }
