"""HerderSCPDriver — binds abstract SCP to the ledger application.

Reference: src/herder/HerderSCPDriver.{h,cpp}: value (de)serialization
and validation against the LCL, candidate combination, envelope
signing/emission, timer plumbing onto the VirtualClock, and the
valueExternalized handoff to ledger close.
"""

from __future__ import annotations

import struct
import time
from typing import Dict, Optional, Set

from ..crypto.sha import sha256
from ..scp import SCPDriver, ValidationLevel
from ..util import tracing
from ..util.logging import get_logger
from ..util.timer import VirtualTimer
from ..xdr.ledger import (LedgerUpgrade, LedgerUpgradeType, StellarValue,
                          StellarValueType)
from ..xdr.scp import SCPEnvelope
from ..xdr.types import EnvelopeType

log = get_logger("Herder")

# reference: Herder.h MAX_TIME_SLIP_SECONDS
MAX_TIME_SLIP_SECONDS = 60


def scp_envelope_sign_bytes(network_id: bytes, statement) -> bytes:
    """xdr_to_opaque(networkID, ENVELOPE_TYPE_SCP, statement)
    (reference: HerderImpl::signEnvelope :2291)."""
    return (network_id + struct.pack(">i", EnvelopeType.ENVELOPE_TYPE_SCP)
            + statement.to_bytes())


def stellar_value_sign_bytes(network_id: bytes, tx_set_hash: bytes,
                             close_time: int) -> bytes:
    """xdr_to_opaque(networkID, ENVELOPE_TYPE_SCPVALUE, txSetHash,
    closeTime) (reference: HerderImpl::verifyStellarValueSignature)."""
    return (network_id
            + struct.pack(">i", EnvelopeType.ENVELOPE_TYPE_SCPVALUE)
            + tx_set_hash + struct.pack(">Q", close_time))


class HerderSCPDriver(SCPDriver):
    def __init__(self, herder):
        self.herder = herder
        self._timers: Dict[tuple, VirtualTimer] = {}

    # ------------------------------------------------------------- wiring --
    @property
    def app_clock(self):
        return self.herder._clock

    def sign_envelope(self, envelope: SCPEnvelope) -> None:
        sk = self.herder.config.NODE_SEED
        envelope.signature = sk.sign(scp_envelope_sign_bytes(
            self.herder.network_id, envelope.statement))

    def emit_envelope(self, envelope: SCPEnvelope) -> None:
        self.herder.emit_envelope(envelope)

    def get_qset(self, qset_hash: bytes):
        return self.herder.pending_envelopes.get_qset(qset_hash)

    # --------------------------------------------------------- validation --
    def validate_value(self, slot_index: int, value: bytes,
                       nomination: bool) -> ValidationLevel:
        try:
            sv = StellarValue.from_bytes(value)
        except Exception:
            return ValidationLevel.kInvalidValue
        lcl = self.herder.ledger_manager.get_last_closed_ledger_header()
        lcl_seq = lcl.ledgerSeq

        # nomination values must be signed by their proposer (reference:
        # validateValueHelper, protocol 18+ behavior)
        if nomination:
            if sv.ext.disc != StellarValueType.STELLAR_VALUE_SIGNED:
                return ValidationLevel.kInvalidValue
            if not self.herder.verify_stellar_value_signature(sv):
                return ValidationLevel.kInvalidValue

        if slot_index != lcl_seq + 1:
            # old or far-future slot: can't fully validate against state
            return ValidationLevel.kMaybeValidValue

        if sv.closeTime <= lcl.scpValue.closeTime:
            return ValidationLevel.kInvalidValue
        now = self.herder._now()
        if sv.closeTime > now + MAX_TIME_SLIP_SECONDS:
            return ValidationLevel.kInvalidValue

        tx_set = self.herder.pending_envelopes.get_tx_set(
            bytes(sv.txSetHash))
        if tx_set is None:
            log.debug("validateValue: unknown txset %s",
                      bytes(sv.txSetHash).hex()[:16])
            return ValidationLevel.kInvalidValue
        if not self.herder.is_tx_set_valid(tx_set):
            return ValidationLevel.kInvalidValue
        if sv.upgrades:
            from ..ledger.ledger_txn import LedgerTxn
            with LedgerTxn(self.herder.ledger_manager.root) as ltx_read:
                for raw in sv.upgrades:
                    try:
                        up = LedgerUpgrade.from_bytes(bytes(raw))
                    except Exception:
                        return ValidationLevel.kInvalidValue
                    if not self.herder.upgrades.is_valid(
                            up, lcl, nomination, sv.closeTime,
                            ltx=ltx_read):
                        return ValidationLevel.kInvalidValue
        return ValidationLevel.kFullyValidatedValue

    def extract_valid_value(self, slot_index: int,
                            value: bytes) -> Optional[bytes]:
        """Strip invalid upgrades from an otherwise-valid value
        (reference: HerderSCPDriver::extractValidValue)."""
        try:
            sv = StellarValue.from_bytes(value)
        except Exception:
            return None
        lcl = self.herder.ledger_manager.get_last_closed_ledger_header()
        tx_set = self.herder.pending_envelopes.get_tx_set(
            bytes(sv.txSetHash))
        if tx_set is None or not self.herder.is_tx_set_valid(tx_set):
            return None
        kept = []
        if sv.upgrades:
            from ..ledger.ledger_txn import LedgerTxn
            with LedgerTxn(self.herder.ledger_manager.root) as ltx_read:
                for raw in sv.upgrades:
                    try:
                        up = LedgerUpgrade.from_bytes(bytes(raw))
                        if self.herder.upgrades.is_valid(
                                up, lcl, True, sv.closeTime, ltx=ltx_read):
                            kept.append(raw)
                    except Exception:
                        pass
        sv.upgrades = kept
        return sv.to_bytes()

    # -------------------------------------------------------- combination --
    def combine_candidates(self, slot_index: int,
                           candidates: Set[bytes]) -> Optional[bytes]:
        """Aggregate upgrades (max per type), pick the best tx set
        (reference: HerderSCPDriver::combineCandidates :615)."""
        lcl = self.herder.ledger_manager.get_last_closed_ledger_header()
        lcl_hash = self.herder.ledger_manager.get_last_closed_ledger_hash()
        upgrades: Dict[int, LedgerUpgrade] = {}
        candidates_hash = bytes(32)
        values = []
        for raw in sorted(candidates):
            sv = StellarValue.from_bytes(raw)
            values.append(sv)
            candidates_hash = bytes(
                a ^ b for a, b in zip(candidates_hash, sha256(raw)))
            for uraw in sv.upgrades:
                up = LedgerUpgrade.from_bytes(bytes(uraw))
                t = up.disc
                cur = upgrades.get(t)
                if cur is None or up.value > cur.value:
                    upgrades[t] = up

        best = None
        best_txset = None
        for sv in values:
            tx_set = self.herder.pending_envelopes.get_tx_set(
                bytes(sv.txSetHash))
            if tx_set is None:
                continue
            applicable = self.herder.applicable_for(tx_set)
            if applicable is None or \
                    tx_set.previous_ledger_hash() != lcl_hash:
                continue
            if best is None or self._tx_set_less(
                    best_txset, applicable, bytes(best.txSetHash),
                    bytes(sv.txSetHash), candidates_hash):
                best = sv
                best_txset = applicable
        if best is None:
            raise RuntimeError("no usable candidate transaction set")

        comp = StellarValue.from_bytes(best.to_bytes())
        comp.upgrades = [upgrades[t].to_bytes() for t in sorted(upgrades)]
        # the composite is STELLAR_VALUE_BASIC (reference:
        # combineCandidates strips the nomination signature): only
        # nomination values are signed, and the externalized header
        # must not depend on WHICH proposer's candidate won the slot —
        # chaos-convergence runs diff header bytes across runs
        from ..xdr.ledger import _StellarValueExt
        comp.ext = _StellarValueExt(StellarValueType.STELLAR_VALUE_BASIC)
        return comp.to_bytes()

    @staticmethod
    def _tx_set_less(l_app, r_app, lh: bytes, rh: bytes,
                     mix: bytes) -> bool:
        """compareTxSets: by op count, then total fees, then hash^mix."""
        if l_app is None:
            return r_app is not None
        if r_app is None:
            return False
        if l_app.size_op() != r_app.size_op():
            return l_app.size_op() < r_app.size_op()
        l_fees = sum(t.inclusion_fee() for t in l_app.txs)
        r_fees = sum(t.inclusion_fee() for t in r_app.txs)
        if l_fees != r_fees:
            return l_fees < r_fees
        lx = bytes(a ^ b for a, b in zip(lh, mix))
        rx = bytes(a ^ b for a, b in zip(rh, mix))
        return lx < rx

    # -------------------------------------------------------------- timers --
    def setup_timer(self, slot_index: int, timer_id: int,
                    timeout_seconds: float, cb) -> None:
        key = (slot_index, timer_id)
        old = self._timers.pop(key, None)
        if old is not None:
            old.cancel()
        if cb is None:
            return
        timer = VirtualTimer(self.app_clock)
        timer.expires_from_now(timeout_seconds)

        def fire():
            self._timers.pop(key, None)
            cb()

        timer.async_wait(fire)
        self._timers[key] = timer

    def cancel_timers_below(self, slot_index: int) -> None:
        for key in [k for k in self._timers if k[0] <= slot_index]:
            self._timers.pop(key).cancel()

    def cancel_all_timers(self) -> None:
        """Shutdown: a pending ballot/nomination timer must not fire
        into a dead app."""
        for timer in self._timers.values():
            timer.cancel()
        self._timers.clear()

    # ------------------------------------------------------- notifications --
    def value_externalized(self, slot_index: int, value: bytes) -> None:
        self._slot_phase(slot_index, "externalize")
        self.cancel_timers_below(slot_index)
        self.herder.value_externalized_from_scp(slot_index, value)

    def nominating_value(self, slot_index: int, value: bytes) -> None:
        log.debug("nominating value for slot %d", slot_index)

    # ------------------------------------------------- slot phase timeline --
    # Per-slot consensus timeline (mesh observatory): the SCP seams the
    # kernel already exposes map 1:1 onto the phase transitions —
    # slot_activated = nomination begins, started_ballot_protocol = the
    # first ballot (prepare), accepted_commit = the PREPARE→CONFIRM
    # flip, value_externalized = CONFIRM→EXTERNALIZE. Each transition
    # closes the previous phase into a `scp.slot.<phase>` timer
    # (metrics route + Prometheus) and, while tracing, rides the
    # flight recorder as per-slot async spans — one
    # nominate→prepare→confirm lane per node in the merged trace.
    _SLOT_PHASES = ("nominate", "prepare", "confirm", "externalize")

    def slot_activated(self, slot_index: int) -> None:
        self._slot_phase(slot_index, "nominate")

    def started_ballot_protocol(self, slot_index: int, ballot) -> None:
        self._slot_phase(slot_index, "prepare")

    def accepted_commit(self, slot_index: int, ballot) -> None:
        # fires on the PREPARE→CONFIRM flip and again on every later
        # commit/high update within CONFIRM; only the first counts
        self._slot_phase(slot_index, "confirm")

    def _slot_phase(self, slot_index: int, phase: str) -> None:
        herder = self.herder
        tl = herder.slot_timelines.get(slot_index)
        if tl is None:
            if len(herder.slot_timelines) >= herder.SLOT_TIMELINE_MAX:
                # bounded like the SCP slot map itself: oldest first
                for k in sorted(herder.slot_timelines)[
                        :len(herder.slot_timelines)
                        - herder.SLOT_TIMELINE_MAX + 1]:
                    del herder.slot_timelines[k]
            tl = herder.slot_timelines[slot_index] = {}
        if phase in tl:
            return
        now = time.perf_counter()
        rec = None
        if tracing.ENABLED:
            rec = herder.perf.tracer
            if rec is not None and not rec.active:
                rec = None
        prev = tl.get("_open")
        if prev is not None:
            if herder._metrics is not None:
                herder._metrics.timer("scp", "slot", prev).update(
                    now - tl[prev])
            if rec is not None:
                rec.async_end("scp.slot." + prev, "slot%d" % slot_index,
                              {"slot": slot_index})
        tl[phase] = now
        if phase == "externalize":
            tl["_open"] = None
            if herder._metrics is not None and "nominate" in tl:
                herder._metrics.timer("scp", "slot", "total").update(
                    now - tl["nominate"])
        else:
            tl["_open"] = phase
            if rec is not None:
                rec.async_begin("scp.slot." + phase,
                                "slot%d" % slot_index,
                                {"slot": slot_index})
