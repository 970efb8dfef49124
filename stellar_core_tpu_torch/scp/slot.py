"""One consensus slot: nomination + ballot protocols plus shared plumbing.

Reference: src/scp/Slot.{h,cpp} — envelope dispatch by statement type,
envelope creation/signing, federated voting helpers over a statement map,
fully-validated tracking, statement history for introspection.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

from ..util.logging import get_logger
from ..xdr.scp import (SCPEnvelope, SCPQuorumSet, SCPStatement,
                       SCPStatementType, _SCPStatementPledges)
from ..xdr.types import PublicKey
from .ballot import BallotProtocol, SCPPhase
from .driver import EnvelopeState
from . import local_node as ln
from .nomination import NominationProtocol

log = get_logger("SCP")

# timer ids (reference: Slot::timerIDs)
NOMINATION_TIMER = 0
BALLOT_PROTOCOL_TIMER = 1


class Slot:
    def __init__(self, slot_index: int, scp):
        self.slot_index = slot_index
        self.scp = scp
        self.ballot = BallotProtocol(self)
        self.nomination = NominationProtocol(self)
        self._fully_validated = scp.local_node.is_validator
        self.got_v_blocking = False
        # statement history for debugging/HerderPersistence
        self.statements_history: List[tuple] = []
        # slots are created lazily on first activity (an own nominate
        # or the first received envelope) — exactly when the slot's
        # nomination phase starts on this node's timeline
        scp.driver.slot_activated(slot_index)

    # ------------------------------------------------------------- wiring --
    @property
    def driver(self):
        return self.scp.driver

    @property
    def local_node(self):
        return self.scp.local_node

    def is_fully_validated(self) -> bool:
        return self._fully_validated

    def set_fully_validated(self, v: bool) -> None:
        self._fully_validated = v

    # ----------------------------------------------------------- envelopes --
    def make_statement(self, pledges: _SCPStatementPledges) -> SCPStatement:
        return SCPStatement(
            nodeID=PublicKey.ed25519(self.local_node.node_id),
            slotIndex=self.slot_index, pledges=pledges)

    def create_envelope(self, statement: SCPStatement) -> SCPEnvelope:
        env = SCPEnvelope(statement=statement, signature=b"")
        self.driver.sign_envelope(env)
        return env

    def process_envelope(self, envelope: SCPEnvelope,
                         is_self: bool = False) -> EnvelopeState:
        st = envelope.statement
        if st.slotIndex != self.slot_index:
            raise ValueError("envelope for another slot")
        if st.pledges.disc == SCPStatementType.SCP_ST_NOMINATE:
            res = self.nomination.process_envelope(envelope)
        else:
            res = self.ballot.process_envelope(envelope, is_self)
        if res == EnvelopeState.VALID and not is_self:
            self._maybe_track_v_blocking(st)
        return res

    def _maybe_track_v_blocking(self, st: SCPStatement) -> None:
        """Track whether a v-blocking set has statements on this slot
        (reference: Slot::recordStatement + Herder's use of
        maybeSetGotVBlocking)."""
        if self.got_v_blocking:
            return
        nodes: Set[bytes] = set(self.ballot.latest_envelopes.keys()) | \
            set(self.nomination.latest_nominations.keys())
        if ln.is_v_blocking(self.local_node.qset, nodes):
            self.got_v_blocking = True

    def record_statement(self, st: SCPStatement) -> None:
        self.statements_history.append(
            (ln.node_key(st.nodeID), st.pledges.disc))

    # ------------------------------------------------------------ protocol --
    def nominate(self, value: bytes, previous_value: bytes,
                 timed_out: bool = False) -> bool:
        return self.nomination.nominate(value, previous_value, timed_out)

    def stop_nomination(self) -> None:
        self.nomination.stop_nomination()

    def bump_state(self, value: bytes, force: bool) -> bool:
        if force:
            return self.ballot.bump_state_force(value)
        return self.ballot.bump_state_if_new(value)

    def abandon_ballot(self, n: int = 0) -> bool:
        return self.ballot.abandon_ballot(n)

    def get_latest_composite_candidate(self) -> Optional[bytes]:
        return self.nomination.latest_composite_candidate

    # ------------------------------------------------------ quorum lookups --
    def get_quorum_set_from_statement(
            self, st: SCPStatement) -> Optional[SCPQuorumSet]:
        t = st.pledges.disc
        if t == SCPStatementType.SCP_ST_EXTERNALIZE:
            return ln.singleton_qset(ln.node_key(st.nodeID))
        pl = st.pledges.value
        if t == SCPStatementType.SCP_ST_PREPARE:
            h = pl.quorumSetHash
        elif t == SCPStatementType.SCP_ST_CONFIRM:
            h = pl.quorumSetHash
        else:  # NOMINATE
            h = pl.quorumSetHash
        return self.driver.get_qset(bytes(h))

    def federated_accept(self, voted: Callable, accepted: Callable,
                         envs: Dict[bytes, SCPEnvelope]) -> bool:
        """v-blocking accepted, or quorum voted-or-accepted (reference:
        Slot::federatedAccept)."""
        if ln.is_v_blocking_filter(self.local_node.qset, envs, accepted):
            return True
        return ln.is_quorum(
            self.local_node.qset, envs, self.get_quorum_set_from_statement,
            lambda st: accepted(st) or voted(st))

    def federated_ratify(self, voted: Callable,
                         envs: Dict[bytes, SCPEnvelope]) -> bool:
        return ln.is_quorum(self.local_node.qset, envs,
                            self.get_quorum_set_from_statement, voted)

    # ---------------------------------------------------------- inspection --
    def get_latest_messages_send(self) -> List[SCPEnvelope]:
        """Messages to (re)broadcast for sync (reference:
        Slot::getLatestMessagesSend)."""
        res = []
        if self._fully_validated:
            if self.nomination.last_envelope is not None:
                res.append(self.nomination.last_envelope)
            if self.ballot.last_envelope_emit is not None:
                res.append(self.ballot.last_envelope_emit)
        return res

    def get_latest_message(self, node: bytes) -> Optional[SCPEnvelope]:
        env = self.ballot.get_latest_message(node)
        if env is None:
            env = self.nomination.latest_nominations.get(node)
        return env

    def get_current_state(self) -> List[SCPEnvelope]:
        """All latest envelopes for this slot (reference:
        getEntireCurrentState)."""
        out = {}
        for nid, env in self.nomination.latest_nominations.items():
            out[nid] = env
        for nid, env in self.ballot.latest_envelopes.items():
            out[nid] = env
        return list(out.values())

    def get_externalizing_state(self) -> List[SCPEnvelope]:
        return self.ballot.get_externalizing_state()

    @property
    def phase(self) -> SCPPhase:
        return self.ballot.phase
