"""SCP nomination protocol: leader election + federated value nomination.

Reference: src/scp/NominationProtocol.{h,cpp}. Per round: compute round
leaders by weighted priority hash; vote for the leaders' values; promote
votes → accepted (federated accept) → candidates (federated ratify); on
new candidates, combine and hand to the ballot protocol.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

from ..util.logging import get_logger
from ..xdr.scp import (SCPEnvelope, SCPNomination, SCPStatement,
                       SCPStatementType, _SCPStatementPledges)
from .driver import EnvelopeState, ValidationLevel
from . import local_node as ln
from .quorum_set_utils import normalize_qset

log = get_logger("SCP")

NOMINATION_TIMER = 0  # Slot timer id


def _is_subset(p: List[bytes], v: List[bytes]) -> tuple:
    """(is_subset, not_equal) — reference: isSubsetHelper."""
    if len(p) <= len(v):
        vs = set(v)
        if all(x in vs for x in p):
            return True, len(p) != len(v)
        return False, True
    return False, True


def is_newer_nomination(old: SCPNomination, new: SCPNomination) -> bool:
    votes_sub, g1 = _is_subset([bytes(x) for x in old.votes],
                               [bytes(x) for x in new.votes])
    if not votes_sub:
        return False
    acc_sub, g2 = _is_subset([bytes(x) for x in old.accepted],
                             [bytes(x) for x in new.accepted])
    if not acc_sub:
        return False
    return g1 or g2


class NominationProtocol:
    def __init__(self, slot):
        self.slot = slot
        self.round_number = 0
        self.votes: Set[bytes] = set()
        self.accepted: Set[bytes] = set()
        self.candidates: Set[bytes] = set()
        self.latest_nominations: Dict[bytes, SCPEnvelope] = {}
        self.last_envelope: Optional[SCPEnvelope] = None
        self.round_leaders: Set[bytes] = set()
        self.nomination_started = False
        self.latest_composite_candidate: Optional[bytes] = None
        self.previous_value: bytes = b""
        self.timer_exp_count = 0

    @property
    def driver(self):
        return self.slot.driver

    def local_node(self):
        return self.slot.local_node

    # ----------------------------------------------------------- validation --
    def _validate_value(self, v: bytes) -> ValidationLevel:
        return self.driver.validate_value(self.slot.slot_index, v, True)

    def _extract_valid_value(self, v: bytes) -> Optional[bytes]:
        return self.driver.extract_valid_value(self.slot.slot_index, v)

    @staticmethod
    def _is_sane(st: SCPStatement) -> bool:
        nom = st.pledges.value
        votes = [bytes(x) for x in nom.votes]
        accepted = [bytes(x) for x in nom.accepted]
        if len(votes) + len(accepted) == 0:
            return False
        return votes == sorted(set(votes)) and \
            accepted == sorted(set(accepted))

    # -------------------------------------------------------------- leaders --
    def _update_round_leaders(self) -> None:
        from ..xdr.scp import SCPQuorumSet
        my_qset = SCPQuorumSet.from_bytes(
            self.local_node().qset.to_bytes())  # deep copy
        local_id = self.local_node().node_id
        normalize_qset(my_qset, local_id)  # excludes self

        max_leader_count = 1  # includes self
        def count(_n):
            nonlocal max_leader_count
            max_leader_count += 1
            return True
        ln.for_all_nodes(my_qset, count)

        while len(self.round_leaders) < max_leader_count:
            new_leaders = {local_id}
            top_priority = self._node_priority(local_id, my_qset)

            def visit(cur: bytes) -> bool:
                nonlocal top_priority, new_leaders
                w = self._node_priority(cur, my_qset)
                if w > top_priority:
                    top_priority = w
                    new_leaders = set()
                if w == top_priority and w > 0:
                    new_leaders.add(cur)
                return True
            ln.for_all_nodes(my_qset, visit)
            old_size = len(self.round_leaders)
            self.round_leaders |= new_leaders
            if old_size != len(self.round_leaders):
                return
            # fast-forward rounds that would be no-ops
            self.round_number += 1

    def _node_priority(self, node: bytes, qset) -> int:
        if node == self.local_node().node_id:
            w = 2**64 - 1  # local node is in all quorum sets
        else:
            w = ln.get_node_weight(node, qset)
        if w > 0 and self._hash_node(False, node) <= w:
            return self._hash_node(True, node)
        return 0

    def _hash_node(self, is_priority: bool, node: bytes) -> int:
        assert self.previous_value
        return self.driver.compute_hash_node(
            self.slot.slot_index, self.previous_value, is_priority,
            self.round_number, node)

    def _hash_value(self, value: bytes) -> int:
        assert self.previous_value
        return self.driver.compute_value_hash(
            self.slot.slot_index, self.previous_value, self.round_number,
            value)

    # ------------------------------------------------------------ messaging --
    def _emit_nomination(self) -> None:
        nom = SCPNomination(
            quorumSetHash=self.local_node().qset_hash,
            votes=sorted(self.votes),
            accepted=sorted(self.accepted))
        st = self.slot.make_statement(_SCPStatementPledges(
            SCPStatementType.SCP_ST_NOMINATE, nom))
        envelope = self.slot.create_envelope(st)
        if self.slot.process_envelope(envelope, True) != EnvelopeState.VALID:
            raise RuntimeError("moved to a bad state (nomination)")
        if self.last_envelope is None or is_newer_nomination(
                self.last_envelope.statement.pledges.value, nom):
            self.last_envelope = envelope
            if self.slot.is_fully_validated():
                self.driver.emit_envelope(envelope)

    @staticmethod
    def _accept_predicate(v: bytes, st: SCPStatement) -> bool:
        nom = st.pledges.value
        return v in (bytes(x) for x in nom.accepted)

    def _get_new_value(self, nom: SCPNomination) -> Optional[bytes]:
        """Highest-hashed valid value from a leader's nomination that we
        don't already vote for (reference: getNewValueFromNomination)."""
        new_vote = None
        new_hash = 0
        found_valid = False

        def pick(value: bytes):
            nonlocal new_vote, new_hash, found_valid
            vl = self._validate_value(value)
            if vl == ValidationLevel.kFullyValidatedValue:
                candidate = value
            else:
                candidate = self._extract_valid_value(value)
            if candidate is not None:
                found_valid = True
                if candidate not in self.votes:
                    h = self._hash_value(candidate)
                    if h >= new_hash:
                        new_hash = h
                        new_vote = candidate

        for val in nom.accepted:
            pick(bytes(val))
        if not found_valid:
            for val in nom.votes:
                pick(bytes(val))
        return new_vote

    # ------------------------------------------------------------- process --
    def process_envelope(self, envelope: SCPEnvelope) -> EnvelopeState:
        st = envelope.statement
        nom = st.pledges.value
        node = ln.node_key(st.nodeID)
        old = self.latest_nominations.get(node)
        if old is not None and not is_newer_nomination(
                old.statement.pledges.value, nom):
            return EnvelopeState.INVALID
        if not self._is_sane(st):
            return EnvelopeState.INVALID
        self.latest_nominations[node] = envelope
        self.slot.record_statement(st)

        if not self.nomination_started:
            return EnvelopeState.VALID

        modified = False
        new_candidates = False

        # promote votes → accepted
        for v in (bytes(x) for x in nom.votes):
            if v in self.accepted:
                continue

            def voted(stx, _v=v):
                n = stx.pledges.value
                return _v in (bytes(x) for x in n.votes)

            if self.slot.federated_accept(
                    voted, lambda stx, _v=v: self._accept_predicate(_v, stx),
                    self.latest_nominations):
                vl = self._validate_value(v)
                if vl == ValidationLevel.kFullyValidatedValue:
                    self.accepted.add(v)
                    self.votes.add(v)
                    modified = True
                else:
                    to_vote = self._extract_valid_value(v)
                    if to_vote is not None and to_vote not in self.votes:
                        self.votes.add(to_vote)
                        modified = True

        # promote accepted → candidates
        for a in list(self.accepted):
            if a in self.candidates:
                continue
            if self.slot.federated_ratify(
                    lambda stx, _a=a: self._accept_predicate(_a, stx),
                    self.latest_nominations):
                self.candidates.add(a)
                new_candidates = True
                # whitepaper: stop nominating new values once a candidate
                # exists
                self.driver.stop_timer(self.slot.slot_index,
                                       NOMINATION_TIMER)

        # adopt leader votes while still seeking candidates
        if not self.candidates and node in self.round_leaders:
            new_vote = self._get_new_value(nom)
            if new_vote is not None:
                self.votes.add(new_vote)
                modified = True
                self.driver.nominating_value(self.slot.slot_index, new_vote)

        if modified:
            self._emit_nomination()

        if new_candidates:
            self.latest_composite_candidate = \
                self.driver.combine_candidates(self.slot.slot_index,
                                               set(self.candidates))
            if self.latest_composite_candidate is not None:
                self.driver.updated_candidate_value(
                    self.slot.slot_index, self.latest_composite_candidate)
                self.slot.bump_state(self.latest_composite_candidate, False)

        return EnvelopeState.VALID

    # ------------------------------------------------------------- nominate --
    def nominate(self, value: bytes, previous_value: bytes,
                 timed_out: bool) -> bool:
        """Start/continue nominating (reference:
        NominationProtocol::nominate)."""
        if self.candidates:
            log.debug("skip nomination round %d, already have a candidate",
                      self.round_number)
            return False
        updated = False
        if timed_out:
            self.timer_exp_count += 1
            if not self.nomination_started:
                return False
        self.nomination_started = True
        self.previous_value = previous_value
        self.round_number += 1
        self._update_round_leaders()
        timeout = self.driver.compute_timeout(self.round_number)

        # adopt values already nominated by this round's leaders
        for leader in self.round_leaders:
            env = self.latest_nominations.get(leader)
            if env is not None:
                v = self._get_new_value(env.statement.pledges.value)
                if v is not None:
                    self.votes.add(v)
                    updated = True
                    self.driver.nominating_value(self.slot.slot_index, v)

        # if we're a leader, seed our own value
        if self.local_node().node_id in self.round_leaders \
                and not self.votes:
            if value not in self.votes:
                self.votes.add(value)
                updated = True
                self.driver.nominating_value(self.slot.slot_index, value)

        self.driver.setup_timer(
            self.slot.slot_index, NOMINATION_TIMER, timeout,
            lambda: self.slot.nominate(value, previous_value, True))

        if updated:
            self._emit_nomination()
        return updated

    def stop_nomination(self) -> None:
        self.nomination_started = False

    def get_leaders(self) -> Set[bytes]:
        return set(self.round_leaders)
