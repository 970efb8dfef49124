"""SCP ballot protocol: prepare → confirm → externalize.

Reference: src/scp/BallotProtocol.{h,cpp} (2,269 LoC state machine; built
here against the whitepaper steps and the reference's observable
behavior, not line-by-line). State per slot: b (current), p/p' (two
highest incompatible accepted-prepared), c/h (commit range), phase.

Statement semantics used by the federated-voting predicates:
- PREPARE(b, p, p', nC, nH): votes prepare(b); accepts prepare(p), (p');
  if nC != 0 votes commit for counters [nC, nH] on b.value.
- CONFIRM(b, nPrepared, nCommit, nH): accepts prepare(nPrepared, b.value)
  (and everything below); accepts commit [nCommit, nH]; votes commit
  [nCommit, ∞).
- EXTERNALIZE(commit, nH): accepts commit [commit.n, ∞) and prepare(∞).
"""

from __future__ import annotations

from enum import IntEnum
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..util.logging import get_logger
from ..xdr.scp import (SCPBallot, SCPEnvelope, SCPStatement,
                       SCPStatementConfirm, SCPStatementExternalize,
                       SCPStatementPrepare, SCPStatementType,
                       _SCPStatementPledges)
from .driver import EnvelopeState, ValidationLevel
from . import local_node as ln

log = get_logger("SCP")

UINT32_MAX = 0xFFFFFFFF
MAX_ADVANCE_SLOT_RECURSION = 50

BALLOT_PROTOCOL_TIMER = 1  # Slot timer ids (reference: Slot::timerIDs)


class SCPPhase(IntEnum):
    SCP_PHASE_PREPARE = 0
    SCP_PHASE_CONFIRM = 1
    SCP_PHASE_EXTERNALIZE = 2


# ---------------------------------------------------------------- ballots --

def make_ballot(counter: int, value: bytes) -> SCPBallot:
    return SCPBallot(counter=counter, value=value)


def copy_ballot(b: SCPBallot) -> SCPBallot:
    return SCPBallot(counter=b.counter, value=bytes(b.value))


def compare_ballots(b1: Optional[SCPBallot],
                    b2: Optional[SCPBallot]) -> int:
    if b1 is not None and b2 is None:
        return 1
    if b1 is None and b2 is not None:
        return -1
    if b1 is None and b2 is None:
        return 0
    if b1.counter != b2.counter:
        return -1 if b1.counter < b2.counter else 1
    v1, v2 = bytes(b1.value), bytes(b2.value)
    if v1 != v2:
        return -1 if v1 < v2 else 1
    return 0


def are_ballots_compatible(b1: SCPBallot, b2: SCPBallot) -> bool:
    return bytes(b1.value) == bytes(b2.value)


def are_ballots_less_and_compatible(b1: SCPBallot, b2: SCPBallot) -> bool:
    return compare_ballots(b1, b2) <= 0 and are_ballots_compatible(b1, b2)


def are_ballots_less_and_incompatible(b1: SCPBallot, b2: SCPBallot) -> bool:
    return compare_ballots(b1, b2) <= 0 and not are_ballots_compatible(b1, b2)


def _ballot_sort_key(b: SCPBallot) -> Tuple[int, bytes]:
    return (b.counter, bytes(b.value))


# --------------------------------------------------- statement inspection --

def statement_ballot_counter(st: SCPStatement) -> int:
    t = st.pledges.disc
    if t == SCPStatementType.SCP_ST_PREPARE:
        return st.pledges.value.ballot.counter
    if t == SCPStatementType.SCP_ST_CONFIRM:
        return st.pledges.value.ballot.counter
    return UINT32_MAX


def get_working_ballot(st: SCPStatement) -> SCPBallot:
    t = st.pledges.disc
    pl = st.pledges.value
    if t == SCPStatementType.SCP_ST_PREPARE:
        return pl.ballot
    if t == SCPStatementType.SCP_ST_CONFIRM:
        return make_ballot(pl.nCommit, bytes(pl.ballot.value))
    return pl.commit


def has_prepared_ballot(ballot: SCPBallot, st: SCPStatement) -> bool:
    t = st.pledges.disc
    pl = st.pledges.value
    if t == SCPStatementType.SCP_ST_PREPARE:
        return ((pl.prepared is not None and
                 are_ballots_less_and_compatible(ballot, pl.prepared)) or
                (pl.preparedPrime is not None and
                 are_ballots_less_and_compatible(ballot, pl.preparedPrime)))
    if t == SCPStatementType.SCP_ST_CONFIRM:
        prepared = make_ballot(pl.nPrepared, bytes(pl.ballot.value))
        return are_ballots_less_and_compatible(ballot, prepared)
    return are_ballots_compatible(ballot, pl.commit)


def commit_predicate(ballot: SCPBallot, check: Tuple[int, int],
                     st: SCPStatement) -> bool:
    t = st.pledges.disc
    pl = st.pledges.value
    if t == SCPStatementType.SCP_ST_PREPARE:
        return False
    if t == SCPStatementType.SCP_ST_CONFIRM:
        if are_ballots_compatible(ballot, pl.ballot):
            return pl.nCommit <= check[0] and check[1] <= pl.nH
        return False
    if are_ballots_compatible(ballot, pl.commit):
        return pl.commit.counter <= check[0]
    return False


def get_statement_values(st: SCPStatement) -> Set[bytes]:
    values: Set[bytes] = set()
    t = st.pledges.disc
    pl = st.pledges.value
    if t == SCPStatementType.SCP_ST_PREPARE:
        if pl.ballot.counter != 0:
            values.add(bytes(pl.ballot.value))
        if pl.prepared is not None:
            values.add(bytes(pl.prepared.value))
        if pl.preparedPrime is not None:
            values.add(bytes(pl.preparedPrime.value))
    elif t == SCPStatementType.SCP_ST_CONFIRM:
        values.add(bytes(pl.ballot.value))
    else:
        values.add(bytes(pl.commit.value))
    return values


def is_newer_statement(oldst: SCPStatement, st: SCPStatement) -> bool:
    """Total order on ballot statements (reference:
    BallotProtocol::isNewerStatement)."""
    t = st.pledges.disc
    if oldst.pledges.disc != t:
        return oldst.pledges.disc < t
    if t == SCPStatementType.SCP_ST_EXTERNALIZE:
        return False
    if t == SCPStatementType.SCP_ST_CONFIRM:
        old_c, c = oldst.pledges.value, st.pledges.value
        comp = compare_ballots(old_c.ballot, c.ballot)
        if comp != 0:
            return comp < 0
        if old_c.nPrepared != c.nPrepared:
            return old_c.nPrepared < c.nPrepared
        return old_c.nH < c.nH
    old_p, p = oldst.pledges.value, st.pledges.value
    comp = compare_ballots(old_p.ballot, p.ballot)
    if comp != 0:
        return comp < 0
    comp = compare_ballots(old_p.prepared, p.prepared)
    if comp != 0:
        return comp < 0
    comp = compare_ballots(old_p.preparedPrime, p.preparedPrime)
    if comp != 0:
        return comp < 0
    return old_p.nH < p.nH


# ------------------------------------------------------------ the machine --

class BallotProtocol:
    def __init__(self, slot):
        self.slot = slot
        self.phase = SCPPhase.SCP_PHASE_PREPARE
        self.current: Optional[SCPBallot] = None       # b
        self.prepared: Optional[SCPBallot] = None      # p
        self.prepared_prime: Optional[SCPBallot] = None  # p'
        self.high: Optional[SCPBallot] = None          # h
        self.commit: Optional[SCPBallot] = None        # c
        self.value_override: Optional[bytes] = None
        self.latest_envelopes: Dict[bytes, SCPEnvelope] = {}
        self.last_envelope: Optional[SCPEnvelope] = None
        self.last_envelope_emit: Optional[SCPEnvelope] = None
        self.heard_from_quorum = False
        self._message_level = 0
        self.timer_exp_count = 0

    # ------------------------------------------------------------- helpers --
    @property
    def driver(self):
        return self.slot.driver

    def local_node(self):
        return self.slot.local_node

    # ------------------------------------------------------------ envelope --
    def process_envelope(self, envelope: SCPEnvelope,
                         is_self: bool) -> EnvelopeState:
        st = envelope.statement
        assert st.slotIndex == self.slot.slot_index
        if not self._is_statement_sane(st, is_self):
            return EnvelopeState.INVALID
        node = ln.node_key(st.nodeID)
        if not self._is_newer(node, st):
            return EnvelopeState.INVALID
        validation = self._validate_values(st)
        if validation == ValidationLevel.kInvalidValue:
            if is_self:
                log.error("invalid value from self, slot %d",
                          self.slot.slot_index)
            return EnvelopeState.INVALID

        if self.phase != SCPPhase.SCP_PHASE_EXTERNALIZE:
            if validation == ValidationLevel.kMaybeValidValue:
                self.slot.set_fully_validated(False)
            self.latest_envelopes[node] = envelope
            self._advance_slot(st)
            return EnvelopeState.VALID

        # externalize phase: only accept compatible statements
        if bytes(self.commit.value) == bytes(get_working_ballot(st).value):
            self.latest_envelopes[node] = envelope
            return EnvelopeState.VALID
        return EnvelopeState.INVALID

    def _is_newer(self, node: bytes, st: SCPStatement) -> bool:
        old = self.latest_envelopes.get(node)
        return old is None or is_newer_statement(old.statement, st)

    def _is_statement_sane(self, st: SCPStatement, is_self: bool) -> bool:
        qset = self.slot.get_quorum_set_from_statement(st)
        if qset is None:
            return False
        from .quorum_set_utils import is_quorum_set_sane
        ok, _ = is_quorum_set_sane(qset, False)
        if not ok:
            return False
        t = st.pledges.disc
        pl = st.pledges.value
        if t == SCPStatementType.SCP_ST_PREPARE:
            ok = is_self or pl.ballot.counter > 0
            ok = ok and ((pl.preparedPrime is None or pl.prepared is None) or
                         are_ballots_less_and_incompatible(
                             pl.preparedPrime, pl.prepared))
            ok = ok and (pl.nH == 0 or
                         (pl.prepared is not None and
                          pl.nH <= pl.prepared.counter))
            ok = ok and (pl.nC == 0 or
                         (pl.nH != 0 and pl.ballot.counter >= pl.nH and
                          pl.nH >= pl.nC))
            return ok
        if t == SCPStatementType.SCP_ST_CONFIRM:
            return (pl.ballot.counter > 0 and pl.nH <= pl.ballot.counter
                    and pl.nCommit <= pl.nH)
        if t == SCPStatementType.SCP_ST_EXTERNALIZE:
            return pl.commit.counter > 0 and pl.nH >= pl.commit.counter
        return False

    def _validate_values(self, st: SCPStatement) -> ValidationLevel:
        values = get_statement_values(st)
        if not values:
            return ValidationLevel.kInvalidValue
        level = ValidationLevel.kFullyValidatedValue
        for v in values:
            if level == ValidationLevel.kInvalidValue:
                break
            level = min(level, self.driver.validate_value(
                self.slot.slot_index, v, False))
        return level

    # --------------------------------------------------------------- bumps --
    def abandon_ballot(self, n: int) -> bool:
        v = self.slot.get_latest_composite_candidate()
        if not v:
            if self.current is not None:
                v = bytes(self.current.value)
        if not v:
            return False
        if n == 0:
            return self.bump_state_force(v)
        return self.bump_state(v, n)

    def bump_state_force(self, value: bytes) -> bool:
        n = self.current.counter + 1 if self.current is not None else 1
        return self.bump_state(value, n)

    def bump_state_if_new(self, value: bytes) -> bool:
        """bumpState(value, force=false)."""
        if self.current is not None:
            return False
        return self.bump_state(value, 1)

    def bump_state(self, value: bytes, n: int) -> bool:
        if self.phase not in (SCPPhase.SCP_PHASE_PREPARE,
                              SCPPhase.SCP_PHASE_CONFIRM):
            return False
        newb = make_ballot(
            n, self.value_override if self.value_override is not None
            else value)
        updated = self._update_current_value(newb)
        if updated:
            self._emit_current_state()
            self._check_heard_from_quorum()
        return updated

    def _update_current_value(self, ballot: SCPBallot) -> bool:
        if self.phase not in (SCPPhase.SCP_PHASE_PREPARE,
                              SCPPhase.SCP_PHASE_CONFIRM):
            return False
        updated = False
        if self.current is None:
            self._bump_to_ballot(ballot, True)
            updated = True
        else:
            if self.commit is not None and \
                    not are_ballots_compatible(self.commit, ballot):
                return False
            comp = compare_ballots(self.current, ballot)
            if comp < 0:
                self._bump_to_ballot(ballot, True)
                updated = True
            elif comp > 0:
                log.error("attempt to bump to a smaller ballot")
                return False
        self._check_invariants()
        return updated

    def _bump_to_ballot(self, ballot: SCPBallot, check: bool) -> None:
        assert self.phase != SCPPhase.SCP_PHASE_EXTERNALIZE
        if check:
            assert self.current is None or \
                compare_ballots(ballot, self.current) >= 0
        got_bumped = self.current is None or \
            self.current.counter != ballot.counter
        if self.current is None:
            self.driver.started_ballot_protocol(self.slot.slot_index, ballot)
        self.current = copy_ballot(ballot)
        if self.high is not None and \
                not are_ballots_compatible(self.current, self.high):
            self.high = None
            self.commit = None
        if got_bumped:
            self.heard_from_quorum = False

    # --------------------------------------------------------------- timer --
    def _start_timer(self) -> None:
        timeout = self.driver.compute_timeout(self.current.counter)
        self.driver.setup_timer(self.slot.slot_index, BALLOT_PROTOCOL_TIMER,
                                timeout, self._timer_expired)

    def _stop_timer(self) -> None:
        self.driver.setup_timer(self.slot.slot_index, BALLOT_PROTOCOL_TIMER,
                                0, None)

    def _timer_expired(self) -> None:
        self.timer_exp_count += 1
        self.abandon_ballot(0)

    # ----------------------------------------------------------- statements --
    def _create_statement(self) -> SCPStatement:
        self._check_invariants()
        lnode = self.local_node()
        if self.phase == SCPPhase.SCP_PHASE_PREPARE:
            pl = SCPStatementPrepare(
                quorumSetHash=lnode.qset_hash,
                ballot=(copy_ballot(self.current) if self.current is not None
                        else make_ballot(0, b"")),
                prepared=(copy_ballot(self.prepared)
                          if self.prepared is not None else None),
                preparedPrime=(copy_ballot(self.prepared_prime)
                               if self.prepared_prime is not None else None),
                nC=self.commit.counter if self.commit is not None else 0,
                nH=self.high.counter if self.high is not None else 0)
            pledges = _SCPStatementPledges(
                SCPStatementType.SCP_ST_PREPARE, pl)
        elif self.phase == SCPPhase.SCP_PHASE_CONFIRM:
            pl = SCPStatementConfirm(
                ballot=copy_ballot(self.current),
                nPrepared=self.prepared.counter,
                nCommit=self.commit.counter,
                nH=self.high.counter,
                quorumSetHash=lnode.qset_hash)
            pledges = _SCPStatementPledges(
                SCPStatementType.SCP_ST_CONFIRM, pl)
        else:
            pl = SCPStatementExternalize(
                commit=copy_ballot(self.commit),
                nH=self.high.counter,
                commitQuorumSetHash=lnode.qset_hash)
            pledges = _SCPStatementPledges(
                SCPStatementType.SCP_ST_EXTERNALIZE, pl)
        return self.slot.make_statement(pledges)

    def _emit_current_state(self) -> None:
        statement = self._create_statement()
        envelope = self.slot.create_envelope(statement)
        can_emit = self.current is not None
        me = self.local_node().node_id
        last = self.latest_envelopes.get(me)
        if last is None or last.to_bytes() != envelope.to_bytes():
            if self.slot.process_envelope(envelope, True) != \
                    EnvelopeState.VALID:
                raise RuntimeError("moved to a bad state (ballot protocol)")
            if can_emit and (self.last_envelope is None or
                             is_newer_statement(
                                 self.last_envelope.statement,
                                 envelope.statement)):
                self.last_envelope = envelope
                self.send_latest_envelope()

    def send_latest_envelope(self) -> None:
        if self._message_level == 0 and self.last_envelope is not None \
                and self.slot.is_fully_validated():
            if self.last_envelope_emit is not self.last_envelope:
                self.last_envelope_emit = self.last_envelope
                self.driver.emit_envelope(self.last_envelope_emit)

    def _check_invariants(self) -> None:
        if self.phase in (SCPPhase.SCP_PHASE_CONFIRM,
                          SCPPhase.SCP_PHASE_EXTERNALIZE):
            assert self.current is not None and self.prepared is not None
            assert self.commit is not None and self.high is not None
        if self.current is not None:
            assert self.current.counter != 0
        if self.prepared is not None and self.prepared_prime is not None:
            assert are_ballots_less_and_incompatible(
                self.prepared_prime, self.prepared)
        if self.high is not None:
            assert are_ballots_less_and_compatible(self.high, self.current)
        if self.commit is not None:
            assert are_ballots_less_and_compatible(self.commit, self.high)

    # ----------------------------------------------------- federated voting --
    def _get_prepare_candidates(self, hint: SCPStatement) -> List[SCPBallot]:
        """All ballots that might be accepted-prepared, descending
        (reference: getPrepareCandidates)."""
        hint_ballots: List[SCPBallot] = []
        t = hint.pledges.disc
        pl = hint.pledges.value
        if t == SCPStatementType.SCP_ST_PREPARE:
            hint_ballots.append(pl.ballot)
            if pl.prepared is not None:
                hint_ballots.append(pl.prepared)
            if pl.preparedPrime is not None:
                hint_ballots.append(pl.preparedPrime)
        elif t == SCPStatementType.SCP_ST_CONFIRM:
            hint_ballots.append(make_ballot(pl.nPrepared,
                                            bytes(pl.ballot.value)))
            hint_ballots.append(make_ballot(UINT32_MAX,
                                            bytes(pl.ballot.value)))
        else:
            hint_ballots.append(make_ballot(UINT32_MAX,
                                            bytes(pl.commit.value)))

        seen = set()
        candidates: Dict[Tuple[int, bytes], SCPBallot] = {}
        # process top votes descending
        for top_vote in sorted(hint_ballots, key=_ballot_sort_key,
                               reverse=True):
            k = _ballot_sort_key(top_vote)
            if k in seen:
                continue
            seen.add(k)
            val = bytes(top_vote.value)
            for env in self.latest_envelopes.values():
                st = env.statement
                st_t = st.pledges.disc
                st_pl = st.pledges.value
                if st_t == SCPStatementType.SCP_ST_PREPARE:
                    for b in (st_pl.ballot, st_pl.prepared,
                              st_pl.preparedPrime):
                        if b is not None and \
                                are_ballots_less_and_compatible(b, top_vote):
                            candidates[_ballot_sort_key(b)] = b
                elif st_t == SCPStatementType.SCP_ST_CONFIRM:
                    if are_ballots_compatible(top_vote, st_pl.ballot):
                        candidates[k] = top_vote
                        if st_pl.nPrepared < top_vote.counter:
                            b = make_ballot(st_pl.nPrepared, val)
                            candidates[_ballot_sort_key(b)] = b
                else:
                    if are_ballots_compatible(top_vote, st_pl.commit):
                        candidates[k] = top_vote
        return sorted(candidates.values(), key=_ballot_sort_key,
                      reverse=True)

    def _federated_accept(self, voted, accepted) -> bool:
        return self.slot.federated_accept(voted, accepted,
                                          self.latest_envelopes)

    def _federated_ratify(self, voted) -> bool:
        return self.slot.federated_ratify(voted, self.latest_envelopes)

    # ------------------------------------------------------ attempt* steps --
    def _attempt_accept_prepared(self, hint: SCPStatement) -> bool:
        if self.phase not in (SCPPhase.SCP_PHASE_PREPARE,
                              SCPPhase.SCP_PHASE_CONFIRM):
            return False
        for ballot in self._get_prepare_candidates(hint):
            if self.phase == SCPPhase.SCP_PHASE_CONFIRM:
                if not are_ballots_less_and_compatible(
                        self.prepared, ballot):
                    continue
            if self.prepared_prime is not None and \
                    compare_ballots(ballot, self.prepared_prime) <= 0:
                continue
            if self.prepared is not None and \
                    are_ballots_less_and_compatible(ballot, self.prepared):
                continue

            def voted(st, _b=ballot):
                t = st.pledges.disc
                pl = st.pledges.value
                if t == SCPStatementType.SCP_ST_PREPARE:
                    return are_ballots_less_and_compatible(_b, pl.ballot)
                if t == SCPStatementType.SCP_ST_CONFIRM:
                    return are_ballots_compatible(_b, pl.ballot)
                return are_ballots_compatible(_b, pl.commit)

            if self._federated_accept(
                    voted, lambda st, _b=ballot: has_prepared_ballot(_b, st)):
                return self._set_accept_prepared(ballot)
        return False

    def _set_accept_prepared(self, ballot: SCPBallot) -> bool:
        did_work = self._set_prepared(ballot)
        if self.commit is not None and self.high is not None:
            if (self.prepared is not None and
                are_ballots_less_and_incompatible(self.high, self.prepared)) \
               or (self.prepared_prime is not None and
                   are_ballots_less_and_incompatible(self.high,
                                                     self.prepared_prime)):
                assert self.phase == SCPPhase.SCP_PHASE_PREPARE
                self.commit = None
                did_work = True
        if did_work:
            self.driver.accepted_ballot_prepared(self.slot.slot_index, ballot)
            self._emit_current_state()
        return did_work

    def _attempt_confirm_prepared(self, hint: SCPStatement) -> bool:
        if self.phase != SCPPhase.SCP_PHASE_PREPARE:
            return False
        if self.prepared is None:
            return False
        candidates = self._get_prepare_candidates(hint)
        new_h = None
        idx = 0
        for idx, ballot in enumerate(candidates):
            if self.high is not None and \
                    compare_ballots(self.high, ballot) >= 0:
                break
            if self._federated_ratify(
                    lambda st, _b=ballot: has_prepared_ballot(_b, st)):
                new_h = ballot
                break
        if new_h is None:
            return False
        new_c = make_ballot(0, b"")
        b = self.current if self.current is not None else make_ballot(0, b"")
        if self.commit is None and \
                (self.prepared is None or
                 not are_ballots_less_and_incompatible(new_h, self.prepared)) \
                and (self.prepared_prime is None or
                     not are_ballots_less_and_incompatible(
                         new_h, self.prepared_prime)):
            # c search resumes AT new_h (c may equal h)
            for ballot in candidates[idx:]:
                if compare_ballots(ballot, b) < 0:
                    break
                if not are_ballots_less_and_compatible(ballot, new_h):
                    continue
                if self._federated_ratify(
                        lambda st, _b=ballot: has_prepared_ballot(_b, st)):
                    new_c = ballot
                else:
                    break
        return self._set_confirm_prepared(new_c, new_h)

    def _set_confirm_prepared(self, new_c: SCPBallot,
                              new_h: SCPBallot) -> bool:
        self.value_override = bytes(new_h.value)
        did_work = False
        if self.current is None or \
                are_ballots_compatible(self.current, new_h):
            if self.high is None or compare_ballots(new_h, self.high) > 0:
                did_work = True
                self.high = copy_ballot(new_h)
            if new_c.counter != 0:
                assert self.commit is None
                self.commit = copy_ballot(new_c)
                did_work = True
            if did_work:
                self.driver.confirmed_ballot_prepared(
                    self.slot.slot_index, new_h)
        did_work = self._update_current_if_needed(new_h) or did_work
        if did_work:
            self._emit_current_state()
        return did_work

    def _update_current_if_needed(self, h: SCPBallot) -> bool:
        if self.current is None or compare_ballots(self.current, h) < 0:
            self._bump_to_ballot(h, True)
            return True
        return False

    def _get_commit_boundaries(self, ballot: SCPBallot) -> List[int]:
        res: Set[int] = set()
        for env in self.latest_envelopes.values():
            st = env.statement
            t = st.pledges.disc
            pl = st.pledges.value
            if t == SCPStatementType.SCP_ST_PREPARE:
                if are_ballots_compatible(ballot, pl.ballot) and pl.nC:
                    res.add(pl.nC)
                    res.add(pl.nH)
            elif t == SCPStatementType.SCP_ST_CONFIRM:
                if are_ballots_compatible(ballot, pl.ballot):
                    res.add(pl.nCommit)
                    res.add(pl.nH)
            else:
                if are_ballots_compatible(ballot, pl.commit):
                    res.add(pl.commit.counter)
                    res.add(pl.nH)
                    res.add(UINT32_MAX)
        return sorted(res)

    @staticmethod
    def _find_extended_interval(boundaries: List[int],
                                pred: Callable[[Tuple[int, int]], bool]
                                ) -> Tuple[int, int]:
        candidate = (0, 0)
        for b in reversed(boundaries):
            if candidate[0] == 0:
                cur = (b, b)
            elif b > candidate[1]:
                continue
            else:
                cur = (b, candidate[1])
            if pred(cur):
                candidate = cur
            elif candidate[0] != 0:
                break
        return candidate

    def _attempt_accept_commit(self, hint: SCPStatement) -> bool:
        if self.phase not in (SCPPhase.SCP_PHASE_PREPARE,
                              SCPPhase.SCP_PHASE_CONFIRM):
            return False
        t = hint.pledges.disc
        pl = hint.pledges.value
        if t == SCPStatementType.SCP_ST_PREPARE:
            if pl.nC == 0:
                return False
            ballot = make_ballot(pl.nH, bytes(pl.ballot.value))
        elif t == SCPStatementType.SCP_ST_CONFIRM:
            ballot = make_ballot(pl.nH, bytes(pl.ballot.value))
        else:
            ballot = make_ballot(pl.nH, bytes(pl.commit.value))

        if self.phase == SCPPhase.SCP_PHASE_CONFIRM and \
                not are_ballots_compatible(ballot, self.high):
            return False

        def pred(cur: Tuple[int, int]) -> bool:
            def voted(st, _b=ballot, _cur=cur):
                st_t = st.pledges.disc
                st_pl = st.pledges.value
                if st_t == SCPStatementType.SCP_ST_PREPARE:
                    if are_ballots_compatible(_b, st_pl.ballot) \
                            and st_pl.nC != 0:
                        return st_pl.nC <= _cur[0] and _cur[1] <= st_pl.nH
                    return False
                if st_t == SCPStatementType.SCP_ST_CONFIRM:
                    if are_ballots_compatible(_b, st_pl.ballot):
                        return st_pl.nCommit <= _cur[0]
                    return False
                if are_ballots_compatible(_b, st_pl.commit):
                    return st_pl.commit.counter <= _cur[0]
                return False
            return self._federated_accept(
                voted,
                lambda st, _b=ballot, _cur=cur: commit_predicate(
                    _b, _cur, st))

        boundaries = self._get_commit_boundaries(ballot)
        if not boundaries:
            return False
        candidate = self._find_extended_interval(boundaries, pred)
        if candidate[0] != 0:
            if self.phase != SCPPhase.SCP_PHASE_CONFIRM or \
                    candidate[1] > self.high.counter:
                return self._set_accept_commit(
                    make_ballot(candidate[0], bytes(ballot.value)),
                    make_ballot(candidate[1], bytes(ballot.value)))
        return False

    def _set_accept_commit(self, c: SCPBallot, h: SCPBallot) -> bool:
        did_work = False
        self.value_override = bytes(h.value)
        if self.high is None or self.commit is None or \
                compare_ballots(self.high, h) != 0 or \
                compare_ballots(self.commit, c) != 0:
            self.commit = copy_ballot(c)
            self.high = copy_ballot(h)
            did_work = True
        if self.phase == SCPPhase.SCP_PHASE_PREPARE:
            self.phase = SCPPhase.SCP_PHASE_CONFIRM
            if self.current is not None and \
                    not are_ballots_less_and_compatible(h, self.current):
                self._bump_to_ballot(h, False)
            self.prepared_prime = None
            did_work = True
        if did_work:
            self._update_current_if_needed(self.high)
            self.driver.accepted_commit(self.slot.slot_index, h)
            self._emit_current_state()
        return did_work

    def _attempt_confirm_commit(self, hint: SCPStatement) -> bool:
        if self.phase != SCPPhase.SCP_PHASE_CONFIRM:
            return False
        if self.high is None or self.commit is None:
            return False
        t = hint.pledges.disc
        pl = hint.pledges.value
        if t == SCPStatementType.SCP_ST_PREPARE:
            return False
        if t == SCPStatementType.SCP_ST_CONFIRM:
            ballot = make_ballot(pl.nH, bytes(pl.ballot.value))
        else:
            ballot = make_ballot(pl.nH, bytes(pl.commit.value))
        if not are_ballots_compatible(ballot, self.commit):
            return False
        boundaries = self._get_commit_boundaries(ballot)
        candidate = self._find_extended_interval(
            boundaries,
            lambda cur: self._federated_ratify(
                lambda st, _b=ballot, _cur=cur: commit_predicate(
                    _b, _cur, st)))
        if candidate[0] != 0:
            return self._set_confirm_commit(
                make_ballot(candidate[0], bytes(ballot.value)),
                make_ballot(candidate[1], bytes(ballot.value)))
        return False

    def _set_confirm_commit(self, c: SCPBallot, h: SCPBallot) -> bool:
        self.commit = copy_ballot(c)
        self.high = copy_ballot(h)
        self._update_current_if_needed(self.high)
        self.phase = SCPPhase.SCP_PHASE_EXTERNALIZE
        self._emit_current_state()
        self.slot.stop_nomination()
        self.driver.value_externalized(self.slot.slot_index,
                                       bytes(self.commit.value))
        return True

    def _set_prepared(self, ballot: SCPBallot) -> bool:
        did_work = False
        if self.prepared is not None:
            comp = compare_ballots(self.prepared, ballot)
            if comp < 0:
                if not are_ballots_compatible(self.prepared, ballot):
                    self.prepared_prime = copy_ballot(self.prepared)
                self.prepared = copy_ballot(ballot)
                did_work = True
            elif comp > 0:
                if self.prepared_prime is None or \
                        (compare_ballots(self.prepared_prime, ballot) < 0 and
                         not are_ballots_compatible(self.prepared, ballot)):
                    self.prepared_prime = copy_ballot(ballot)
                    did_work = True
        else:
            self.prepared = copy_ballot(ballot)
            did_work = True
        return did_work

    # ----------------------------------------------------------- 9th rule --
    def _has_v_blocking_ahead_of(self, n: int) -> bool:
        return ln.is_v_blocking_filter(
            self.local_node().qset, self.latest_envelopes,
            lambda st: statement_ballot_counter(st) > n)

    def _attempt_bump(self) -> bool:
        """Step 9: if a v-blocking set is on higher counters, jump to the
        lowest counter where that's no longer true."""
        if self.phase not in (SCPPhase.SCP_PHASE_PREPARE,
                              SCPPhase.SCP_PHASE_CONFIRM):
            return False
        local_counter = self.current.counter if self.current is not None \
            else 0
        if not self._has_v_blocking_ahead_of(local_counter):
            return False
        all_counters = sorted({
            statement_ballot_counter(env.statement)
            for env in self.latest_envelopes.values()
            if statement_ballot_counter(env.statement) > local_counter})
        for n in all_counters:
            if not self._has_v_blocking_ahead_of(n):
                return self.abandon_ballot(n)
        return False

    def _check_heard_from_quorum(self) -> None:
        if self.current is None:
            return

        def flt(st) -> bool:
            if st.pledges.disc == SCPStatementType.SCP_ST_PREPARE:
                return self.current.counter <= \
                    st.pledges.value.ballot.counter
            return True

        if ln.is_quorum(self.local_node().qset, self.latest_envelopes,
                        self.slot.get_quorum_set_from_statement, flt):
            old = self.heard_from_quorum
            self.heard_from_quorum = True
            if not old:
                self.driver.ballot_did_hear_from_quorum(
                    self.slot.slot_index, self.current)
                if self.phase != SCPPhase.SCP_PHASE_EXTERNALIZE:
                    self._start_timer()
            if self.phase == SCPPhase.SCP_PHASE_EXTERNALIZE:
                self._stop_timer()
        else:
            self.heard_from_quorum = False
            self._stop_timer()

    # ------------------------------------------------------------- driver --
    def _advance_slot(self, hint: SCPStatement) -> None:
        self._message_level += 1
        if self._message_level >= MAX_ADVANCE_SLOT_RECURSION:
            self._message_level -= 1
            raise RuntimeError("maximum number of transitions in advanceSlot")
        did_work = False
        did_work = self._attempt_accept_prepared(hint) or did_work
        did_work = self._attempt_confirm_prepared(hint) or did_work
        did_work = self._attempt_accept_commit(hint) or did_work
        did_work = self._attempt_confirm_commit(hint) or did_work
        if self._message_level == 1:
            while True:
                did_bump = self._attempt_bump()
                did_work = did_bump or did_work
                if not did_bump:
                    break
            self._check_heard_from_quorum()
        self._message_level -= 1
        if did_work:
            self.send_latest_envelope()

    # ---------------------------------------------------------- inspection --
    def get_latest_message(self, node: bytes) -> Optional[SCPEnvelope]:
        return self.latest_envelopes.get(node)

    def get_externalizing_state(self) -> List[SCPEnvelope]:
        if self.phase != SCPPhase.SCP_PHASE_EXTERNALIZE:
            return []
        return [env for nid, env in self.latest_envelopes.items()
                if bytes(get_working_ballot(env.statement).value)
                == bytes(self.commit.value)
                or nid == self.local_node().node_id]
