"""Fetch-tracking for SCP envelopes and their referenced artifacts.

Reference: src/herder/PendingEnvelopes.{h,cpp} — an SCP envelope can only
be fed to SCP once every tx set and quorum set its statement references
is locally available; until then it sits in a fetching queue and the
overlay's ItemFetchers anycast GET_TX_SET / GET_SCP_QUORUMSET requests.
The fetch transport is injected (`request_txset` / `request_qset`
callables) so tests and the in-process simulation can satisfy fetches
synchronously.
"""

from __future__ import annotations

from enum import Enum
from typing import Callable, Dict, List, Optional, Set

from ..crypto.sha import sha256
from ..scp import local_node as ln
from ..util.logging import get_logger
from ..xdr.ledger import StellarValue
from ..xdr.scp import SCPEnvelope, SCPQuorumSet, SCPStatementType

log = get_logger("Herder")

# reference: Herder.h MAX_SLOTS_TO_REMEMBER
MAX_SLOTS_TO_REMEMBER = 12


class RecvState(Enum):
    # reference: Herder::EnvelopeStatus
    ENVELOPE_STATUS_DISCARDED = 0
    ENVELOPE_STATUS_FETCHING = 1
    ENVELOPE_STATUS_READY = 2
    ENVELOPE_STATUS_PROCESSED = 3


def _statement_txset_hashes(st) -> Set[bytes]:
    """Every txSetHash referenced by the statement's StellarValues
    (reference: getTxSetHashes/getStellarValues)."""
    values: List[bytes] = []
    t = st.pledges.disc
    pl = st.pledges.value
    if t == SCPStatementType.SCP_ST_NOMINATE:
        values.extend(bytes(v) for v in pl.votes)
        values.extend(bytes(v) for v in pl.accepted)
    elif t == SCPStatementType.SCP_ST_PREPARE:
        if pl.ballot.counter != 0:
            values.append(bytes(pl.ballot.value))
        if pl.prepared is not None:
            values.append(bytes(pl.prepared.value))
        if pl.preparedPrime is not None:
            values.append(bytes(pl.preparedPrime.value))
    elif t == SCPStatementType.SCP_ST_CONFIRM:
        values.append(bytes(pl.ballot.value))
    else:
        values.append(bytes(pl.commit.value))
    out = set()
    for raw in values:
        try:
            sv = StellarValue.from_bytes(raw)
        except Exception:
            continue
        out.add(bytes(sv.txSetHash))
    return out


def _statement_qset_hash(st) -> Optional[bytes]:
    t = st.pledges.disc
    if t == SCPStatementType.SCP_ST_EXTERNALIZE:
        return None  # externalize acts as its own singleton qset
    return bytes(st.pledges.value.quorumSetHash)


class PendingEnvelopes:
    def __init__(self, network_id: bytes,
                 request_txset: Optional[Callable[[bytes], None]] = None,
                 request_qset: Optional[Callable[[bytes], None]] = None):
        self.network_id = network_id
        self._txsets: Dict[bytes, object] = {}     # hash -> TxSetFrame
        self._qsets: Dict[bytes, SCPQuorumSet] = {}
        self._fetching: Dict[int, List[SCPEnvelope]] = {}
        self._ready: Dict[int, List[SCPEnvelope]] = {}
        self._processed: Dict[int, Set[bytes]] = {}
        self._discarded: Dict[int, Set[bytes]] = {}
        self.request_txset = request_txset or (lambda h: None)
        self.request_qset = request_qset or (lambda h: None)

    # ------------------------------------------------------------- caches --
    def add_tx_set(self, tx_set_hash: bytes, tx_set) -> None:
        self._txsets[tx_set_hash] = tx_set
        self._recheck_fetching()

    def add_scp_quorum_set(self, qset_hash: bytes,
                           qset: SCPQuorumSet) -> None:
        self._qsets[qset_hash] = qset
        self._recheck_fetching()

    def get_tx_set(self, tx_set_hash: bytes):
        return self._txsets.get(tx_set_hash)

    def get_qset(self, qset_hash: bytes) -> Optional[SCPQuorumSet]:
        return self._qsets.get(qset_hash)

    def put_local_qset(self, qset: SCPQuorumSet) -> None:
        self._qsets[ln.qset_hash(qset)] = qset

    # -------------------------------------------------------------- state --
    def _missing_for(self, env: SCPEnvelope) -> Set[bytes]:
        st = env.statement
        missing = {h for h in _statement_txset_hashes(st)
                   if h not in self._txsets}
        qh = _statement_qset_hash(st)
        if qh is not None and qh not in self._qsets:
            missing.add(qh)
        return missing

    def recv_scp_envelope(self, env: SCPEnvelope) -> RecvState:
        """Classify an incoming envelope (reference:
        PendingEnvelopes::recvSCPEnvelope)."""
        slot = env.statement.slotIndex
        eh = sha256(env.to_bytes())
        if eh in self._discarded.get(slot, set()):
            return RecvState.ENVELOPE_STATUS_DISCARDED
        if eh in self._processed.get(slot, set()):
            return RecvState.ENVELOPE_STATUS_PROCESSED
        missing = self._missing_for(env)
        if not missing:
            self._ready.setdefault(slot, []).append(env)
            self._processed.setdefault(slot, set()).add(eh)
            return RecvState.ENVELOPE_STATUS_READY
        st = env.statement
        qh = _statement_qset_hash(st)
        for h in missing:
            if h == qh:
                self.request_qset(h)
            else:
                self.request_txset(h)
        self._fetching.setdefault(slot, []).append(env)
        return RecvState.ENVELOPE_STATUS_FETCHING

    def _recheck_fetching(self) -> None:
        for slot, envs in list(self._fetching.items()):
            still = []
            for env in envs:
                if not self._missing_for(env):
                    eh = sha256(env.to_bytes())
                    if eh not in self._processed.get(slot, set()):
                        self._ready.setdefault(slot, []).append(env)
                        self._processed.setdefault(slot, set()).add(eh)
                else:
                    still.append(env)
            if still:
                self._fetching[slot] = still
            else:
                self._fetching.pop(slot, None)

    def pop_ready(self, slot: int) -> List[SCPEnvelope]:
        return self._ready.pop(slot, [])

    def has_ready(self) -> bool:
        return any(self._ready.values())

    def ready_slots(self) -> List[int]:
        return sorted(self._ready)

    # ---------------------------------------------------------------- gc --
    def slot_closed(self, closed_slot: int,
                    max_slots: int = MAX_SLOTS_TO_REMEMBER) -> None:
        """Drop state for slots too old to matter (reference:
        eraseBelow via MAX_SLOTS_TO_REMEMBER; the herder passes its
        configured window)."""
        low = closed_slot - max_slots + 1
        for d in (self._fetching, self._ready, self._processed,
                  self._discarded):
            for s in [s for s in d if s < low]:
                del d[s]

    def discard_slot(self, slot: int) -> None:
        self._fetching.pop(slot, None)
        self._ready.pop(slot, None)
