"""Abstract SCP driver — the callbacks the consensus kernel needs.

Reference: src/scp/SCPDriver.{h,cpp}. SCP itself is freestanding
(scp/readme.md:3-12): everything application-specific — signing, envelope
emission, quorum-set lookup, value validation/combination, timers — comes
through this interface. Envelope *verification* happens upstream (the
herder verifies before feeding SCP, HerderImpl.cpp:761).
"""

from __future__ import annotations

import struct
from enum import IntEnum
from typing import Callable, Iterable, List, Optional, Set

from ..crypto.sha import sha256
from ..xdr.scp import SCPEnvelope, SCPQuorumSet


class ValidationLevel(IntEnum):
    # reference: SCPDriver::ValidationLevel (order matters: min() combines)
    kInvalidValue = 0
    kMaybeValidValue = 1
    kFullyValidatedValue = 2


class EnvelopeState(IntEnum):
    # reference: SCP::EnvelopeState
    INVALID = 0
    VALID = 1


# reference: SCPDriver.cpp hash_N/hash_P/hash_K
HASH_N = 1
HASH_P = 2
HASH_K = 3

MAX_TIMEOUT_SECONDS = 30 * 60


class SCPDriver:
    # ------------------------------------------------------------ required --
    def sign_envelope(self, envelope: SCPEnvelope) -> None:
        raise NotImplementedError

    def emit_envelope(self, envelope: SCPEnvelope) -> None:
        raise NotImplementedError

    def get_qset(self, qset_hash: bytes) -> Optional[SCPQuorumSet]:
        raise NotImplementedError

    def validate_value(self, slot_index: int, value: bytes,
                       nomination: bool) -> ValidationLevel:
        return ValidationLevel.kMaybeValidValue

    def extract_valid_value(self, slot_index: int,
                            value: bytes) -> Optional[bytes]:
        return None

    def combine_candidates(self, slot_index: int,
                           candidates: Set[bytes]) -> Optional[bytes]:
        raise NotImplementedError

    def setup_timer(self, slot_index: int, timer_id: int,
                    timeout_seconds: float,
                    cb: Optional[Callable[[], None]]) -> None:
        raise NotImplementedError

    def stop_timer(self, slot_index: int, timer_id: int) -> None:
        self.setup_timer(slot_index, timer_id, 0, None)

    # ------------------------------------------------------- notifications --
    def slot_activated(self, slot_index: int) -> None:
        """First activity on a slot (its Slot object was just created —
        nomination phase begins, whether this node leads or is only
        hearing envelopes). Drives the per-slot phase timeline the
        herder records (herder/scp_driver.py)."""
        pass

    def value_externalized(self, slot_index: int, value: bytes) -> None:
        pass

    def nominating_value(self, slot_index: int, value: bytes) -> None:
        pass

    def updated_candidate_value(self, slot_index: int, value: bytes) -> None:
        pass

    def started_ballot_protocol(self, slot_index: int, ballot) -> None:
        pass

    def accepted_ballot_prepared(self, slot_index: int, ballot) -> None:
        pass

    def confirmed_ballot_prepared(self, slot_index: int, ballot) -> None:
        pass

    def accepted_commit(self, slot_index: int, ballot) -> None:
        pass

    def ballot_did_hear_from_quorum(self, slot_index: int, ballot) -> None:
        pass

    # ---------------------------------------------------------------- hash --
    def get_hash_of(self, vals: Iterable[bytes]) -> bytes:
        """reference: SCPDriver::getHashOf — Herder implements it as
        SHA256 over the concatenated byte vectors."""
        h = b"".join(vals)
        return sha256(h)

    def _hash_helper(self, slot_index: int, prev: bytes,
                     extra: List[bytes]) -> int:
        vals = [struct.pack(">Q", slot_index),
                _pack_value(prev)] + extra
        digest = self.get_hash_of(vals)
        return int.from_bytes(digest[:8], "big")

    def compute_hash_node(self, slot_index: int, prev: bytes,
                          is_priority: bool, round_number: int,
                          node_id: bytes) -> int:
        return self._hash_helper(slot_index, prev, [
            struct.pack(">I", HASH_P if is_priority else HASH_N),
            struct.pack(">i", round_number), node_id])

    def compute_value_hash(self, slot_index: int, prev: bytes,
                           round_number: int, value: bytes) -> int:
        return self._hash_helper(slot_index, prev, [
            struct.pack(">I", HASH_K),
            struct.pack(">i", round_number), _pack_value(value)])

    def compute_timeout(self, round_number: int) -> float:
        """reference: straight linear timeout, 1s per round, 30min cap."""
        return float(min(round_number, MAX_TIMEOUT_SECONDS))


def _pack_value(v: bytes) -> bytes:
    # XDR VarOpaque framing, as xdr_to_opaque produces in the reference
    pad = (4 - len(v) % 4) % 4
    return struct.pack(">I", len(v)) + v + b"\x00" * pad
