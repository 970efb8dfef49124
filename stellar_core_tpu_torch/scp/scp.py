"""SCP facade: the per-node consensus object owning all slots.

Reference: src/scp/SCP.{h,cpp}: receiveEnvelope routes to the slot,
nominate starts a round, purgeSlots garbage-collects old rounds.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..xdr.scp import SCPEnvelope, SCPQuorumSet
from .driver import EnvelopeState, SCPDriver
from .local_node import LocalNode
from .slot import Slot


class SCP:
    def __init__(self, driver: SCPDriver, node_id_raw: bytes,
                 is_validator: bool, qset: SCPQuorumSet):
        self.driver = driver
        self.local_node = LocalNode(node_id_raw, is_validator, qset)
        self.known_slots: Dict[int, Slot] = {}

    # ------------------------------------------------------------- slots --
    def get_slot(self, slot_index: int, create: bool = True
                 ) -> Optional[Slot]:
        slot = self.known_slots.get(slot_index)
        if slot is None and create:
            slot = Slot(slot_index, self)
            self.known_slots[slot_index] = slot
        return slot

    def purge_slots(self, max_slot_index: int,
                    slot_to_keep: Optional[int] = None) -> None:
        """Drop slots below max_slot_index, optionally keeping one
        (reference: SCP::purgeSlots with GHOST slot)."""
        for idx in [i for i in self.known_slots
                    if i < max_slot_index and i != slot_to_keep]:
            del self.known_slots[idx]

    # ----------------------------------------------------------- protocol --
    def receive_envelope(self, envelope: SCPEnvelope) -> EnvelopeState:
        """Called with an envelope whose signature the application already
        verified (reference: SCP::receiveEnvelope)."""
        slot_index = envelope.statement.slotIndex
        return self.get_slot(slot_index).process_envelope(envelope)

    def nominate(self, slot_index: int, value: bytes,
                 previous_value: bytes) -> bool:
        assert self.local_node.is_validator
        return self.get_slot(slot_index).nominate(value, previous_value)

    def stop_nomination(self, slot_index: int) -> None:
        slot = self.get_slot(slot_index, create=False)
        if slot is not None:
            slot.stop_nomination()

    # --------------------------------------------------------- inspection --
    def get_latest_messages_send(self, slot_index: int) -> List[SCPEnvelope]:
        slot = self.get_slot(slot_index, create=False)
        return slot.get_latest_messages_send() if slot else []

    def get_latest_message(self, node: bytes) -> Optional[SCPEnvelope]:
        for idx in sorted(self.known_slots, reverse=True):
            env = self.known_slots[idx].get_latest_message(node)
            if env is not None:
                return env
        return None

    def get_current_state(self, slot_index: int) -> List[SCPEnvelope]:
        slot = self.get_slot(slot_index, create=False)
        return slot.get_current_state() if slot else []

    def get_externalizing_state(self, slot_index: int) -> List[SCPEnvelope]:
        slot = self.get_slot(slot_index, create=False)
        return slot.get_externalizing_state() if slot else []

    def is_slot_fully_validated(self, slot_index: int) -> bool:
        slot = self.get_slot(slot_index, create=False)
        return slot.is_fully_validated() if slot else False

    def empty_slots(self) -> bool:
        return not self.known_slots
