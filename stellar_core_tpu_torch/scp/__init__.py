"""Federated consensus kernel (reference: src/scp — deliberately
freestanding: depends only on the XDR types and util; the application
binds it through SCPDriver)."""

from .driver import EnvelopeState, SCPDriver, ValidationLevel
from .local_node import LocalNode
from .scp import SCP
from .slot import Slot

__all__ = ["SCP", "SCPDriver", "Slot", "LocalNode", "EnvelopeState",
           "ValidationLevel"]
