"""P2P overlay (reference: src/overlay — SURVEY.md §1 layer 8)."""

from .loopback import LoopbackPeer, LoopbackPeerConnection
from .manager import OverlayManager
from .peer import Peer, PeerState
from .peer_auth import PeerAuth, PeerRole

__all__ = ["OverlayManager", "Peer", "PeerState", "PeerAuth", "PeerRole",
           "LoopbackPeer", "LoopbackPeerConnection"]
