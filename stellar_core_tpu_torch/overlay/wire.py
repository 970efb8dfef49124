"""Serialize-once wire path.

A broadcast used to re-encode the same `StellarMessage` body for every
consumer on the path: once for the floodgate hash, once inside each
peer's HMAC, once inside each peer's `AuthenticatedMessage.to_bytes()`,
and up to three more times per peer inside flow control's
`msg_body_size` — ~25 encodings of one body for an 8-peer fan-out.
The reference pays the same tax (`xdr::msg_to_bytes` per peer inside
`Peer::sendAuthenticatedMessage`); the Clipper lesson already applied
to the verify path (amortize a fixed cost across the batch) applies
verbatim here: the body bytes are identical for every peer, only the
~40 bytes of per-peer sequence + MAC differ.

This module owns the canonical-bytes cache and the frame splice:

- `body_bytes(msg)` returns the canonical XDR encoding of a
  `StellarMessage`, computed at most once per message object and
  cached on the instance (`_wire_body`). Messages on the wire path
  are immutable by convention — they are constructed, flooded, and
  dropped; nothing mutates a message after it has been handed to
  `send_message`/`broadcast_message` (mutating one AFTER a send would
  desynchronize cache and object, which is why the cache lives here,
  at the wire boundary, and not inside `Union.to_bytes`).
- `seed_body(msg, body)` installs the received wire slice as the
  cache on a PARSED message, so the recv→rebroadcast path (SCP
  gossip) never re-encodes either — and the flood hash is computed
  over the bytes actually on the wire, exactly like the reference
  hashing the received xdr blob.
- `flood_hash(msg)` is the floodgate/propagation key, sha256 over the
  cached body (cached itself as `_wire_hash`).
- `assemble_frame(seq, body, mac)` splices the per-peer sequence and
  MAC around the shared body — byte-identical to
  `AuthenticatedMessage(0, _AuthenticatedMessageV0(...)).to_bytes()`
  (pinned by tests/test_wire_path.py frame-parity tests), so
  cross-version peers interoperate: nothing about the wire format
  changes, only how many times we pay to produce it.

Cache-efficiency evidence rides the `overlay.encode.{cache_hit,
cache_miss}` counters (metrics route + Prometheus): pass the
`(hit, miss)` counter pair a caller holds (OverlayManager owns the
shared pair) and one broadcast to N peers shows exactly one miss.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

from ..crypto.sha import sha256
from ..xdr.overlay import StellarMessage

# AuthenticatedMessage union discriminant 0 (the only arm) — the
# 4-byte prefix every frame starts with
FRAME_PREFIX = b"\x00\x00\x00\x00"
MAC_LEN = 32
# prefix(4) + sequence(8); the MAC'd region of a frame is everything
# from the sequence to the end of the body: frame[4:-MAC_LEN]
BODY_OFFSET = 12


def body_bytes(msg: StellarMessage,
               counters: Optional[Tuple] = None) -> bytes:
    """Canonical XDR bytes of `msg`, encoded at most once per object.
    `counters` is an optional `(hit_counter, miss_counter)` pair."""
    b = msg.__dict__.get("_wire_body")
    if b is not None:
        if counters is not None:
            counters[0].inc()
        return b
    b = msg.to_bytes()
    msg.__dict__["_wire_body"] = b
    if counters is not None:
        counters[1].inc()
    return b


def seed_body(msg: StellarMessage, body: bytes) -> None:
    """Install the received wire slice as `msg`'s canonical bytes —
    the recv side serialized nothing, so this is neither a cache hit
    nor a miss; it makes every downstream consumer (flood hash,
    flow-control sizing, rebroadcast framing) a hit."""
    if "_wire_body" not in msg.__dict__:
        msg.__dict__["_wire_body"] = body


def flood_hash(msg: StellarMessage,
               counters: Optional[Tuple] = None) -> bytes:
    """Floodgate/propagation key: sha256 over the canonical body,
    computed (and cached) once per message object."""
    h = msg.__dict__.get("_wire_hash")
    if h is None:
        h = sha256(body_bytes(msg, counters))
        msg.__dict__["_wire_hash"] = h
    return h


def assemble_frame(seq: int, body: bytes, mac: bytes) -> bytes:
    """Splice per-peer sequence + MAC around the shared body; byte-
    identical to framing through `AuthenticatedMessage.to_bytes()`."""
    return b"".join((FRAME_PREFIX, struct.pack(">Q", seq), body, mac))
