"""Input-log file format: framed, CRC-guarded, torn-tail tolerant.

Layout::

    MAGIC (8 bytes, b"SCTPRL01")
    record*        where record = <u8 type><u32 len><u32 crc32>payload

The CRC covers the payload only. The format is append-only and every
record is flushed as written, so a ``kill -9`` can leave at most one
*torn tail*: a final record whose length field outruns the file or
whose CRC does not match. The loader detects the tear, counts it,
logs it loudly, and returns everything before it — a crashed node's
log still replays up to the tear (docs/REPLAY.md). A tear that is NOT
at EOF is indistinguishable from corruption and is treated the same
way: stop there, loudly.

Record payloads (little-endian):

- ``CONN``    JSON ``{ts, conn, role}`` — a transport established;
  ``conn`` numbers peers in connect order and FRAME records refer to it
- ``FRAME``   ``<d ts><I conn>`` + raw wire frame, verbatim — the exact
  bytes ``Peer.recv_bytes`` saw (serialize-once: no re-encode)
- ``MACFAIL`` ``<I conn>`` — the immediately preceding FRAME on that
  conn failed HMAC verification live; replay (which cannot re-derive
  the ephemeral session MAC keys) must force the same verdict
- ``INJECT``  ``<d ts><u8 via>`` + u32 count + (u32 len + envelope
  bytes)* — an external transaction submission (admin tx route,
  loadgen, a scenario driver), recorded at the submission site. ``via``
  picks the replay admission path: 0 = batched
  ``herder.recv_transactions``, 1 = direct ``herder.recv_transaction``
  (which rolls the controller's surge-shed gate — a different path
  must not replay through the other one)
- ``ADMIN``   JSON ``{ts, cmd, params}`` — a recorded admin command
- ``CHAOS``   JSON ``{ts, point, ordinal, kind, ...}`` — the chaos
  engine injected a fault at this node-local matched-hit ordinal
- ``PDROP``   JSON ``{ts, conn, reason}`` — the peer was dropped
  (protocol drops replay naturally and make this a no-op; driver drops
  like a crashed partner only exist in the log)
- ``END``     JSON ``{ts, reason, lcl_seq, lcl_hash}`` — orderly
  finish marker; absent after a hard kill (that is the torn tail)
- ``TICK``    ``<d ts><u8 phase>`` — a crank phase boundary of the
  node's VirtualClock (phase values = ``util.timer.CRANK_*``). These
  carry the clock-advance and timer-firing order: many inputs share
  one virtual instant (the whole t=0 handshake-and-first-close storm),
  and only the phase sequence says whether a timer fired before or
  after a given input arrived. Records between START and DISPATCH
  happened in that crank's action/poller window; records between END
  and the next START came from a driver running between cranks
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import List, Optional

from ..util.logging import get_logger

log = get_logger("Replay")

MAGIC = b"SCTPRL01"

# The header rides as record type 0 so the frame walker needs no
# special case; it is always the first record.
RT_HEADER = 0
RT_CONN = 1
RT_FRAME = 2
RT_MACFAIL = 3
RT_INJECT = 4
RT_ADMIN = 5
RT_CHAOS = 6
RT_PDROP = 7
RT_END = 8
RT_TICK = 9

# TICK phase wire values — same numbers as util.timer.CRANK_* (the
# recorder writes the hook's phase argument verbatim)
TICK_START = 0
TICK_DISPATCH = 1
TICK_JUMP = 2
TICK_END = 3

_RECORD_HDR = struct.Struct("<BII")
_FRAME_HDR = struct.Struct("<dI")
_TS = struct.Struct("<d")
_U32 = struct.Struct("<I")
_TICK = struct.Struct("<dB")

_NAMES = {RT_HEADER: "HEADER",
          RT_CONN: "CONN", RT_FRAME: "FRAME", RT_MACFAIL: "MACFAIL",
          RT_INJECT: "INJECT", RT_ADMIN: "ADMIN", RT_CHAOS: "CHAOS",
          RT_PDROP: "PDROP", RT_END: "END", RT_TICK: "TICK"}


class LogRecord:
    """One parsed record. ``doc`` holds the JSON payload for JSON
    record types; ``ts``/``conn``/``data``/``frames`` are decoded for
    the binary ones."""

    __slots__ = ("rtype", "ts", "conn", "data", "frames", "doc",
                 "mac_invalid", "phase")

    def __init__(self, rtype: int, ts: float = 0.0, conn: int = 0,
                 data: bytes = b"", frames: Optional[list] = None,
                 doc: Optional[dict] = None, phase: int = 0):
        self.rtype = rtype
        self.ts = ts
        self.conn = conn
        self.data = data
        self.frames = frames
        self.doc = doc
        self.phase = phase
        # set by the loader when a MACFAIL record follows this FRAME
        self.mac_invalid = False

    @property
    def name(self) -> str:
        return _NAMES.get(self.rtype, str(self.rtype))

    def __repr__(self):
        return f"<LogRecord {self.name} ts={self.ts:.6f} conn={self.conn}>"


def encode_record(rtype: int, payload: bytes) -> bytes:
    return _RECORD_HDR.pack(rtype, len(payload),
                            zlib.crc32(payload) & 0xFFFFFFFF) + payload


class LogWriter:
    """Streams records to a binary file object (flushed per record, so
    a kill leaves at most a torn tail) or buffers them in memory when
    constructed without a stream."""

    def __init__(self, stream=None):
        self._stream = stream
        self._chunks: List[bytes] = []
        self.records = 0
        self.bytes = len(MAGIC)
        if stream is not None:
            stream.write(MAGIC)
            stream.flush()
        else:
            self._chunks.append(MAGIC)

    def write(self, rtype: int, payload: bytes) -> None:
        raw = encode_record(rtype, payload)
        if self._stream is not None:
            self._stream.write(raw)
            self._stream.flush()
        else:
            self._chunks.append(raw)
        self.records += 1
        self.bytes += len(raw)

    def write_json(self, rtype: int, doc: dict) -> None:
        self.write(rtype, json.dumps(doc, sort_keys=True).encode())

    def to_bytes(self) -> bytes:
        if self._stream is not None:
            raise ValueError("LogWriter is file-backed; read the file")
        return b"".join(self._chunks)

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None


class InputLog:
    """A parsed input log: header doc + record list + tear accounting."""

    def __init__(self, header: dict, records: List[LogRecord],
                 torn_tail: int = 0, torn_bytes: int = 0):
        self.header = header
        self.records = records
        # count of records lost to a torn/corrupt tail (0 or 1 for a
        # clean kill; >1 only if garbage follows the tear)
        self.torn_tail = torn_tail
        self.torn_bytes = torn_bytes

    @property
    def node(self) -> str:
        return self.header.get("node", "")

    def frames(self) -> List[LogRecord]:
        return [r for r in self.records if r.rtype == RT_FRAME]

    def end_record(self) -> Optional[LogRecord]:
        for r in reversed(self.records):
            if r.rtype == RT_END:
                return r
        return None

    @classmethod
    def from_bytes(cls, data: bytes) -> "InputLog":
        if data[:len(MAGIC)] != MAGIC:
            raise ValueError("not an input log (bad magic)")
        pos = len(MAGIC)
        records: List[LogRecord] = []
        torn = 0
        torn_bytes = 0
        while pos < len(data):
            if pos + _RECORD_HDR.size > len(data):
                torn, torn_bytes = 1, len(data) - pos
                break
            rtype, length, crc = _RECORD_HDR.unpack_from(data, pos)
            body_at = pos + _RECORD_HDR.size
            if body_at + length > len(data):
                torn, torn_bytes = 1, len(data) - pos
                break
            payload = data[body_at:body_at + length]
            if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
                # CRC mismatch: a torn record whose length bytes were
                # already on disk, or mid-file corruption — either way
                # nothing after this point is trustworthy
                torn, torn_bytes = 1, len(data) - pos
                break
            records.append(_decode(rtype, payload))
            pos = body_at + length
        if torn:
            log.warning(
                "input log torn tail: %d undecodable byte(s) dropped "
                "after %d good record(s) — replaying up to the tear",
                torn_bytes, len(records))
        if not records or records[0].rtype != RT_HEADER:
            raise ValueError("input log has no header record")
        header = records.pop(0).doc or {}
        _mark_mac_failures(records)
        return cls(header, records, torn_tail=torn, torn_bytes=torn_bytes)

    @classmethod
    def load(cls, path: str) -> "InputLog":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())


def _decode(rtype: int, payload: bytes) -> LogRecord:
    if rtype == RT_FRAME:
        ts, conn = _FRAME_HDR.unpack_from(payload)
        return LogRecord(RT_FRAME, ts=ts, conn=conn,
                         data=payload[_FRAME_HDR.size:])
    if rtype == RT_MACFAIL:
        (conn,) = _U32.unpack_from(payload)
        return LogRecord(RT_MACFAIL, conn=conn)
    if rtype == RT_TICK:
        ts, phase = _TICK.unpack_from(payload)
        return LogRecord(RT_TICK, ts=ts, phase=phase)
    if rtype == RT_INJECT:
        (ts,) = _TS.unpack_from(payload)
        pos = _TS.size
        via = payload[pos]
        pos += 1
        (count,) = _U32.unpack_from(payload, pos)
        pos += _U32.size
        frames = []
        for _ in range(count):
            (n,) = _U32.unpack_from(payload, pos)
            pos += _U32.size
            frames.append(payload[pos:pos + n])
            pos += n
        rec = LogRecord(RT_INJECT, ts=ts, frames=frames)
        rec.doc = {"via": via}
        return rec
    # JSON records (header, CONN, ADMIN, CHAOS, PDROP, END)
    doc = json.loads(payload)
    rec = LogRecord(rtype, ts=float(doc.get("ts", 0.0)),
                    conn=int(doc.get("conn", 0)), doc=doc)
    return rec


def _mark_mac_failures(records: List[LogRecord]) -> None:
    """Fold MACFAIL markers onto the FRAME they qualify: the recorder
    writes MACFAIL immediately after the frame whose HMAC check failed
    live, so replay can force the same drop without the session keys."""
    last_frame: dict = {}
    for r in records:
        if r.rtype == RT_FRAME:
            last_frame[r.conn] = r
        elif r.rtype == RT_MACFAIL:
            f = last_frame.get(r.conn)
            if f is not None:
                f.mac_invalid = True


def encode_frame_payload(ts: float, conn: int, raw: bytes) -> bytes:
    return _FRAME_HDR.pack(ts, conn) + raw


def encode_tick_payload(ts: float, phase: int) -> bytes:
    return _TICK.pack(ts, phase)


def encode_inject_payload(ts: float, frames: List[bytes],
                          via: int = 0) -> bytes:
    parts = [_TS.pack(ts), bytes([via]), _U32.pack(len(frames))]
    for raw in frames:
        parts.append(_U32.pack(len(raw)))
        parts.append(raw)
    return b"".join(parts)
