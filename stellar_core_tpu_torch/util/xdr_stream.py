"""Record-marked XDR file streams.

Reference: util/XDRStream.h — bucket files and history checkpoint files
are sequences of XDR records with RFC 5531 record marking: a 4-byte
big-endian length word with the high bit set (single-fragment records),
followed by the XDR payload.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, Type


def write_record(f: BinaryIO, payload: bytes) -> None:
    f.write(struct.pack(">I", len(payload) | 0x80000000))
    f.write(payload)


def read_record(f: BinaryIO) -> bytes | None:
    hdr = f.read(4)
    if len(hdr) == 0:
        return None
    if len(hdr) != 4:
        raise IOError("truncated XDR record header")
    (word,) = struct.unpack(">I", hdr)
    if not word & 0x80000000:
        raise IOError("multi-fragment XDR records not supported")
    n = word & 0x7FFFFFFF
    payload = f.read(n)
    if len(payload) != n:
        raise IOError("truncated XDR record payload")
    return payload


def read_all(f: BinaryIO, cls: Type) -> Iterator:
    while True:
        raw = read_record(f)
        if raw is None:
            return
        yield cls.from_bytes(raw)
