"""ShortHash — SipHash-2-4 for hashtable seeds (reference: src/crypto/ShortHash.cpp:78).

The reference seeds a process-global SipHash key at startup from the CSPRNG,
with a deterministic re-seed hook for fuzzing (crypto/ShortHash.h). Used for
non-cryptographic hashing (BucketList shadow maps, unordered containers).
"""

from __future__ import annotations

import os
import struct

_MASK = 0xFFFFFFFFFFFFFFFF


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & _MASK


def siphash24(key16: bytes, data: bytes) -> int:
    """SipHash-2-4 returning a 64-bit int."""
    assert len(key16) == 16
    k0, k1 = struct.unpack("<QQ", key16)
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573

    def rounds(n):
        nonlocal v0, v1, v2, v3
        for _ in range(n):
            v0 = (v0 + v1) & _MASK
            v1 = _rotl(v1, 13) ^ v0
            v0 = _rotl(v0, 32)
            v2 = (v2 + v3) & _MASK
            v3 = _rotl(v3, 16) ^ v2
            v0 = (v0 + v3) & _MASK
            v3 = _rotl(v3, 21) ^ v0
            v2 = (v2 + v1) & _MASK
            v1 = _rotl(v1, 17) ^ v2
            v2 = _rotl(v2, 32)

    b = len(data) << 56
    i = 0
    while i + 8 <= len(data):
        m = struct.unpack_from("<Q", data, i)[0]
        v3 ^= m
        rounds(2)
        v0 ^= m
        i += 8
    tail = data[i:]
    m = b | int.from_bytes(tail, "little")
    v3 ^= m
    rounds(2)
    v0 ^= m
    v2 ^= 0xFF
    rounds(4)
    return (v0 ^ v1 ^ v2 ^ v3) & _MASK


_seed: bytes = os.urandom(16)


def initialize() -> None:
    global _seed
    _seed = os.urandom(16)


def seed_for_testing(key16: bytes) -> None:
    """Deterministic seed (reference: shortHash::seed for fuzzing)."""
    global _seed
    assert len(key16) == 16
    _seed = key16


def compute_hash(data: bytes) -> int:
    return siphash24(_seed, data)
