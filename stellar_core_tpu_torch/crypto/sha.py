"""Hashing primitives (reference: src/crypto/SHA.{h,cpp}, BLAKE2.{h,cpp}).

SHA-256 is the canonical object-hash of the protocol (ledger headers, tx
contents hashes, bucket hashes); HMAC-SHA256 + HKDF back the overlay's
per-connection message authentication (crypto/SHA.cpp, overlay/PeerAuth.h).
"""

from __future__ import annotations

import hashlib
import hmac as _hmac


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def sha512(data: bytes) -> bytes:
    return hashlib.sha512(data).digest()


def blake2b_256(data: bytes) -> bytes:
    """BLAKE2b-256 (reference: crypto/BLAKE2.cpp; used for the verify-cache key)."""
    return hashlib.blake2b(data, digest_size=32).digest()


class SHA256:
    """Incremental hasher (reference: SHA256 add/finish, crypto/SHA.h)."""

    def __init__(self):
        self._h = hashlib.sha256()

    def add(self, data: bytes) -> "SHA256":
        self._h.update(data)
        return self

    def finish(self) -> bytes:
        return self._h.digest()


def hmac_sha256(key: bytes, data: bytes) -> bytes:
    return _hmac.new(key, data, hashlib.sha256).digest()


def hmac_sha256_verify(key: bytes, data: bytes, mac: bytes) -> bool:
    return _hmac.compare_digest(hmac_sha256(key, data), mac)


def hkdf_extract(ikm: bytes, salt: bytes = b"\x00" * 32) -> bytes:
    """HKDF-Extract with SHA-256 (reference: crypto/SHA.cpp hkdfExtract)."""
    return hmac_sha256(salt, ikm)


def hkdf_expand(prk: bytes, info: bytes, length: int = 32) -> bytes:
    """HKDF-Expand with SHA-256 (RFC 5869; reference: SHA.cpp hkdfExpand)."""
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac_sha256(prk, t + info + bytes([i]))
        out += t
        i += 1
    return out[:length]
