"""Curve25519 ECDH for overlay peer auth (reference: src/crypto/Curve25519.{h,cpp}).

The overlay handshake exchanges short-lived X25519 keys (signed by the node's
long-lived Ed25519 identity) and derives directional HMAC-SHA256 session keys
via ECDH → HKDF (reference: overlay/PeerAuth.h:17-48).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

try:
    from cryptography.hazmat.primitives.asymmetric import x25519 as _x
    from cryptography.hazmat.primitives import serialization as _ser
except ImportError:                                  # pragma: no cover
    # gate the OpenSSL backend: fall back to the RFC 7748 ladder below
    _x = None
    _ser = None

from .sha import hkdf_extract, hkdf_expand

# ------------------------------------------------- RFC 7748 fallback --
_P = 2 ** 255 - 19
_A24 = 121665


def _x25519(k: bytes, u: bytes) -> bytes:
    """X25519 scalar multiplication (RFC 7748 §5): the pure-python
    Montgomery ladder used when the OpenSSL backend is unavailable."""
    sk = bytearray(k)
    sk[0] &= 248
    sk[31] &= 127
    sk[31] |= 64
    scalar = int.from_bytes(bytes(sk), "little")
    x1 = int.from_bytes(u, "little") & ((1 << 255) - 1)
    x2, z2, x3, z3 = 1, 0, x1, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (scalar >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = z3 * z3 % _P
        z3 = z3 * x1 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = x2 * pow(z2, _P - 2, _P) % _P
    return out.to_bytes(32, "little")


@dataclass(frozen=True)
class Curve25519Public:
    key: bytes  # 32 bytes


class Curve25519Secret:
    __slots__ = ("key", "_priv")

    def __init__(self, raw32: bytes):
        assert len(raw32) == 32
        self.key = bytes(raw32)
        self._priv = (_x.X25519PrivateKey.from_private_bytes(self.key)
                      if _x is not None else None)

    @classmethod
    def random(cls) -> "Curve25519Secret":
        return cls(os.urandom(32))

    def derive_public(self) -> Curve25519Public:
        if self._priv is None:
            return Curve25519Public(
                _x25519(self.key, (9).to_bytes(32, "little")))
        pub = self._priv.public_key().public_bytes(
            _ser.Encoding.Raw, _ser.PublicFormat.Raw)
        return Curve25519Public(pub)

    def ecdh(self, remote: Curve25519Public, local_first: bool) -> bytes:
        """Shared key = HKDF-Extract(q ‖ publicA ‖ publicB) per the reference
        (crypto/Curve25519.cpp curve25519DeriveSharedKey); ordering is fixed
        by the caller's role so both sides derive the same bytes."""
        if self._priv is None:
            q = _x25519(self.key, remote.key)
        else:
            q = self._priv.exchange(
                _x.X25519PublicKey.from_public_bytes(remote.key))
        mine = self.derive_public().key
        ab = (mine + remote.key) if local_first else (remote.key + mine)
        return hkdf_extract(q + ab)


def expand_session_key(shared: bytes, info: bytes) -> bytes:
    """Directional session key (reference: PeerAuth HKDF-Expand usage)."""
    return hkdf_expand(shared, info, 32)
