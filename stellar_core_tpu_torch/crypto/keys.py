"""Keys and signature verification — the backend seam.

Counterpart of stellar_core_tpu/crypto/keys.py (reference:
src/crypto/SecretKey.{h,cpp}). `PubKeyUtils.verify_sig` is the
single-signature hot path (SecretKey.cpp:427-460) with the global
RandomEvictionCache of 0xffff entries keyed by BLAKE2(key‖sig‖msg)
(SecretKey.cpp:37-60).

Verification, signing and key derivation use the host C++ library
(native/, built with g++ at first use) and fall back to the strict
oracle (`ed25519_ref`) when it cannot be built. The JAX package's
OpenSSL path is not copied: the port does not count on the
`cryptography` package. RFC 8032 signing is deterministic, so the
signatures are byte-identical to the JAX package's whichever signer
runs; both verifiers agree with ed25519_ref.verify on every input
(tests/test_torch_native.py).
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

from . import ed25519_ref
from .sha import blake2b_256
from ..util.cache import RandomEvictionCache

# reference: crypto/SecretKey.cpp:44 — 0xffff entries
VERIFY_CACHE_SIZE = 0xFFFF
_verify_cache: RandomEvictionCache = RandomEvictionCache(VERIFY_CACHE_SIZE)


def flush_verify_cache_counts() -> tuple:
    """Return (hits, misses) and reset (reference: SecretKey.cpp:324-331)."""
    h, m = _verify_cache.hits, _verify_cache.misses
    _verify_cache.reset_counters()
    return h, m


def clear_verify_cache() -> None:
    _verify_cache.clear()


def verify_cache_key(pub: bytes, sig: bytes, msg: bytes) -> bytes:
    """The cache key verify_sig uses (reference: SecretKey.cpp:37-60) —
    exposed so batch front-ends share one derivation."""
    return blake2b_256(pub + sig + msg)


def probe_verify_cache(pub: bytes, sig: bytes,
                       msg: bytes) -> Optional[bool]:
    """Counting cache probe for batch front-ends: same key derivation
    and hit/miss accounting as PubKeyUtils.verify_sig's own lookup."""
    return _verify_cache.maybe_get(verify_cache_key(pub, sig, msg))


def seed_verify_cache(pub: bytes, sig: bytes, msg: bytes,
                      ok: bool) -> None:
    """Write a batch-verify result through to the process-wide cache so
    later per-signature verifies of the same tuple hit instead of
    re-verifying."""
    _verify_cache.put(verify_cache_key(pub, sig, msg), bool(ok))


def seed_verify_cache_by_key(key: bytes, ok: bool) -> None:
    """Key-based write-through for callers that already derived the
    key (the verify service derives it once per submit)."""
    _verify_cache.put(key, bool(ok))


def _native_verify() -> Optional[object]:
    """The host C++ strict verifier, if it builds and loads."""
    try:
        from ..native import loader
        return loader.get_lib()
    except Exception:
        return None


def host_verifier() -> str:
    """Which host verifier serves verify_sig_uncached (the small-batch
    bypass and every native fallback): "native" or "oracle"."""
    return "native" if _native_verify() is not None else "oracle"


class PublicKey:
    """32-byte Ed25519 public key (reference: PublicKey XDR union, one arm)."""

    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("public key must be 32 bytes")
        self.raw = bytes(raw)

    def hint(self) -> bytes:
        """Last 4 bytes — the SignatureHint prefilter used before any crypto
        (reference: SignatureUtils::getHint, transactions/SignatureUtils.cpp)."""
        return self.raw[28:]

    def __eq__(self, other) -> bool:
        return isinstance(other, PublicKey) and self.raw == other.raw

    def __hash__(self) -> int:
        return hash(self.raw)

    def __repr__(self) -> str:
        return f"PublicKey({self.raw.hex()})"


class SecretKey:
    """Ed25519 secret key (seed form), reference: crypto/SecretKey.h:22."""

    __slots__ = ("seed", "_pub")

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self.seed = bytes(seed)
        lib = _native_verify()
        pub = lib.public_from_seed(self.seed) if lib is not None \
            else ed25519_ref.secret_to_public(self.seed)
        self._pub = PublicKey(pub)

    @classmethod
    def random(cls) -> "SecretKey":
        return cls(os.urandom(32))

    @classmethod
    def from_seed(cls, seed: bytes) -> "SecretKey":
        return cls(seed)

    @classmethod
    def pseudo_random_for_testing(cls, n: int) -> "SecretKey":
        """Deterministic test keys, the same seeds as the JAX package's
        (reference: SecretKey::pseudoRandomForTesting)."""
        return cls(hashlib.sha256(b"test-key-%d" % n).digest())

    def public_key(self) -> PublicKey:
        return self._pub

    def sign(self, msg: bytes) -> bytes:
        lib = _native_verify()
        if lib is not None:
            return lib.sign(self.seed, self._pub.raw, msg)
        return ed25519_ref.sign(self.seed, msg)

    def __repr__(self) -> str:
        return "SecretKey(<hidden>)"


class PubKeyUtils:
    """Static verify helpers (reference: PubKeyUtils, crypto/SecretKey.h:127)."""

    @staticmethod
    def verify_sig(pub: PublicKey | bytes, sig: bytes, msg: bytes,
                   use_cache: bool = True) -> bool:
        raw = pub.raw if isinstance(pub, PublicKey) else pub
        if len(raw) != 32 or len(sig) != 64:
            return False
        if use_cache:
            key = blake2b_256(raw + sig + msg)
            hit = _verify_cache.maybe_get(key)
            if hit is not None:
                return hit
        ok = verify_sig_uncached(raw, sig, msg)
        if use_cache:
            _verify_cache.put(key, ok)
        return ok


def verify_sig_uncached(pub: bytes, sig: bytes, msg: bytes) -> bool:
    """Strict single-signature verify: the host C++ library, else the
    oracle (the small-batch bypass and the supervisor's fallback)."""
    lib = _native_verify()
    if lib is not None:
        return lib.verify(pub, sig, msg)
    return ed25519_ref.verify(pub, sig, msg)
