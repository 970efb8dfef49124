"""Ed25519 keys for the port: the subset the verifier and its tests use.

Counterpart of stellar_core_tpu/crypto/keys.py. Signing and single
verification both go through the strict oracle (`ed25519_ref`): RFC 8032
signing is deterministic, so the signatures are byte-identical to the
OpenSSL or native signers of the JAX package. The port has no native
library yet, so `verify_sig_uncached` is the oracle too.
"""

from __future__ import annotations

import hashlib

from . import ed25519_ref


class PublicKey:
    """32-byte Ed25519 public key."""

    __slots__ = ("raw",)

    def __init__(self, raw: bytes):
        if len(raw) != 32:
            raise ValueError("public key must be 32 bytes")
        self.raw = bytes(raw)

    def __eq__(self, other) -> bool:
        return isinstance(other, PublicKey) and self.raw == other.raw

    def __hash__(self) -> int:
        return hash(self.raw)


class SecretKey:
    """Ed25519 secret key in seed form."""

    __slots__ = ("seed", "_pub")

    def __init__(self, seed: bytes):
        if len(seed) != 32:
            raise ValueError("seed must be 32 bytes")
        self.seed = bytes(seed)
        self._pub = PublicKey(ed25519_ref.secret_to_public(self.seed))

    @classmethod
    def pseudo_random_for_testing(cls, n: int) -> "SecretKey":
        """Deterministic test keys, the same seeds as the JAX package's."""
        return cls(hashlib.sha256(b"test-key-%d" % n).digest())

    def public_key(self) -> PublicKey:
        return self._pub

    def sign(self, msg: bytes) -> bytes:
        return ed25519_ref.sign(self.seed, msg)

    def __repr__(self) -> str:
        return "SecretKey(<hidden>)"


def verify_sig_uncached(pub: bytes, sig: bytes, msg: bytes) -> bool:
    """Strict single-signature verify (the small-batch bypass path)."""
    return ed25519_ref.verify(pub, sig, msg)
