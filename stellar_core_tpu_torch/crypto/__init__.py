"""Crypto layer (reference: src/crypto — SURVEY.md layer 2).

This is the abstraction the device backend slots behind: `PubKeyUtils.verify_sig`
is the single-signature seam (reference: crypto/SecretKey.h:127), and
`BatchVerifier` (crypto/batch.py) is the batch seam feeding the device kernel.

Verification semantics — identical across ALL backends ("strict" rules,
matching libsodium's crypto_sign_verify_detached as described in
crypto/SecretKey.cpp:427-460):
  * reject non-canonical scalar S (S >= L)
  * reject non-canonical point encodings (y >= p, and -0)
  * reject small-order A and R (order dividing 8)
  * cofactorless equation [S]B == R + [k]A with k = SHA512(R‖A‖M) mod L
"""

from .keys import PublicKey, SecretKey, PubKeyUtils
from .sha import sha256, sha512, hmac_sha256, hkdf_extract, hkdf_expand
from .strkey import StrKey

__all__ = [
    "PublicKey", "SecretKey", "PubKeyUtils",
    "sha256", "sha512", "hmac_sha256", "hkdf_extract", "hkdf_expand",
    "StrKey",
]
