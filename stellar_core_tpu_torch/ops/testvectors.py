"""Adversarial Ed25519 vector generation for differential testing.

A copy of stellar_core_tpu/ops/testvectors.py that signs through the
port's oracle-backed keys; RFC 8032 signing is deterministic, so the
tuples are byte-identical to the JAX package's. It feeds the port's CPU
tests and chip_smoke.py.  The classes cover everything the strict verifier's
rejection surface distinguishes (reference semantics:
crypto/SecretKey.cpp verify + libsodium-strict rules; oracle:
crypto/ed25519_ref.py):

  - valid signatures over varied message lengths / reused keys
  - bit-flipped signatures, messages, and public keys
  - S = 0, S = L, S = L + s (non-canonical scalar), S = 2^256-1
  - non-canonical point encodings for A and R (y >= p, all-FF)
  - small-order (8-torsion) A and R, including the identity
  - torsion-defect signatures: A' = A + T8 for valid (A, sig) — the
    cofactorless/cofactored disagreement surface that RLC batch
    verification would get wrong (the reason this framework verifies
    strictly per-signature on device; see ed25519_kernel.py)
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np

from ..crypto import ed25519_ref as ref
from ..crypto.keys import SecretKey

Tuples = List[Tuple[bytes, bytes, bytes]]


def small_order_points() -> list:
    """All 8-torsion point encodings, found by clearing the prime-order
    component of arbitrary points ([L]Q)."""
    seen = {}
    i = 0
    while len(seen) < 8 and i < 4000:
        q = ref.pt_decompress(hashlib.sha256(b"torsion%d" % i).digest(),
                              strict=False)
        i += 1
        if q is None:
            continue
        t = ref.pt_mul(ref.L, q)
        if ref.pt_is_small_order(t):
            seen[ref.pt_compress(t)] = t
    return list(seen.keys())


def make_differential_vectors(n_random: int = 10000,
                              seed: int = 424242) -> Tuples:
    """n_random valid/corrupted tuples plus the full adversarial tail.
    Deterministic in (n_random, seed)."""
    items: Tuples = []
    keys = [SecretKey.pseudo_random_for_testing(seed + i)
            for i in range(64)]

    # --- bulk: valid + corrupted mix -----------------------------------
    for i in range(n_random):
        sk = keys[i % len(keys)]
        ln = (0, 1, 31, 32, 33, 64, 100)[i % 7]
        msg = (hashlib.sha256(b"dv%d-%d" % (seed, i)).digest() * 4)[:ln]
        sig = sk.sign(msg)
        pub = sk.public_key().raw
        k = i % 10
        if k == 7:      # corrupt sig R
            sig = bytes([sig[0] ^ 0x40]) + sig[1:]
        elif k == 8:    # corrupt sig S (low bits: stays canonical)
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        elif k == 9:    # corrupt msg (empty msg: corrupt pub instead)
            if msg:
                msg = bytes([msg[0] ^ 0x80]) + msg[1:]
            else:
                pub = bytes([pub[0] ^ 2]) + pub[1:]
        items.append((pub, sig, msg))

    # --- adversarial tail ----------------------------------------------
    sk = keys[0]
    msg = hashlib.sha256(b"adversarial").digest()
    sig = sk.sign(msg)
    pub = sk.public_key().raw
    R, S = sig[:32], sig[32:]
    s_val = int.from_bytes(S, "little")

    items.append((pub, R + bytes(32), msg))                      # S = 0
    items.append((pub, R + ref.L.to_bytes(32, "little"), msg))   # S = L
    items.append((pub, R + (s_val + ref.L).to_bytes(32, "little"),
                  msg))                                          # S + L
    items.append((pub, R + b"\xff" * 32, msg))                   # S huge

    for enc in ((ref.P + 1).to_bytes(32, "little"),
                (ref.P + 2).to_bytes(32, "little"),
                b"\xff" * 32):                   # non-canonical encodings
        items.append((enc, sig, msg))
        items.append((pub, enc + S, msg))

    for t in small_order_points():              # 8-torsion A and R
        items.append((t, sig, msg))
        items.append((pub, t + S, msg))

    # torsion-defect: A' = A + T for every torsion T; strict cofactorless
    # semantics must treat each deterministically (mostly False, but the
    # oracle decides — the kernel must MATCH it bit-for-bit)
    A = ref.pt_decompress(pub, strict=True)
    for tenc in small_order_points():
        T = ref.pt_decompress(tenc, strict=False)
        items.append((ref.pt_compress(ref.pt_add(A, T)), sig, msg))

    # duplicates (cache/dedup paths must not change results)
    items.append((pub, sig, msg))
    items.append((pub, sig, msg))
    return items


def oracle_results(items: Tuples) -> List[bool]:
    return [ref.verify(p, s, m) for p, s, m in items]


def edge_scalar_lanes() -> dict:
    """16 ladder lanes whose S and k run over 0, 1, L-1 and 2^256-1, each
    against each; lane i has A = (1000 + 7i)B. (n, 32) uint8 rows of
    little-endian bytes under "s", "k", "neg_ax" and "neg_ay" (affine -A),
    "a" (A's encoding) and "r" (2A's); the points A under "points"."""
    edges = (0, 1, ref.L - 1, 2**256 - 1)
    lanes = {key: [] for key in ("s", "k", "neg_ax", "neg_ay", "a", "r")}
    points = []
    for i, (sv, kv) in enumerate((a, b) for a in edges for b in edges):
        pt = ref.pt_mul(1000 + 7 * i, ref.BASE)
        x, y, z, _ = ref.pt_neg(pt)
        zi = pow(z, ref.P - 2, ref.P)
        for key, v in (("s", sv), ("k", kv), ("neg_ax", x * zi % ref.P),
                       ("neg_ay", y * zi % ref.P)):
            lanes[key].append(v.to_bytes(32, "little"))
        lanes["a"].append(ref.pt_compress(pt))
        lanes["r"].append(ref.pt_compress(ref.pt_double(pt)))
        points.append(pt)
    out = {key: np.frombuffer(b"".join(v), np.uint8).reshape(-1, 32).copy()
           for key, v in lanes.items()}
    out["points"] = points
    return out
