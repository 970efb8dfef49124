"""GF(2^255-19) in ten signed limbs, radix 2^25.5 — the plain version.

Counterpart of stellar_core_tpu/ops/fe8.py. The TPU code used 32 int32
byte limbs because the TPU has no wide multiply; Hopper has 32x32->64
integer multiplies (IMAD.WIDE), so the port uses the ref10 layout: limb i
holds bits OFFSETS[i] .. OFFSETS[i] + WIDTHS[i] (widths 26, 25, 26, ...),
and a product is 100 32x32->64 multiplies plus one carry chain (a
squaring 55: ref10's fe_sq, `sq`).

This module is the plain PyTorch version of csrc/field.cuh, step for
step: the same limbs, the same column sums, the same carry order. A field
element is a tuple of ten limbs; a limb is an int64 tensor of shape (n,)
or a Python int (constants). The kernels store limbs as int32 and form
products in int64; tests/test_torch_field.py walks every op sequence of
both kernels with interval bounds to show that no int64 intermediate
overflows and every stored limb fits int32.

Carry schedule (`carry`): one sequential chain 0 -> 1 -> ... -> 9, the
carry out of limb 9 folded into limb 0 times 19 (2^255 = 19 mod p), then
one more step 0 -> 1. Carries round to nearest (ref10), so carried limbs
are signed and at most 2^(w-1) in magnitude. `add` and `sub` do not
carry; `mul` accepts their outputs directly.
"""

from __future__ import annotations

import numpy as np
import torch

P = 2**255 - 19
WIDTHS = (26, 25, 26, 25, 26, 25, 26, 25, 26, 25)
OFFSETS = (0, 26, 51, 77, 102, 128, 153, 179, 204, 230)


def const(v: int) -> tuple:
    """Python int -> canonical limbs as Python ints (broadcast over n)."""
    v %= P
    return tuple((v >> o) & ((1 << w) - 1) for o, w in zip(OFFSETS, WIDTHS))


ZERO = const(0)
ONE = const(1)
D = const((-121665 * pow(121666, P - 2, P)) % P)
D2 = const(2 * ((-121665 * pow(121666, P - 2, P)) % P))
SQRT_M1 = const(pow(2, (P - 1) // 4, P))

# 8p in limbs: added before canonicalisation so that every limb of a
# signed input (magnitude < 2^28, see the bounds test) becomes >= 0
_BIAS8P = tuple(8 * (((1 << w) - 19) if i == 0 else ((1 << w) - 1))
                for i, w in enumerate(WIDTHS))


def _carry(x, w: int, half: int):
    """(carry, remainder) of x in radix 2^w: carry = (x + half) >> w.
    half = 2^(w-1) rounds to nearest (remainder in [-2^(w-1), 2^(w-1))),
    half = 0 floors (remainder in [0, 2^w))."""
    c = (x + half) >> w
    return c, x - c * (1 << w)


def carry(h) -> tuple:
    """The carry chain after a product (see the module note)."""
    h = list(h)
    for i in range(9):
        w = WIDTHS[i]
        c, h[i] = _carry(h[i], w, 1 << (w - 1))
        h[i + 1] = h[i + 1] + c
    c, h[9] = _carry(h[9], 25, 1 << 24)
    h[0] = h[0] + c * 19
    c, h[0] = _carry(h[0], 26, 1 << 25)
    h[1] = h[1] + c
    return tuple(h)


def add(a, b) -> tuple:
    return tuple(x + y for x, y in zip(a, b))


def sub(a, b) -> tuple:
    return tuple(x - y for x, y in zip(a, b))


def _fold_carry(lo, hi) -> tuple:
    """Columns 10..18 folded times 19 into 0..8, then `carry`."""
    return carry([lo[k] + hi[k] * 19 for k in range(9)] + [lo[9]])


def mul(f, g) -> tuple:
    """f * g: column sums of the 100 limb products (odd x odd products
    doubled, since 2^OFFSETS[i] * 2^OFFSETS[j] = 2 * 2^OFFSETS[i+j] when
    both are odd), columns 10..18 folded times 19, then `carry`."""
    g2 = tuple(g[j] * 2 if j & 1 else g[j] for j in range(10))
    lo = [0] * 10
    hi = [0] * 9
    for i in range(10):
        gi = g2 if i & 1 else g
        for j in range(10):
            p = f[i] * gi[j]
            if i + j < 10:
                lo[i + j] = lo[i + j] + p
            else:
                hi[i + j - 10] = hi[i + j - 10] + p
    return _fold_carry(lo, hi)


def sq(f) -> tuple:
    """f * f from 55 products (ref10 fe_sq): f_i^2 (doubled for odd i)
    and, for i < j, (2 f_i) f_j, or (2 f_i)(2 f_j) when both are odd — the
    same column sums as mul(f, f), so the same limbs come out. The doubled
    operands are int32 in the kernel."""
    f2 = tuple(x * 2 for x in f)
    lo = [0] * 10
    hi = [0] * 9
    for i in range(10):
        for j in range(i, 10):
            a = f[i] if i == j and not i & 1 else f2[i]
            b = f2[j] if i != j and i & 1 and j & 1 else f[j]
            p = a * b
            if i + j < 10:
                lo[i + j] = lo[i + j] + p
            else:
                hi[i + j - 10] = hi[i + j - 10] + p
    return _fold_carry(lo, hi)


def nsquare(a, n: int) -> tuple:
    for _ in range(n):
        a = sq(a)
    return a


def pow22501(z):
    """(z^(2^250 - 1), z^11) — the shared head of `invert` and `pow_p58`
    (ref10's chain)."""
    t0 = sq(z)                    # 2
    t1 = nsquare(t0, 2)           # 8
    t1 = mul(z, t1)               # 9
    t0 = mul(t0, t1)              # 11
    z11 = t0
    t0 = sq(t0)                   # 22
    t1 = mul(t1, t0)              # 31 = 2^5 - 1
    t0 = nsquare(t1, 5)
    t1 = mul(t0, t1)              # 2^10 - 1
    t0 = nsquare(t1, 10)
    t2 = mul(t0, t1)              # 2^20 - 1
    t0 = nsquare(t2, 20)
    t0 = mul(t0, t2)              # 2^40 - 1
    t0 = nsquare(t0, 10)
    t1 = mul(t0, t1)              # 2^50 - 1
    t0 = nsquare(t1, 50)
    t2 = mul(t0, t1)              # 2^100 - 1
    t0 = nsquare(t2, 100)
    t0 = mul(t0, t2)              # 2^200 - 1
    t0 = nsquare(t0, 50)
    return mul(t0, t1), z11       # 2^250 - 1


def invert(z) -> tuple:
    """z^(p-2) = z^(2^255 - 21), the fe8.invert exponent."""
    t, z11 = pow22501(z)
    return mul(nsquare(t, 5), z11)


def pow_p58(z) -> tuple:
    """z^((p-5)/8) = z^(2^252 - 3)."""
    t, _ = pow22501(z)
    return mul(nsquare(t, 2), z)


def canon_limbs(h) -> tuple:
    """Fully reduce to the unique value in [0, p), limbs in [0, 2^w).

    Bias by 8p so every limb is >= 0, floor-carry once with the top carry
    folded times 19 (value now < 2p), then q = floor((value + 19) / 2^255)
    says whether value >= p; add 19q, floor-carry, drop bit 255."""
    h = [x + b for x, b in zip(h, _BIAS8P)]
    for i in range(9):
        c, h[i] = _carry(h[i], WIDTHS[i], 0)
        h[i + 1] = h[i + 1] + c
    c, h[9] = _carry(h[9], 25, 0)
    h[0] = h[0] + c * 19
    q = (h[0] + 19) >> 26
    for i in range(1, 10):
        q = (h[i] + q) >> WIDTHS[i]
    h[0] = h[0] + q * 19
    for i in range(9):
        c, h[i] = _carry(h[i], WIDTHS[i], 0)
        h[i + 1] = h[i + 1] + c
    _, h[9] = _carry(h[9], 25, 0)
    return tuple(h)


def _byte_sources(off_w):
    """For each of the 32 bytes, the limbs it draws bits from, as
    (limb index, right shift, left shift)."""
    out = []
    for b in range(32):
        src = []
        for i, (o, w) in enumerate(off_w):
            if o < 8 * b + 8 and 8 * b < o + w:
                src.append((i, max(0, 8 * b - o), max(0, o - 8 * b)))
        out.append(src)
    return out


_PACK = _byte_sources(list(zip(OFFSETS, WIDTHS)))


def pack_bytes(limbs, byte_sources) -> torch.Tensor:
    """Non-negative limbs, each inside its own bit range -> (n,32) uint8."""
    cols = []
    for src in byte_sources:
        v = 0
        for i, rs, ls in src:
            v = v | (((limbs[i] >> rs) << ls) & 0xFF)
        cols.append(v)
    return torch.stack(cols, dim=1).to(torch.uint8)


def to_bytes(h) -> torch.Tensor:
    """Canonical 32-byte little-endian encoding, (n,32) uint8."""
    return pack_bytes(canon_limbs(h), _PACK)


def unpack_bits(b64: torch.Tensor, off: int, w: int) -> torch.Tensor:
    """Bits off .. off+w of little-endian bytes b64 ((n,m) int64)."""
    b0, b1 = off // 8, (off + w - 1) // 8
    t = b64[:, b0]
    for j in range(b0 + 1, b1 + 1):
        t = t | (b64[:, j] << (8 * (j - b0)))
    return (t >> (off - 8 * b0)) & ((1 << w) - 1)


def from_bytes(b: torch.Tensor) -> tuple:
    """(n,32) uint8 -> limbs of the low 255 bits (bit 255 is ignored)."""
    b64 = b.to(torch.int64)
    return tuple(unpack_bits(b64, o, w) for o, w in zip(OFFSETS, WIDTHS))


def from_jax_limbs(a) -> torch.Tensor:
    """(32,B) int32 byte limbs (the fe8 / Pallas layout) -> (B,32) uint8."""
    a = np.asarray(a)
    if a.ndim != 2 or a.shape[0] != 32:
        raise ValueError(f"expected (32,B) byte limbs, got {a.shape}")
    if a.min(initial=0) < 0 or a.max(initial=0) > 255:
        raise ValueError("byte limbs must lie in [0, 256)")
    return torch.from_numpy(np.ascontiguousarray(a.T.astype(np.uint8)))


def to_jax_limbs(t: torch.Tensor) -> np.ndarray:
    """(B,32) uint8 -> (32,B) int32 byte limbs (the fe8 / Pallas layout)."""
    return np.ascontiguousarray(
        t.detach().cpu().numpy().astype(np.int32).T)
