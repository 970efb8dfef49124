"""[S]B + [k](-A): the `ed25519_ladder` kernel wrapper and its plain version.

Replaces stellar_core_tpu/ops/ed25519_pallas.py::ladder (the Pallas body
`_ladder_kernel`, a 1-bit ladder over all 256 bits), and with
`ed25519_kernel.finish` the XLA `double_scalarmult_w2` + `compress` of the
JAX main path.

Kernel (csrc/ed25519.cu::ed25519_ladder_kernel):
- Schedule: interleaved (Straus) signed radix 16 over both scalars. S and
  k are each recoded into 65 digits in [-8, 8) (`recode`; all 256 bits,
  so S up to 2^256 - 1 works). From the top window down: four doublings
  (the three that feed another doubling skip T: ref10's p2 -> p1p1 ->
  p2), a mixed addition of |e|B from a constant table of B's multiples
  in niels form, and a cached addition of |f|(-A) from a per-lane table
  of 1..8 times -A. A negative digit swaps y+x / y-x and negates the
  2d term; digit 0 selects the identity, so no lane branches on data.
  Then Z^-1 and canonical affine bytes. LADDER_PRODUCTS counts the field
  products per signature (a multiply is 100 32x32->64 products, a
  squaring 55): 252,290, against 437,400 for a 1-bit ladder over
  256 bits that squares with the multiply.
- Layout: four lanes per signature, lane r holding coordinate r of the
  point (csrc/point.cuh); each point operation is one round of four
  independent field products with operands exchanged by warp shuffles,
  so n = 16384 gives four times the warps of one lane per signature.
  The per-lane table of -A (8 x 40 int32 per signature) lives in shared
  memory, laid out so that the 32 lanes of a warp hit 32 banks; B's
  table and the digits sit there too. Z^-1, a serial chain, runs on one
  thread per signature after the block regroups the points through
  shared memory, so one warp per block does it with all lanes busy.
- What bounds it on the H100: integer multiplies (IMAD.WIDE); memory
  traffic is 192 bytes per signature.

The plain version (`ladder_plain`) runs the same digits, formulas, table
and field code (ops/field.py) on int64 tensors; the thread layout does
not change what any product computes.
"""

from __future__ import annotations

import torch

from . import _build
from . import field as F
from ..crypto import ed25519_ref as _ref

WINDOWS = 65            # signed radix-16 digits per scalar (256 bits + 1)


def _niels(j: int):
    """Affine niels form (y+x, y-x, 2dxy) of jB as canonical limbs."""
    x, y, z, _ = _ref.pt_mul(j, _ref.BASE)
    zi = pow(z, _ref.P - 2, _ref.P)
    x, y = x * zi % _ref.P, y * zi % _ref.P
    return (F.const(y + x), F.const(y - x), F.const(2 * _ref.D * x * y))


NIELS_B = tuple(_niels(j) for j in range(1, 9))    # 1B .. 8B
IDENT_P3 = (F.ZERO, F.ONE, F.ONE, F.ZERO)
IDENT_NIELS = (F.ONE, F.ONE, F.ZERO)
IDENT_CACHED = (F.ONE, F.ONE, F.ZERO, F.ONE)

# field products per signature on the kernel's schedule: the table of -A
# (T of -A, 2dT of 8 entries, 7 cached additions with p3 conversion), the
# top window (madd + add from the identity), 64 windows of 4 doublings
# (4 squarings + 3 or 4 multiplies each), a madd and an add with their
# conversions, Z^-1 and x, y
LADDER_MULS = (1 + 8 + 7 * 8) + (7 + 7) + 64 * (3 + 3 + 3 + 4 + 7 + 7) + 11 + 2
LADDER_SQS = 64 * 16 + 254
LADDER_PRODUCTS = 100 * LADDER_MULS + 55 * LADDER_SQS


def dbl(p):
    """p2 or p3 -> p1p1 (ref10 ge_p2_dbl): 4 squarings."""
    x, y, z = p[:3]
    xx, yy, zz, aa = F.sq(x), F.sq(y), F.sq(z), F.sq(F.add(x, y))
    y3, z3 = F.add(yy, xx), F.sub(yy, xx)
    return (F.sub(aa, y3), y3, z3, F.sub(F.add(zz, zz), z3))


def p1p1_to_p2(c):
    x, y, z, t = c
    return (F.mul(x, t), F.mul(y, z), F.mul(z, t))


def p1p1_to_p3(c):
    x, y, z, t = c
    return (F.mul(x, t), F.mul(y, z), F.mul(z, t), F.mul(x, y))


def _combine(a, b, c, d):
    return (F.sub(a, b), F.add(a, b), F.add(d, c), F.sub(d, c))


def madd(p, n):
    """p3 + niels -> p1p1 (ref10 ge_madd): 3 products, D = 2Z."""
    x, y, z, t = p
    ypx, ymx, xy2d = n
    return _combine(F.mul(F.add(y, x), ypx), F.mul(F.sub(y, x), ymx),
                    F.mul(t, xy2d), F.add(z, z))


def add_cached(p, c):
    """p3 + cached -> p1p1 (ref10 ge_add): 4 products, D = 2 Z Z2."""
    x, y, z, t = p
    ypx, ymx, t2d, z2 = c
    zz = F.mul(z, z2)
    return _combine(F.mul(F.add(y, x), ypx), F.mul(F.sub(y, x), ymx),
                    F.mul(t, t2d), F.add(zz, zz))


def to_cached(p):
    """p3 -> cached (Y+X, Y-X, 2dT, Z)."""
    x, y, z, t = p
    return (F.add(y, x), F.sub(y, x), F.mul(t, F.D2), z)


def recode(b: torch.Tensor) -> torch.Tensor:
    """(n,32) uint8 little-endian scalars -> (n,65) int64 signed radix-16
    digits: digit i in [-8, 8) for i < 64, digit 64 in {0, 1}, and
    sum(d_i 16^i) equals the scalar. The kernel recodes the same way."""
    b64 = b.to(torch.int64)
    out = torch.empty((b.shape[0], WINDOWS), dtype=torch.int64,
                      device=b.device)
    c = torch.zeros_like(b64[:, 0])
    for i in range(64):
        d = ((b64[:, i >> 1] >> (4 * (i & 1))) & 15) + c
        c = (d + 8) >> 4
        out[:, i] = d - (c << 4)
    out[:, 64] = c
    return out


def _lanes(fe, n: int, device):
    return tuple(x if isinstance(x, torch.Tensor)
                 else torch.full((n,), int(x), dtype=torch.int64,
                                 device=device) for x in fe)


def _stack(entry, n: int, device) -> torch.Tensor:
    """A table entry (tuple of field elements) -> (n, coords, 10)."""
    return torch.stack([torch.stack(_lanes(c, n, device), 1)
                        for c in entry], 1)


def _select(table: torch.Tensor, digit: torch.Tensor):
    """Entry |digit| of table (n, 9, coords, 10), entry 0 the identity,
    negated where digit < 0 -> tuple of field elements."""
    n = digit.shape[0]
    t = table[torch.arange(n, device=digit.device), digit.abs()]
    flip = torch.cat([t[:, 1:2], t[:, 0:1], -t[:, 2:3], t[:, 3:]], 1)
    t = torch.where((digit < 0)[:, None, None], flip, t)
    return tuple(tuple(t[:, c, j] for j in range(10))
                 for c in range(t.shape[1]))


def neg_a_table(nax, nay):
    """Cached 1..8 times the point (nax, nay) (limbs), as the kernel
    builds it: A1 = (x, y, 1, xy), A(j+1) = A(j) + cached(A1)."""
    p = (nax, nay, F.ONE, F.mul(nax, nay))
    c1 = to_cached(p)
    out = [c1]
    for _ in range(7):
        p = p1p1_to_p3(add_cached(p, c1))
        out.append(to_cached(p))
    return out


def ladder_plain(s, k, neg_ax, neg_ay):
    """Plain version: (n,32) uint8 S, k, -A x, -A y -> canonical (x, y)
    bytes of [S]B + [k](-A), each (n,32) uint8."""
    n, dev = s.shape[0], s.device
    tab_a = torch.stack([_stack(c, n, dev) for c in
                         [IDENT_CACHED] + neg_a_table(F.from_bytes(neg_ax),
                                                      F.from_bytes(neg_ay))],
                        1)
    tab_b = torch.stack([_stack(e, n, dev) for e in
                         (IDENT_NIELS,) + NIELS_B], 1)
    es, fs = recode(s), recode(k)
    p = tuple(_lanes(c, n, dev) for c in IDENT_P3)
    for i in range(WINDOWS - 1, -1, -1):
        if i < WINDOWS - 1:
            for d in range(4):
                c = dbl(p)
                p = p1p1_to_p3(c) if d == 3 else p1p1_to_p2(c)
        p = p1p1_to_p3(madd(p, _select(tab_b, es[:, i])))
        p = p1p1_to_p2(add_cached(p, _select(tab_a, fs[:, i])))
    x, y, z = p
    zi = F.invert(z)
    return F.to_bytes(F.mul(x, zi)), F.to_bytes(F.mul(y, zi))


def _check(name, *ts):
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices")
        if t.dtype != torch.uint8 or t.dim() != 2 or t.shape[1] != 32 \
                or t.shape[0] != ts[0].shape[0]:
            raise ValueError(f"{name}: expected (n,32) uint8, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if dev.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return dev


def ladder(s, k, neg_ax, neg_ay):
    """[S]B + [k](-A) -> canonical affine (x, y), each (n,32) uint8.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    dev = _check("ed25519_ladder", s, k, neg_ax, neg_ay)
    if dev.type == "cpu":
        return ladder_plain(s, k, neg_ax, neg_ay)
    if dev.type != "cuda":
        raise ValueError(f"ed25519_ladder: unsupported device {dev}")
    lib = _build.lib()
    n = s.shape[0]
    x = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    y = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = lib.ed25519_ladder_launch(
                s.data_ptr(), k.data_ptr(), neg_ax.data_ptr(),
                neg_ay.data_ptr(), x.data_ptr(), y.data_ptr(), n,
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"ed25519_ladder launch failed: "
                               f"{_build.error_string(err)}")
        ladder.launches += 1
    return x, y


ladder.launches = 0
