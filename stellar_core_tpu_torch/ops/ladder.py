"""[S]B + [k](-A): the `ed25519_ladder` kernel wrapper and its plain version.

Replaces stellar_core_tpu/ops/ed25519_pallas.py::ladder (the Pallas body
`_ladder_kernel`), and with `ed25519_kernel.finish` the XLA
`double_scalarmult_w2` + `compress` of the JAX main path.

Kernel (csrc/ed25519.cu::ed25519_ladder, one thread per signature):
- a 1-bit ladder over all 256 bits of S and k, msb first, as the Pallas
  kernel does: a dedicated doubling, then a complete cached addition of
  one of {identity, B, -A, B-A} picked by the two bits with selects (no
  data-dependent branch), so lanes with an invalid -A still finish and
  are masked by the prep flag; then Z^-1 by the fe8.invert chain and
  canonical affine bytes of x and y.
- What bounds it on the H100: integer multiplies. Per signature, 256
  iterations of 8 (doubling) + 8 (addition) field products, 265 for the
  inversion and a few for the table: about 4,370 products, each run as
  100 32x32->64 multiplies (IMAD.WIDE), squarings included. The
  function needs about half that: with 55-multiply squarings and the
  point operations of a width-5 NAF schedule, about 216,000 IMAD.WIDE
  per signature (chip_smoke.ladder_products). Memory traffic is 192
  bytes per signature, nothing beside the arithmetic. The design keeps
  every field element in registers (ten int32 limbs) and keeps B and
  the identity, two of the four table entries, in constant memory;
  n = 16384 gives
  only about four warps per SM, so latency hiding rests on the 100
  independent products inside each field multiply.

The plain version (`ladder_plain`) runs the same point formulas, bit
order and field code (ops/field.py) on int64 tensors.
"""

from __future__ import annotations

import torch

from . import _build
from . import field as F
from ..crypto import ed25519_ref as _ref


def _affine_const(pt):
    x, y, z, _ = pt
    zi = pow(z, _ref.P - 2, _ref.P)
    ax, ay = x * zi % _ref.P, y * zi % _ref.P
    return (F.const(ax), F.const(ay), F.ONE, F.const(ax * ay % _ref.P))


BASE = _affine_const(_ref.BASE)
IDENT = (F.ZERO, F.ONE, F.ONE, F.ZERO)


def dbl(p):
    """Dedicated doubling (dbl-2008-hwcd, a = -1, all four outputs scaled
    by -1), as ed25519_kernel.ge_dbl_w: 4 squarings + 4 products."""
    x1, y1, z1, _ = p
    a = F.sq(x1)
    b = F.sq(y1)
    zz = F.sq(z1)
    e0 = F.sq(F.add(x1, y1))
    c = F.add(zz, zz)
    s1 = F.add(a, b)
    e = F.sub(e0, s1)
    g = F.sub(b, a)
    f = F.sub(c, g)
    return (F.mul(e, f), F.mul(g, s1), F.mul(f, g), F.mul(e, s1))


def to_cached(q):
    """(X, Y, Z, T) -> (Y+X, Y-X, 2Z, 2dT), as ed25519_kernel.to_cached."""
    x, y, z, t = q
    return (F.add(y, x), F.sub(y, x), F.add(z, z), F.mul(t, F.D2))


def add_cached(p, cq):
    """Complete addition of a cached operand (add-2008-hwcd-3), as
    ed25519_kernel.ge_add_cached: 8 products."""
    x1, y1, z1, t1 = p
    yx2, ym2, z22, t2d = cq
    a = F.mul(F.sub(y1, x1), ym2)
    b = F.mul(F.add(y1, x1), yx2)
    c = F.mul(t1, t2d)
    d = F.mul(z1, z22)
    e = F.sub(b, a)
    f = F.sub(d, c)
    g = F.add(d, c)
    h = F.add(b, a)
    return (F.mul(e, f), F.mul(g, h), F.mul(f, g), F.mul(e, h))


def _lanes(fe, n: int, device):
    return tuple(x if isinstance(x, torch.Tensor)
                 else torch.full((n,), int(x), dtype=torch.int64,
                                 device=device) for x in fe)


def ladder_plain(s, k, neg_ax, neg_ay):
    """Plain version: (n,32) uint8 S, k, -A x, -A y -> canonical (x, y)
    bytes of [S]B + [k](-A), each (n,32) uint8."""
    n, dev = s.shape[0], s.device
    nax = F.from_bytes(neg_ax)
    nay = F.from_bytes(neg_ay)
    c_a = to_cached((nax, nay, F.ONE, F.mul(nax, nay)))
    table = [to_cached(IDENT), to_cached(BASE), c_a,
             to_cached(add_cached(BASE, c_a))]
    table = [tuple(_lanes(c, n, dev) for c in e) for e in table]
    s64 = s.to(torch.int64)
    k64 = k.to(torch.int64)
    p = tuple(_lanes(c, n, dev) for c in IDENT)
    for bit in range(255, -1, -1):
        byte, sh = bit >> 3, bit & 7
        idx = ((s64[:, byte] >> sh) & 1) + 2 * ((k64[:, byte] >> sh) & 1)
        is1, is2, is3 = idx == 1, idx == 2, idx == 3
        q = tuple(tuple(
            torch.where(is3, t3, torch.where(is2, t2, torch.where(is1, t1,
                                                                  t0)))
            for t0, t1, t2, t3 in zip(*(e[c] for e in table)))
            for c in range(4))
        p = add_cached(dbl(p), q)
    x, y, z, _ = p
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
