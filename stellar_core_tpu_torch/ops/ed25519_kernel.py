"""Batch Ed25519 verification on the card: prep -> ladder -> finish.

Counterpart of stellar_core_tpu/ops/ed25519_kernel.py. Its entries
`verify_kernel_full(a, r, s, k)` and `verify_kernel_msg32(a, r, s, m)`
keep the JAX signatures: four (n,32) uint8 tensors in, (n,) bool out.
The work is split as ed25519_pallas.verify_kernel_pallas splits it,
with the prep moved onto the card as verify_kernel_msg32 does:

1. `prep` (kernel `ed25519_prep`): k, the canonical bytes of -A, and the
   strict flags;
2. `ladder.ladder` (kernel `ed25519_ladder`): canonical affine
   [S]B + [k](-A);
3. `finish` (plain torch on the card): encode and compare with R.

`ed25519_prep` replaces the jnp code of the JAX main path before the
scalar multiplication: sha512.sha512_96 / mod_l / k_mod_l_96, and
ed25519_kernel._lt_const, _is_torsion_y, _pow_p58, decompress_neg and the
flag logic of _verify_full. One thread per signature: in msg32 mode it
hashes R‖A‖M (one SHA-512 block on native uint64 words) and reduces
mod L (ref10 sc_reduce in int64); in k mode it copies k through. Then
it decompresses A (255 squarings + 18 multiplies on the field of
csrc/field.cuh). What bounds it on the H100: integer multiplies — 255
squarings at 55 IMAD.WIDE and 18 multiplies at 100 (`prep_products`),
plus 80 SHA-512 rounds of 64-bit adds, rotates and logic on the other
integer pipe. It moves 225 bytes per signature. Its design keeps rows
as 64-bit words from 16-byte loads (SHA-512 byte-swaps them into its
big-endian words; the compares with L, p and the torsion y values work
on words), the whole chain in registers, and its constants in constant
memory, which every thread reads at the same index at the same time.
The 250-squaring chain is serial, so a signature stays on one thread.

`prep_plain` runs the same steps on int64 tensors (ops/field.py and
ops/sha512.py); it is what the wrappers use for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from . import field as F
from . import sha512 as _sha
from .ladder import _check, ladder
from ..crypto import ed25519_ref as _ref

MODE_MSG32 = 0     # k = SHA512(R‖A‖M) mod L, M is 32 bytes
MODE_K = 1         # k given

# field products per signature: decompression is recover_x (pow_p58
# inside) and x sqrt(-1); msg32 mode adds sc_reduce's 84 digit products
PREP_SQS, PREP_MULS, SC_REDUCE_MULS = 255, 18, 84


def prep_products(mode: int) -> int:
    """32x32->64 products one signature of prep runs in this mode."""
    return (55 * PREP_SQS + 100 * PREP_MULS
            + (SC_REDUCE_MULS if mode == MODE_MSG32 else 0))


_P_BYTES = [(_ref.P >> (8 * i)) & 0xFF for i in range(32)]
_L_BYTES = [(_ref.L >> (8 * i)) & 0xFF for i in range(32)]

# canonical y of the 8-torsion points (identity, order 2, order 4 (y=0),
# and the two order-8 values); a canonical encoding is small-order iff
# its y is one of these
_TORSION_Y = [0, 1, _ref.P - 1]
for _enc in ("26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05",
             "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a"):
    _pt = _ref.pt_decompress(bytes.fromhex(_enc), strict=True)
    if _pt is None or not _ref.pt_is_small_order(_pt):
        raise AssertionError("torsion constant is not small-order")
    _TORSION_Y.append(_pt[1] % _ref.P)
TORSION_Y_BYTES = [[(y >> (8 * i)) & 0xFF for i in range(32)]
                   for y in sorted(_TORSION_Y)]


def lt_bytes(b: torch.Tensor, const_bytes) -> torch.Tensor:
    """(n,) bool: little-endian (n,32) bytes b < the 32-byte constant."""
    lt = torch.zeros(b.shape[0], dtype=torch.bool, device=b.device)
    eq = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
    for i in range(31, -1, -1):
        lt = lt | (eq & (b[:, i] < const_bytes[i]))
        eq = eq & (b[:, i] == const_bytes[i])
    return lt


def is_torsion_y(y: torch.Tensor) -> torch.Tensor:
    """(n,) bool: y bytes equal one of the five torsion y values."""
    t = torch.tensor(TORSION_Y_BYTES, dtype=torch.uint8, device=y.device)
    return (t[None, :, :] == y[:, None, :]).all(2).any(1)


def recover_x(y):
    """Candidate root of x^2 = (y^2 - 1) / (d y^2 + 1) with its check
    values: returns (x, v x^2, u). Field ops only (the bounds test walks
    this with intervals)."""
    y2 = F.sq(y)
    u = F.sub(y2, F.ONE)
    v = F.add(F.mul(F.D, y2), F.ONE)
    v2 = F.sq(v)
    v3 = F.mul(v2, v)
    uv3 = F.mul(u, v3)
    uv7 = F.mul(uv3, F.sq(v2))
    x = F.mul(uv3, F.pow_p58(uv7))
    return x, F.mul(v, F.sq(x)), u


def decompress_neg(a: torch.Tensor):
    """Strict decompression of the encodings a ((n,32) uint8), negated:
    returns (canonical bytes of -x, canonical bytes of y, valid), as
    ed25519_kernel.decompress_neg; total on invalid input."""
    sign = (a[:, 31] >> 7).to(torch.bool)
    y = F.from_bytes(a)
    x, vx2, u = recover_x(y)
    root_ok = (F.to_bytes(F.sub(vx2, u)) == 0).all(1)
    root_flip = (F.to_bytes(F.add(vx2, u)) == 0).all(1)
    xm = F.mul(x, F.SQRT_M1)
    x = tuple(torch.where(root_flip, b, c) for b, c in zip(xm, x))
    valid = root_ok | root_flip
    x_c = F.to_bytes(x)
    valid = valid & ~((x_c == 0).all(1) & sign)       # "-0" is invalid
    # A = (x_signed, y) with x_signed's parity = sign; -A has x = -x_signed
    flip = (x_c[:, 0] & 1).to(torch.bool) != sign
    neg_x = torch.where(flip[:, None], x_c, F.to_bytes(F.sub(F.ZERO, x)))
    return neg_x, F.to_bytes(y), valid


def prep_plain(a, r, s, mk, mode: int):
    """Plain version of `prep`."""
    k = _sha.k_mod_l_96(r, a, mk) if mode == MODE_MSG32 else mk.clone()
    y_a = a.clone()
    y_a[:, 31] &= 0x7F
    y_r = r.clone()
    y_r[:, 31] &= 0x7F
    neg_x, y, a_valid = decompress_neg(a)
    ok = (lt_bytes(s, _L_BYTES) & lt_bytes(y_a, _P_BYTES)
          & ~is_torsion_y(y_a) & a_valid
          & lt_bytes(y_r, _P_BYTES) & ~is_torsion_y(y_r))
    return k, torch.cat([neg_x, y], dim=1), ok.to(torch.uint8)


def prep(a, r, s, mk, mode: int):
    """A, R, S and M-or-k as (n,32) uint8 -> (k (n,32) uint8 exact and
    < L, neg_a (n,64) uint8 canonical (-x, y), ok (n,) uint8). ok is the
    AND of S < L, A and R canonical, A and R not of small order, and A
    decompressing. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if mode not in (MODE_MSG32, MODE_K):
        raise ValueError(f"ed25519_prep: unknown mode {mode}")
    dev = _check("ed25519_prep", a, r, s, mk)
    if dev.type == "cpu":
        return prep_plain(a, r, s, mk, mode)
    if dev.type != "cuda":
        raise ValueError(f"ed25519_prep: unsupported device {dev}")
    lib = _build.lib()
    n = a.shape[0]
    k = torch.empty((n, 32), dtype=torch.uint8, device=dev)
    neg_a = torch.empty((n, 64), dtype=torch.uint8, device=dev)
    ok = torch.empty((n,), dtype=torch.uint8, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = lib.ed25519_prep_launch(
                a.data_ptr(), r.data_ptr(), s.data_ptr(), mk.data_ptr(),
                mode, k.data_ptr(), neg_a.data_ptr(), ok.data_ptr(), n,
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"ed25519_prep launch failed: "
                               f"{_build.error_string(err)}")
        prep.launches += 1
        prep.mode_launches[mode] += 1
    return k, neg_a, ok


# launches in all and by mode (indexed by MODE_MSG32, MODE_K)
prep.launches = 0
prep.mode_launches = [0, 0]


def finish(x, y, r, ok):
    """Encode y with sign(x) in bit 255 and compare with R: (n,) bool."""
    enc = y.clone()
    enc[:, 31] |= (x[:, 0] & 1) << 7
    return (enc == r).all(1) & ok.to(torch.bool)


def _verify(a, r, s, mk, mode):
    k, neg_a, ok = prep(a, r, s, mk, mode)
    x, y = ladder(s, k, neg_a[:, :32].contiguous(),
                  neg_a[:, 32:].contiguous())
    return finish(x, y, r, ok)


def verify_kernel_full(a, r, s, k):
    """(n,32) uint8 A, R, S, k -> (n,) bool strict verdicts."""
    return _verify(a, r, s, k, MODE_K)


def verify_kernel_msg32(a, r, s, m):
    """(n,32) uint8 A, R, S and the 32-byte message -> (n,) bool; k is
    computed on the card."""
    return _verify(a, r, s, m, MODE_MSG32)
