"""One-block SHA-512 of R‖A‖M and exact reduction mod L — plain versions.

Counterpart of stellar_core_tpu/ops/sha512.py (`sha512_96`, `mod_l`,
`k_mod_l_96`), and the plain version of csrc/sha512.cuh and
csrc/scalar.cuh, which the prep kernel runs.

- SHA-512: the kernel uses native uint64 words. PyTorch has no uint64
  shift on the CPU, so here each word is a (hi, lo) pair of 32-bit halves
  held in int64 tensors; sums of up to five halves stay below 2^35 and
  carry into the high half once.
- mod L: ref10's sc_reduce on 24 signed 21-bit limbs in int64 (the
  kernel runs the same steps in the same order). It folds the top limbs
  with 2^252 = -(L - 2^252) mod L, written as six signed 21-bit digits,
  and returns the canonical value in [0, L). No integer matmul or einsum:
  PyTorch has none for integers on the card.
"""

from __future__ import annotations

import torch

from .field import _byte_sources, pack_bytes, unpack_bits

L = 2**252 + 27742317777372353535851937790883648493
M32 = 0xFFFFFFFF

K = (
    0x428a2f98d728ae22, 0x7137449123ef65cd, 0xb5c0fbcfec4d3b2f, 0xe9b5dba58189dbbc,
    0x3956c25bf348b538, 0x59f111f1b605d019, 0x923f82a4af194f9b, 0xab1c5ed5da6d8118,
    0xd807aa98a3030242, 0x12835b0145706fbe, 0x243185be4ee4b28c, 0x550c7dc3d5ffb4e2,
    0x72be5d74f27b896f, 0x80deb1fe3b1696b1, 0x9bdc06a725c71235, 0xc19bf174cf692694,
    0xe49b69c19ef14ad2, 0xefbe4786384f25e3, 0x0fc19dc68b8cd5b5, 0x240ca1cc77ac9c65,
    0x2de92c6f592b0275, 0x4a7484aa6ea6e483, 0x5cb0a9dcbd41fbd4, 0x76f988da831153b5,
    0x983e5152ee66dfab, 0xa831c66d2db43210, 0xb00327c898fb213f, 0xbf597fc7beef0ee4,
    0xc6e00bf33da88fc2, 0xd5a79147930aa725, 0x06ca6351e003826f, 0x142929670a0e6e70,
    0x27b70a8546d22ffc, 0x2e1b21385c26c926, 0x4d2c6dfc5ac42aed, 0x53380d139d95b3df,
    0x650a73548baf63de, 0x766a0abb3c77b2a8, 0x81c2c92e47edaee6, 0x92722c851482353b,
    0xa2bfe8a14cf10364, 0xa81a664bbc423001, 0xc24b8b70d0f89791, 0xc76c51a30654be30,
    0xd192e819d6ef5218, 0xd69906245565a910, 0xf40e35855771202a, 0x106aa07032bbd1b8,
    0x19a4c116b8d2d0c8, 0x1e376c085141ab53, 0x2748774cdf8eeb99, 0x34b0bcb5e19b48a8,
    0x391c0cb3c5c95a63, 0x4ed8aa4ae3418acb, 0x5b9cca4f7763e373, 0x682e6ff3d6b2b8a3,
    0x748f82ee5defb2fc, 0x78a5636f43172f60, 0x84c87814a1f0ab72, 0x8cc702081a6439ec,
    0x90befffa23631e28, 0xa4506cebde82bde9, 0xbef9a3f7b2c67915, 0xc67178f2e372532b,
    0xca273eceea26619c, 0xd186b8c721c0c207, 0xeada7dd6cde0eb1e, 0xf57d4f7fee6ed178,
    0x06f067aa72176fba, 0x0a637dc5a2c898a6, 0x113f9804bef90dae, 0x1b710b35131c471b,
    0x28db77f523047d84, 0x32caab7b40c72493, 0x3c9ebe0a15c9bebc, 0x431d67c49c100d4c,
    0x4cc5d4becb3e42b6, 0x597f299cfc657e2a, 0x5fcb6fab3ad6faec, 0x6c44198c4a475817,
)
IV = (
    0x6a09e667f3bcc908, 0xbb67ae8584caa73b, 0x3c6ef372fe94f82b, 0xa54ff53a5f1d36f1,
    0x510e527fade682d1, 0x9b05688c2b3e6c1f, 0x1f83d9abfb41bd6b, 0x5be0cd19137e2179,
)


def _word(c: int):
    return (c >> 32, c & M32)


def _add(*ws):
    """(sum of the 64-bit words) mod 2^64 on (hi, lo) pairs."""
    lo = ws[0][1]
    hi = ws[0][0]
    for h, l in ws[1:]:
        lo = lo + l
        hi = hi + h
    return (hi + (lo >> 32)) & M32, lo & M32


def _rotr(w, n: int):
    h, l = w
    if n >= 32:
        h, l, n = l, h, n - 32
    if n == 0:
        return h, l
    return (((h >> n) | (l << (32 - n))) & M32,
            ((l >> n) | (h << (32 - n))) & M32)


def _shr(w, n: int):
    h, l = w
    return h >> n, ((l >> n) | (h << (32 - n))) & M32


def _xor(*ws):
    h, l = ws[0]
    for a, b in ws[1:]:
        h, l = h ^ a, l ^ b
    return h, l


def sha512_96(r: torch.Tensor, a: torch.Tensor, m: torch.Tensor):
    """SHA-512 of the 96-byte message R‖A‖M, each (n,32) uint8; one block
    with constant padding. Returns the (n,64) uint8 digest."""
    msg = torch.cat([r, a, m], dim=1).to(torch.int64)
    w = []
    for i in range(12):
        b = [msg[:, 8 * i + j] for j in range(8)]
        w.append(((b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3],
                  (b[4] << 24) | (b[5] << 16) | (b[6] << 8) | b[7]))
    zero = torch.zeros_like(msg[:, 0])
    w.append((zero + 0x80000000, zero))           # byte 96 = 0x80
    w.append((zero, zero))
    w.append((zero, zero))
    w.append((zero, zero + 96 * 8))               # message length in bits
    st = [(zero + h, zero + l) for h, l in map(_word, IV)]
    v = list(st)
    for t in range(80):
        if t >= 16:
            w15, w2 = w[(t - 15) % 16], w[(t - 2) % 16]
            s0 = _xor(_rotr(w15, 1), _rotr(w15, 8), _shr(w15, 7))
            s1 = _xor(_rotr(w2, 19), _rotr(w2, 61), _shr(w2, 6))
            w[t % 16] = _add(w[t % 16], s0, w[(t - 7) % 16], s1)
        a_, b_, c_, d_, e_, f_, g_, h_ = v
        ch = ((e_[0] & f_[0]) ^ ((e_[0] ^ M32) & g_[0]),
              (e_[1] & f_[1]) ^ ((e_[1] ^ M32) & g_[1]))
        maj = ((a_[0] & b_[0]) ^ (a_[0] & c_[0]) ^ (b_[0] & c_[0]),
               (a_[1] & b_[1]) ^ (a_[1] & c_[1]) ^ (b_[1] & c_[1]))
        big1 = _xor(_rotr(e_, 14), _rotr(e_, 18), _rotr(e_, 41))
        big0 = _xor(_rotr(a_, 28), _rotr(a_, 34), _rotr(a_, 39))
        t1 = _add(h_, big1, ch, _word(K[t]), w[t % 16])
        t2 = _add(big0, maj)
        v = [_add(t1, t2), a_, b_, c_, _add(d_, t1), e_, f_, g_]
    out = []
    for s, x in zip(st, v):
        h, l = _add(s, x)
        for half in (h, l):
            for shift in (24, 16, 8, 0):
                out.append((half >> shift) & 0xFF)
    return torch.stack(out, dim=1).to(torch.uint8)


# 2^252 = -(L - 2^252) mod L as signed 21-bit digits (ref10 sc_reduce)
_FOLD = (666643, 470296, 654183, -997805, 136657, -683901)
_SC_OFF_W = [(21 * i, 21) for i in range(23)] + [(483, 29)]
# 12 output limbs of 21 bits; the last may hold up to 22 (value < 2^253)
_SC_PACK = _byte_sources([(21 * i, 21) for i in range(11)] + [(231, 25)])


def _fold(s, i: int) -> None:
    for j, c in enumerate(_FOLD):
        s[i - 12 + j] = s[i - 12 + j] + s[i] * c
    s[i] = s[i] * 0


def _carry_round(s, i: int) -> None:
    c = (s[i] + (1 << 20)) >> 21
    s[i + 1] = s[i + 1] + c
    s[i] = s[i] - c * (1 << 21)


def _carry_floor(s, i: int) -> None:
    c = s[i] >> 21
    s[i + 1] = s[i + 1] + c
    s[i] = s[i] - c * (1 << 21)


def mod_l(d: torch.Tensor) -> torch.Tensor:
    """(n,64) uint8 little-endian 512-bit values -> (n,32) uint8 of the
    value mod L, exact and canonical."""
    d64 = d.to(torch.int64)
    s = [unpack_bits(d64, o, w) for o, w in _SC_OFF_W]
    for i in range(23, 17, -1):
        _fold(s, i)
    for i in range(6, 17, 2):
        _carry_round(s, i)
    for i in range(7, 16, 2):
        _carry_round(s, i)
    for i in range(17, 11, -1):
        _fold(s, i)
    for i in range(0, 11, 2):
        _carry_round(s, i)
    for i in range(1, 12, 2):
        _carry_round(s, i)
    _fold(s, 12)
    for i in range(12):
        _carry_floor(s, i)
    _fold(s, 12)
    for i in range(11):
        _carry_floor(s, i)
    return pack_bytes(s[:12], _SC_PACK)


def k_mod_l_96(r: torch.Tensor, a: torch.Tensor, m: torch.Tensor):
    """k = SHA512(R‖A‖M) mod L for 32-byte messages, (n,32) uint8."""
    return mod_l(sha512_96(r, a, m))
