"""The work the algorithm needs on a dispatch's rows, and the card's rate.

A frozen copy of the arithmetic of the port's
scripts/_kernel_timing.py (`wnaf`, `ladder_products`, `imad_per_s`) and
of ops/ed25519_kernel.py's `prep_products`, so that a later change to the
program cannot move the yardstick. The counts are of the algorithm, not
of a kernel: whatever kernel does the work, the bound stays.

- prep, msg32 mode: decompressing A (255 squarings, 18 multiplies) and
  k = SHA-512(R || A || M) mod L (84 digit products of sc_reduce);
- the ladder: [S]B + [k](-A) in canonical affine form at the fewest point
  operations of libsodium's ge25519_double_scalarmult_vartime on width-5
  NAF digits of S and k, then Z^-1 and the encoding;
- the rate: SMs x 64 32-bit integer multiply-adds per SM and clock
  (compute capability 9.0) x the maximum SM clock, each 32x32->64
  product counted once.
"""

from __future__ import annotations

import hashlib
import subprocess

L = 2**252 + 27742317777372353535851937790883648493

# 32x32->64 products of one field squaring and one field multiply in ten
# radix-2^25.5 limbs (10 + 45 and 10 x 10)
SQ_PRODUCTS, MUL_PRODUCTS = 55, 100
IMAD_PER_SM_CLK = 64

PREP_SQS, PREP_MULS, SC_REDUCE_MULS = 255, 18, 84

# the ladder's epilogue: Z^-1 (254 squarings, 11 multiplies) and x, y
# (2 multiplies)
EPILOGUE_PRODUCTS = 254 * SQ_PRODUCTS + 13 * MUL_PRODUCTS


def prep_products(message_bytes: int) -> int:
    """Prep's products per signature: msg32 mode where the message is 32
    bytes (k on the card), k mode otherwise (k from the host)."""
    return (SQ_PRODUCTS * PREP_SQS + MUL_PRODUCTS * PREP_MULS
            + (SC_REDUCE_MULS if message_bytes == 32 else 0))


def wnaf(v, w=5):
    """(nonzero digits, index of the top digit) of v's width-w NAF."""
    n, top, i = 0, -1, 0
    while v:
        if v & 1:
            d = v & ((1 << w) - 1)
            v -= d - (1 << w) if d >> (w - 1) else d
            n, top = n + 1, i
        v >>= 1
        i += 1
    return n, top


def ladder_row_products(s: int, k: int) -> int:
    """Products of one signature's ladder on scalars S and k: below the
    top digit, per position a doubling (4 squarings) and a p1p1 -> p2
    conversion (3 multiplies), per nonzero digit of k a p3 conversion and
    cached addition of an odd multiple of -A (4 + 4), of S a p3
    conversion and mixed addition of a stored multiple of B (4 + 3); the
    table of -A, 3(-A), ..., 15(-A) (4 squarings, 69 multiplies); the
    epilogue."""
    nb, tb = wnaf(s)
    na, ta = wnaf(k)
    top = max(ta, tb, 0)
    # the top digit's table entry is loaded, not added
    first = 8 if ta == top else 7 if tb == top else 0
    sq = 4 + 4 * top
    mul = 69 + 3 * top + 8 * na + 7 * nb - first
    return sq * SQ_PRODUCTS + mul * MUL_PRODUCTS + EPILOGUE_PRODUCTS


def k_of(pub: bytes, sig: bytes, msg: bytes) -> int:
    """k = SHA-512(R || A || M) mod L, as the verifier computes it."""
    return int.from_bytes(
        hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % L


def ladder_products(rows) -> int:
    """Ladder products of a dispatch of (pub, sig, msg) rows."""
    return sum(ladder_row_products(int.from_bytes(sig[32:], "little"),
                                   k_of(pub, sig, msg))
               for pub, sig, msg in rows)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def imad_per_s(sms: int, device_index: int = 0) -> float:
    """32x32->64 integer multiplies per second of the card."""
    mhz = float(smi("clocks.max.sm").splitlines()[device_index].split()[0])
    return sms * IMAD_PER_SM_CLK * mhz * 1e6
