"""Plain strict Ed25519 verification: the benchmark's reference.

One signature at a time in Python integers, with the rules of
libsodium's crypto_sign_verify_detached (RFC 8032 verification, the
cofactorless equation):

- S is canonical: S < L;
- R's encoding is not of small order (libsodium's blocklist, the sign
  bit ignored);
- A's encoding is canonical (y < p) and not of small order, and A
  decompresses;
- the canonical encoding of [S]B + [k](-A), k = SHA-512(R || A || M) mod L,
  equals R's 32 bytes.

It shares no code with the program under test and imports nothing of it.
`verify_lax` drops the first three rules (S taken mod L, no small-order
or canonical checks): it is not the reference, only the tests' witness
that the corpus holds rows on which strictness matters.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)


def _x_from_y(y: int, sign: int):
    """x with x^2 = (y^2 - 1) / (d y^2 + 1) and parity `sign`, or None."""
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    vx2 = v * x * x % P
    if vx2 == (P - u) % P:
        x = x * SQRT_M1 % P
    elif vx2 != u:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return x


def _point(x: int, y: int):
    return (x, y, 1, x * y % P)


def _add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _double(p):
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = h - (x1 + y1) * (x1 + y1) % P
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _encode(p) -> bytes:
    x, y, z, _ = p
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | (x & 1) << 255).to_bytes(32, "little")


_IDENTITY = (0, 1, 1, 0)
_BY = 4 * pow(5, P - 2, P) % P
_B = _point(_x_from_y(_BY, 0), _BY)


def _table(p):
    """[0]p, [1]p, ..., [15]p."""
    out = [_IDENTITY, p]
    for _ in range(14):
        out.append(_add(out[-1], p))
    return out


_B_TABLE = _table(_B)

# y of the points of order 1, 2, 4 and 8, and the non-canonical encodings
# of 0 and 1 (p and p + 1): libsodium's small-order blocklist
_SMALL_ORDER_Y = frozenset(
    [0, 1, P - 1, P, P + 1]
    + [int.from_bytes(bytes.fromhex(h), "little") for h in (
        "26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05",
        "c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac037a")])

_Y_MASK = (1 << 255) - 1


def _small_order(enc: bytes) -> bool:
    return int.from_bytes(enc, "little") & _Y_MASK in _SMALL_ORDER_Y


def _double_scalarmult(s: int, k: int, a) -> bytes:
    """Encoding of [s]B + [k]a, four bits at a time from the top."""
    a_table = _table(a)
    acc = _IDENTITY
    for shift in range(252, -4, -4):
        if acc is not _IDENTITY:
            acc = _double(_double(_double(_double(acc))))
        ds, dk = (s >> shift) & 15, (k >> shift) & 15
        if ds:
            acc = _add(acc, _B_TABLE[ds])
        if dk:
            acc = _add(acc, a_table[dk])
    return _encode(acc)


def _neg_a(pub: bytes):
    """-A, or None where A's encoding is not canonical or not a point."""
    raw = int.from_bytes(pub, "little")
    y = raw & _Y_MASK
    if y >= P:
        return None
    x = _x_from_y(y, raw >> 255)
    if x is None:
        return None
    return _point((P - x) % P, y)


def _k(sig: bytes, pub: bytes, msg: bytes) -> int:
    return int.from_bytes(
        hashlib.sha512(sig[:32] + pub + msg).digest(), "little") % L


def verify(pub: bytes, sig: bytes, msg: bytes) -> bool:
    """Strict verdict on one (public key, signature, message)."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L or _small_order(sig[:32]) or _small_order(pub):
        return False
    neg_a = _neg_a(pub)
    if neg_a is None:
        return False
    return _double_scalarmult(s, _k(sig, pub, msg), neg_a) == sig[:32]


def verify_lax(pub: bytes, sig: bytes, msg: bytes) -> bool:
    """The equation alone: S reduced mod L, no canonical or small-order
    check (for the tests only)."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    raw = int.from_bytes(pub, "little")
    x = _x_from_y(raw & _Y_MASK, raw >> 255)
    if x is None:
        return False
    neg_a = _point((P - x) % P, (raw & _Y_MASK) % P)
    s = int.from_bytes(sig[32:], "little") % L
    return _double_scalarmult(s, _k(sig, pub, msg), neg_a) == sig[:32]
