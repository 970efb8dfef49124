"""The port's GF(2^255-19) (stellar_core_tpu_torch/ops/field.py) against
Python ints and the JAX package's fe8, plus the executable limb-bound
proof for the field code both CUDA kernels run.

All comparisons are exact (tolerance 0: integer arithmetic).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import stellar_core_tpu.ops.fe8 as fe8
from stellar_core_tpu_torch.ops import ed25519_kernel as EK
from stellar_core_tpu_torch.ops import field as F
from stellar_core_tpu_torch.ops import ladder as LD

P = F.P
CSRC = Path(F.__file__).parent / "csrc"
EDGES = (0, 1, P - 1, P, P + 1, 2 * P - 1, 19, 38)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _enc(vals):
    return torch.tensor([list(v.to_bytes(32, "little")) for v in vals],
                        dtype=torch.uint8)


def _ints(b):
    return [int.from_bytes(bytes(row.tolist()), "little") for row in b]


def _to_int(h):
    """Limbs (tensors) -> Python ints per lane, not reduced."""
    rows = [x.tolist() for x in h]
    return [sum(r[j] << o for r, o in zip(rows, F.OFFSETS))
            for j in range(len(rows[0]))]


def _jax_limbs(vals):
    """(32,B) int32 byte limbs of values < 2^256 (the fe8 layout)."""
    return np.array([[(v >> (8 * i)) & 0xFF for v in vals]
                     for i in range(32)], dtype=np.int32)


def _random(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.integers(0, 256, 32).astype(np.uint8)
                           .tobytes(), "little") & ((1 << 255) - 1)
            for _ in range(n)]


# ------------------------------------------------------- exact values ----

def test_mul_sq_sub_vs_python_ints():
    a_v = _random(16, 1) + [P - 1, 2**255 - 1, 0, 1]
    b_v = _random(16, 2) + [P - 1, 2**255 - 1, 1, 0]
    a, b = F.from_bytes(_enc(a_v)), F.from_bytes(_enc(b_v))
    m = F.mul(a, b)
    assert [x % P for x in _to_int(m)] == \
        [(x * y) % P for x, y in zip(a_v, b_v)]
    assert _ints(F.to_bytes(m)) == [(x * y) % P for x, y in zip(a_v, b_v)]
    assert _ints(F.to_bytes(F.sq(a))) == [(x * x) % P for x in a_v]
    assert _ints(F.to_bytes(F.sub(a, b))) == \
        [(x - y) % P for x, y in zip(a_v, b_v)]
    assert _ints(F.to_bytes(F.add(a, b))) == \
        [(x + y) % P for x, y in zip(a_v, b_v)]


def test_sq_equals_mul_limbs():
    """The 55-product squaring gives the limbs of mul(a, a) exactly (not
    only mod p), and a^2 mod p, on random signed limbs anywhere in WIDE
    and on edge limbs (the bounds of WIDE, 0, +-1, mixed signs)."""
    rng = np.random.default_rng(11)
    cols = rng.integers(-2**27, 2**27 + 1, (10, 64)).tolist()
    for lo, hi in ((-2**27, 2**27), (2**27, 2**27), (-2**27, -2**27),
                   (0, 0), (1, -1), (2**27, -2**27)):
        for i in range(10):
            cols[i] += [lo if i % 2 else hi, hi if i % 3 else lo]
    a = tuple(torch.tensor(c, dtype=torch.int64) for c in cols)
    got, want = F.sq(a), F.mul(a, a)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [x % P for x in _to_int(got)] == [x * x % P for x in _to_int(a)]


def test_invert_and_pow_p58_vs_python_ints():
    vals = _random(6, 3) + [1, 2, P - 1]
    z = F.from_bytes(_enc(vals))
    assert _ints(F.to_bytes(F.invert(z))) == \
        [pow(v, P - 2, P) for v in vals]
    assert _ints(F.to_bytes(F.pow_p58(z))) == \
        [pow(v, (P - 5) // 8, P) for v in vals]


def test_to_bytes_edges():
    """Values straddling p, as tests/test_tpu_verifier.py's edge list;
    values >= 2^255 enter as loose limbs (from_bytes drops bit 255)."""
    limbs = tuple(torch.tensor([v >> o if i == 9 else (v >> o) & ((1 << w) - 1)
                                for v in EDGES], dtype=torch.int64)
                  for i, (o, w) in enumerate(zip(F.OFFSETS, F.WIDTHS)))
    assert _to_int(limbs) == list(EDGES)
    assert _ints(F.to_bytes(limbs)) == [v % P for v in EDGES]


def test_matches_fe8_mul_sq_invert_canonical():
    """Same numbers through fe8 (mul/sq then to_canonical) and the port:
    identical canonical bytes, B = 8. The inversion chain is held against
    Python ints above, and against fe8's own chain (fe8.nsquare/mul, as
    fe8.invert runs them) through decompress_neg in test_torch_prep.py;
    a second eager fe8 chain here would cost about 12 s."""
    import jax.numpy as jnp
    a_v = _random(6, 4) + [P - 1, 19]
    b_v = _random(6, 5) + [38, P - 2]
    ja, jb = jnp.asarray(_jax_limbs(a_v)), jnp.asarray(_jax_limbs(b_v))
    a, b = F.from_bytes(_enc(a_v)), F.from_bytes(_enc(b_v))
    pairs = (
        (fe8.to_canonical(fe8.mul(ja, jb)), F.to_bytes(F.mul(a, b))),
        (fe8.to_canonical(fe8.sq(ja)), F.to_bytes(F.sq(a))),
    )
    for want, got in pairs:
        assert torch.equal(F.from_jax_limbs(np.asarray(want)), got)


def test_layout_helpers_round_trip():
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, (32, 5)).astype(np.int32)
    t = F.from_jax_limbs(x)
    assert t.shape == (5, 32) and t.dtype == torch.uint8
    assert np.array_equal(F.to_jax_limbs(t), x)
    with pytest.raises(ValueError):
        F.from_jax_limbs(x + 256)


# ------------------------------------------ constants in the CUDA source --

def _c_table(name):
    src = (CSRC / "ed25519.cu").read_text()
    m = re.search(r"__constant__ \w+ " + re.escape(name)
                  + r"\[[^=]*=\s*\{(.*?)\};", src, re.S)
    assert m, name
    return [int(x, 0) for x in re.findall(r"-?0x[0-9a-f]+|-?\d+", m.group(1))]


def _words(byte_rows):
    """Little-endian 64-bit words of 32-byte values."""
    out = []
    for row in byte_rows:
        v = int.from_bytes(bytes(row), "little")
        out += [(v >> (64 * i)) & (2**64 - 1) for i in range(4)]
    return out


def _cuda_lane_schedule():
    """The prep kernel's lane schedules as csrc/field.cuh states them:
    kPrepLanes and the rules of fe_mul_lanes and fe_sq_lanes, as
    field.lane_terms' and lane_sq_terms' (c, i, k, f_scale, g_scale) per
    lane."""
    src = (CSRC / "field.cuh").read_text()
    lanes = int(re.search(r"constexpr int kPrepLanes = (\d+);", src)[1])
    for rule in ("constexpr int kLaneWrap = 11 - kPrepLanes;",
                 "q.m[k - kLaneWrap] = k + q.r < 10 ? 19 : 1;",
                 "q.dbl = 2 - (q.r & 1);",
                 "s.v[k] = out.v[(k + b) % 10];",
                 "(k >= kLaneWrap ? q.m[k - kLaneWrap] : 19)",
                 "fd[i] = (i & 1) ? f.v[i] * q.dbl : f.v[i];",
                 "const int c = kPrepLanes * t;",
                 "const int k = ((c - i) % 10 + 10) % 10;",
                 "(int64_t)fd[i] * (int64_t)(k > c ? gw[k] : gr.v[k])",
                 "const int64_t v = acc[c / kPrepLanes];",
                 "const int src = q.base + c % kPrepLanes;",
                 "return fe_carry(h);",
                 "static_assert(kPrepLanes == 2,",
                 "q.a = 1 + q.r;", "q.b = 2 - 2 * q.r;",
                 "f2[i] = 2 * f.v[i];",
                 "for (int j = 0; j < 6; j++) {",
                 "const int d = j ? j + 4 : 0;",
                 "const int i = (t + d) % 10, k = (t - d + 10) % 10;",
                 "j < 2 ? ((i & 1) ? f2[i] : f.v[i] * q.a)",
                 ": j == 2 ? ((i & 1) ? f2[i] : f.v[i]) * q.b",
                 ": ((i & 1) ? f2[i] * q.dbl : f2[i]);",
                 "(int64_t)a * (int64_t)(k > 2 * t ? gw[k] : gr.v[k])"):
        assert rule in src, rule
    sq_terms = []
    for r in range(lanes):
        lane = []
        for t in range(10 // lanes):
            for j in range(6):
                d = j + 4 if j else 0
                i, k = (t + d) % 10, (t - d) % 10
                fs = ((2 if i & 1 else 1 + r) if j < 2 else
                      (2 if i & 1 else 1) * (2 - 2 * r) if j == 2 else
                      (2 * (2 - (r & 1)) if i & 1 else 2))
                lane.append((r + 2 * t, i, k, fs,
                             (19 if k + r < 10 else 1) if k > 2 * t else 1))
        sq_terms.append(lane)
    terms = []
    for r in range(lanes):
        lane = []
        for t in range(-(-10 // lanes)):
            c = lanes * t
            if r + c >= 10:
                continue          # a slot past column 9: summed, not read
            for i in range(10):
                k = (c - i) % 10
                lane.append((r + c, i, k, (2 - (r & 1)) if i & 1 else 1,
                             (19 if k + r < 10 else 1) if k > c else 1))
        terms.append(lane)
    return lanes, terms, sq_terms


def test_cuda_constants_match_plain_values():
    lanes, terms, sq_terms = _cuda_lane_schedule()
    assert lanes == F.PREP_LANES
    assert terms == [F.lane_terms(r) for r in range(F.PREP_LANES)]
    assert sq_terms == [F.lane_sq_terms(r) for r in range(F.PREP_LANES)]
    assert [sorted({c for c, *_ in lane}) for lane in terms] == \
        [list(cols) for cols in F.PREP_LANE_COLUMNS]
    assert _c_table("C_D") == list(F.D)
    assert _c_table("C_D2") == list(F.D2)
    assert _c_table("C_SQRT_M1") == list(F.SQRT_M1)
    assert _c_table("C_NIELS_B") == [x for e in LD.NIELS_B for fe in e
                                     for x in fe]
    assert _c_table("C_L") == _words([EK._L_BYTES])
    assert _c_table("C_P") == _words([EK._P_BYTES])
    assert _c_table("C_TORSION_Y") == _words(EK.TORSION_Y_BYTES)


def test_niels_table_is_multiples_of_base():
    """B's niels table holds (y+x, y-x, 2dxy) of 1B .. 8B."""
    from stellar_core_tpu_torch.crypto import ed25519_ref as ref
    acc = ref.IDENTITY
    for ypx, ymx, xy2d in LD.NIELS_B:
        acc = ref.pt_add(acc, ref.BASE)
        zi = pow(acc[2], P - 2, P)
        x, y = acc[0] * zi % P, acc[1] * zi % P
        assert [F.const(y + x), F.const(y - x), F.const(2 * ref.D * x * y)] \
            == [ypx, ymx, xy2d]


# --------------------------------------------- limb-bound proof -----------
#
# The plain field code runs on Interval limbs: every +, -, * and >> is the
# op the kernels do, with [lo, hi] bounds. Interval() refuses any value
# outside int64; the wrappers below refuse any stored field element outside
# int32 and any multiply operand whose doubled odd limbs leave int32.

INT64 = (-2**63, 2**63 - 1)
INT32 = (-2**31, 2**31 - 1)


class Interval:
    __slots__ = ("lo", "hi")

    def __init__(self, lo, hi):
        assert lo <= hi
        assert INT64[0] <= lo and hi <= INT64[1], f"int64 overflow {lo} {hi}"
        self.lo, self.hi = lo, hi

    @staticmethod
    def of(x):
        return x if isinstance(x, Interval) else Interval(x, x)

    def __add__(self, o):
        o = Interval.of(o)
        return Interval(self.lo + o.lo, self.hi + o.hi)

    __radd__ = __add__

    def __sub__(self, o):
        o = Interval.of(o)
        return Interval(self.lo - o.hi, self.hi - o.lo)

    def __rsub__(self, o):
        return Interval.of(o) - self

    def __mul__(self, o):
        o = Interval.of(o)
        c = [self.lo * o.lo, self.lo * o.hi, self.hi * o.lo, self.hi * o.hi]
        return Interval(min(c), max(c))

    __rmul__ = __mul__

    def __rshift__(self, w):
        return Interval(self.lo >> w, self.hi >> w)


def _icarry(x, w, half):
    """_carry on intervals, keeping the carry/remainder correlation."""
    c = (x + half) >> w
    if not isinstance(c, Interval) or c.lo == c.hi:
        return c, x - c * (1 << w)
    return c, Interval(-half, (1 << w) - half - 1)


def _fits32(fe):
    for x in fe:
        x = Interval.of(x)
        assert INT32[0] <= x.lo and x.hi <= INT32[1], (x.lo, x.hi)
    return fe


def hull(*fes):
    return tuple(Interval(min(Interval.of(x).lo for x in col),
                          max(Interval.of(x).hi for x in col))
                 for col in zip(*fes))


def within(a, b):
    return all(Interval.of(x).lo >= y.lo and Interval.of(x).hi <= y.hi
               for x, y in zip(a, b))


@pytest.fixture
def interval_field(monkeypatch):
    mul, sq, add, sub = F.mul, F.sq, F.add, F.sub

    def checked_mul(f, g):
        assert within(f, WIDE) and within(g, WIDE)
        _fits32(f)
        for x in g:        # the kernel doubles odd limbs of g in int32
            x = Interval.of(x)
            assert -2**30 <= x.lo and x.hi < 2**30
        return _fits32(mul(f, g))

    def checked_sq(f):
        assert within(f, WIDE)
        for x in f:        # the kernel doubles every limb in int32
            x = Interval.of(x)
            assert -2**30 <= x.lo and x.hi < 2**30
        return _fits32(sq(f))

    monkeypatch.setattr(F, "_carry", _icarry)
    monkeypatch.setattr(F, "mul", checked_mul)
    monkeypatch.setattr(F, "sq", checked_sq)
    monkeypatch.setattr(F, "add", lambda a, b: _fits32(add(a, b)))
    monkeypatch.setattr(F, "sub", lambda a, b: _fits32(sub(a, b)))
    out = F.mul(WIDE, WIDE)
    assert within(F.sq(WIDE), out)
    return out                        # MUL_OUT: the bound of every product


BYTES = tuple(Interval(0, (1 << w) - 1) for w in F.WIDTHS)   # from_bytes
# every multiply operand of both kernels lies in WIDE (checked_mul asserts
# it), so every product lies in MUL_OUT
WIDE = tuple(Interval(-2**27, 2**27) for _ in range(10))


def _canon_ok(h):
    """canon_limbs preconditions: the 8p bias makes every limb >= 0."""
    for x, b in zip(h, F._BIAS8P):
        assert Interval.of(x).lo + b >= 0
    F.canon_limbs(h)


def test_mul_output_bound(interval_field):
    """Every product and squaring lies in MUL_OUT (interval arithmetic is
    monotone and every operand lies in WIDE), and MUL_OUT lies in WIDE."""
    mul_out = interval_field
    assert within(mul_out, WIDE)
    assert max(max(-x.lo, x.hi) for x in mul_out) <= 2**25 + 2**6


def _pm_hull(entries):
    """Hull of table entries and their negations (y+x and y-x swapped,
    the 2d term negated), as the kernel selects them."""
    neg = [(e[1], e[0], F.sub(F.ZERO, e[2])) + tuple(e[3:]) for e in entries]
    return tuple(hull(*cols) for cols in zip(*(list(entries) + neg)))


def test_ladder_op_sequence_bounds(interval_field):
    """One window of the ladder (three doublings without T, one with T,
    the niels mixed addition over the hull of B's +-table, the cached
    addition over the hull of -A's +-table built from any 32-byte -A)
    maps the mul-output bound into itself, so all 65 windows stay in
    range; the identity, Z^-1 and the output do too."""
    m = interval_field
    tab_a = LD.neg_a_table(BYTES, BYTES)
    q_a = _pm_hull([LD.IDENT_CACHED] + tab_a)
    q_b = _pm_hull([LD.IDENT_NIELS] + list(LD.NIELS_B))
    p = (m, m, m)
    for d in range(4):
        c = LD.dbl(p)
        p = LD.p1p1_to_p3(c) if d == 3 else LD.p1p1_to_p2(c)
    p = LD.p1p1_to_p3(LD.madd(p, q_b))
    p = LD.p1p1_to_p2(LD.add_cached(p, q_a))
    for coord in p:
        assert within(coord, m)
    assert within(hull(*LD.IDENT_P3), m)
    zi = F.invert(m)
    _canon_ok(F.mul(m, zi))


def test_prep_op_sequence_bounds(interval_field, monkeypatch):
    """Decompression (ed25519_kernel.recover_x / decompress_neg) on any
    32-byte input: every product and canonicalisation stays in range, and
    the prep kernel's lane products too: each operand scaled as a lane
    scales it (f by up to 4, g by 19) fits int32, and each lane's column
    sums stay in int64 (field.lane_columns and lane_sq_columns on the
    intervals)."""
    operands = []
    mul, sq = F.mul, F.sq

    def recorded_mul(f, g):
        operands.append((f, g, False))
        return mul(f, g)

    def recorded_sq(f):
        operands.append((f, f, True))
        return sq(f)
    monkeypatch.setattr(F, "mul", recorded_mul)
    monkeypatch.setattr(F, "sq", recorded_sq)
    x, vx2, u = EK.recover_x(BYTES)
    xm = F.mul(x, F.SQRT_M1)
    for h in (F.sub(vx2, u), F.add(vx2, u), hull(x, xm), BYTES,
              F.sub(F.ZERO, hull(x, xm))):
        _canon_ok(h)
    assert len(operands) == EK.PREP_SQS + EK.PREP_MULS
    for f, g, square in operands:
        _fits32(tuple(Interval.of(v) * 4 for v in f))
        _fits32(tuple(Interval.of(v) * 19 for v in g))
        for r in range(F.PREP_LANES):
            if square:
                F.lane_sq_columns(f, r)
            else:
                F.lane_columns(f, g, r)


def test_prep_runs_its_product_count(monkeypatch):
    """prep_plain (the kernel's op sequence) runs PREP_SQS squarings and
    PREP_MULS multiplies per signature; chip_smoke.py prints
    prep_products as the schedule's count and bounds prep by it."""
    counts = {"mul": 0, "sq": 0}
    mul, sq = F.mul, F.sq

    def count(name, fn):
        def wrapped(*a):
            counts[name] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(F, "mul", count("mul", mul))
    monkeypatch.setattr(F, "sq", count("sq", sq))
    z = torch.zeros((1, 32), dtype=torch.uint8)
    EK.prep_plain(z, z, z, z, EK.MODE_K)
    assert (counts["sq"], counts["mul"]) == (EK.PREP_SQS, EK.PREP_MULS)
    assert EK.prep_products(EK.MODE_MSG32) == 15909


def test_interval_model_catches_overflow(monkeypatch):
    """The model has teeth: operands of 2^29 overflow an int64 column."""
    monkeypatch.setattr(F, "_carry", _icarry)
    big = tuple(Interval(-2**29, 2**29) for _ in range(10))
    with pytest.raises(AssertionError, match="int64 overflow"):
        F.mul(big, big)
    with pytest.raises(AssertionError, match="int64 overflow"):
        F.sq(big)
