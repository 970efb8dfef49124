"""The prep kernel's lane schedules (ops/field.py PREP_LANE_COLUMNS,
lane_terms, lane_sq_terms, lane_columns, lane_sq_columns; csrc/field.cuh
fe_mul_lanes, fe_sq_lanes): the lanes of a group own every folded column
once and sum every limb product once, a multiply's 100 at fe_mul's
weights and a squaring's 55 at fe_sq's, so the columns they exchange are
exactly the integers field.mul and field.sq carry. Exact comparisons
(integer arithmetic); tests/test_torch_field.py holds the CUDA source's
schedules to these and bounds the scaled operands. Also the CPU side of
scripts/prep_sweep.py.
"""

import collections
import os
import subprocess
import sys

import numpy as np
import torch

from stellar_core_tpu_torch.ops import ed25519_kernel as EK
from stellar_core_tpu_torch.ops import field as F
from stellar_core_tpu_torch.ops import testvectors
from stellar_core_tpu_torch.scripts import prep_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _weight(i, j):
    """fe_mul's weight of f_i g_j in its folded column (i + j) % 10."""
    return (2 if i & 1 and j & 1 else 1) * (19 if i + j >= 10 else 1)


def test_lanes_own_every_column_once():
    owned = [c for cols in F.PREP_LANE_COLUMNS for c in cols]
    assert sorted(owned) == list(range(10))
    assert all(c % F.PREP_LANES == r
               for r, cols in enumerate(F.PREP_LANE_COLUMNS) for c in cols)


def test_lanes_sum_every_product_of_a_multiply_once():
    """The 100 (i, j) of f * g, each on one lane, in column (i + j) % 10,
    at fe_mul's weight; every lane runs as many products."""
    seen = collections.Counter()
    for r in range(F.PREP_LANES):
        terms = F.lane_terms(r)
        assert len(terms) == 10 * len(F.PREP_LANE_COLUMNS[r])
        for c, i, k, fs, gs in terms:
            j = (k + r) % 10
            assert c == (i + j) % 10 and fs * gs == _weight(i, j)
            seen[i, j] += 1
    assert seen == {(i, j): 1 for i in range(10) for j in range(10)}
    assert sum(len(F.lane_terms(r)) for r in range(F.PREP_LANES)) == 100


def test_lanes_sum_each_of_a_squarings_55_products_once():
    """Each of the 55 products f_i f_j (i <= j) of a squaring on one lane,
    once, in column (i + j) % 10, at fe_sq's weight (doubled off the
    diagonal); the only other terms are the five the odd lane weights 0,
    which repeat a pair it sums; each lane runs six per column."""
    seen = collections.Counter()
    zero = []
    for r in range(F.PREP_LANES):
        terms = F.lane_sq_terms(r)
        assert len(terms) == 6 * len(F.PREP_LANE_COLUMNS[r])
        for c, i, k, fs, gs in terms:
            j = (k + r) % 10
            assert c == (i + j) % 10
            if fs == 0:
                zero.append((r, min(i, j), max(i, j)))
                continue
            assert fs * gs == _weight(i, j) * (1 if i == j else 2)
            seen[min(i, j), max(i, j)] += 1
    assert seen == {(i, j): 1 for i in range(10) for j in range(i, 10)}
    assert len(zero) == 5 and all(r == 1 and seen[i, j] for r, i, j in zero)
    assert EK.prep_kernel_products(EK.MODE_MSG32) == \
        60 * EK.PREP_SQS + 100 * EK.PREP_MULS + EK.SC_REDUCE_MULS


def _limbs(rng, n, bound):
    return tuple(torch.tensor(rng.integers(-bound, bound + 1, n),
                              dtype=torch.int64) for _ in range(10))


def _edges(n_each=4):
    """Limbs at the prep operands' extremes: from_bytes's [0, 2^w), the
    carried outputs' +-2^(w-1) and more, mixed signs, 0 and +-1."""
    cols = [[] for _ in range(10)]
    for lo, hi in ((0, 2**26 - 1), (-2**25 - 2**6, 2**25 + 2**6),
                   (2**26 - 1, -2**25), (0, 0), (1, -1)):
        for i in range(10):
            w = F.WIDTHS[i]
            cols[i] += [min(hi, 2**w - 1) if i % 2 else lo,
                        lo if i % 3 else min(hi, 2**w - 1)] * (n_each // 2)
    return tuple(torch.tensor(c, dtype=torch.int64) for c in cols)


def _gathered(lane_cols):
    cols = {}
    for r in range(F.PREP_LANES):
        cols.update(lane_cols(r))
    return [cols[c] for c in range(10)]


def test_gathered_lane_columns_are_mul_and_sq_columns():
    """Seeded random limbs anywhere in the operands' range and the edge
    limbs: the lanes' columns, gathered, are mul_columns and sq_columns
    exactly, so the carry gives field.mul's and field.sq's limbs."""
    rng = np.random.default_rng(16)
    for f, g in ((_limbs(rng, 64, 2**26), _limbs(rng, 64, 2**26)),
                 (_edges(), tuple(x.flip(0) for x in _edges()))):
        got = _gathered(lambda r: F.lane_columns(f, g, r))
        assert all(torch.equal(a, b) for a, b in zip(got, F.mul_columns(f, g)))
        assert all(torch.equal(a, b) for a, b in zip(F.carry(got), F.mul(f, g)))
        got = _gathered(lambda r: F.lane_sq_columns(f, r))
        assert all(torch.equal(a, b) for a, b in zip(got, F.sq_columns(f)))
        assert all(torch.equal(a, b) for a, b in zip(F.carry(got), F.sq(f)))


def test_prep_sweep_rows_are_seeded_and_hold_the_corpus():
    pubs, sigs, msgs, m32 = prep_sweep.rows(300, testvectors)
    again = prep_sweep.rows(300, testvectors)
    assert all(np.array_equal(a, b) for a, b in
               zip((pubs, sigs, m32), (again[0], again[1], again[3])))
    assert msgs == again[2] and pubs.shape == (300, 32)
    corpus = {p for p, _, _ in testvectors.make_differential_vectors(40)}
    assert corpus <= {bytes(p) for p in pubs}


def test_prep_sweep_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m",
                          "stellar_core_tpu_torch.scripts.prep_sweep",
                          "--rounds", "1", "--n", "1"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and res.stdout == ""
