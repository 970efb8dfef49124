"""The port's plain SHA-512 and mod-L (stellar_core_tpu_torch/ops/sha512.py)
against hashlib, Python ints and the JAX package's sha512_96 / mod_l.
Exact comparisons (tolerance 0)."""

import hashlib

import numpy as np
import pytest
import torch

from stellar_core_tpu.ops import sha512 as jsha
from stellar_core_tpu_torch.ops import field as F
from stellar_core_tpu_torch.ops import sha512 as tsha

L = tsha.L


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mod_l_values():
    """The random and adversarial list of tests/test_tpu_verifier.py."""
    rng = np.random.default_rng(12)
    vals = [int.from_bytes(rng.integers(0, 256, 64).astype(
        np.uint8).tobytes(), "little") for _ in range(24)]
    vals += [0, 1, L - 1, L, L + 1, 2**512 - 1,
             (2**512 // L) * L, (2**512 // L) * L - 1,
             15 * L, 16 * L - 1, 2**256 - 1, 2**256, 2**269]
    return vals


def test_sha512_96_vs_hashlib_and_jax():
    rng = np.random.default_rng(11)
    r, a, m = (rng.integers(0, 256, (17, 32)).astype(np.uint8)
               for _ in range(3))
    got = tsha.sha512_96(torch.from_numpy(r), torch.from_numpy(a),
                         torch.from_numpy(m))
    assert got.shape == (17, 64) and got.dtype == torch.uint8
    for i in range(17):
        want = hashlib.sha512(r[i].tobytes() + a[i].tobytes()
                              + m[i].tobytes()).digest()
        assert bytes(got[i].tolist()) == want, i
    jgot = np.asarray(jsha.sha512_96(r, a, m))            # (64, B) int32
    assert np.array_equal(got.numpy().astype(np.int32).T, jgot)


def test_mod_l_vs_ints_and_jax():
    vals = _mod_l_values()
    d = torch.tensor([list(v.to_bytes(64, "little")) for v in vals],
                     dtype=torch.uint8)
    got = tsha.mod_l(d)
    for v, row in zip(vals, got):
        assert int.from_bytes(bytes(row.tolist()), "little") == v % L, hex(v)
    jgot = np.asarray(jsha.mod_l(d.numpy().astype(np.int32).T))
    assert torch.equal(F.from_jax_limbs(jgot), got)


def test_k_mod_l_96_vs_oracle_formula():
    rng = np.random.default_rng(13)
    r, a, m = (rng.integers(0, 256, (6, 32)).astype(np.uint8)
               for _ in range(3))
    got = tsha.k_mod_l_96(torch.from_numpy(r), torch.from_numpy(a),
                          torch.from_numpy(m))
    for i in range(6):
        h = hashlib.sha512(r[i].tobytes() + a[i].tobytes() + m[i].tobytes())
        k = int.from_bytes(h.digest(), "little") % L
        assert bytes(got[i].tolist()) == k.to_bytes(32, "little")
