"""The plain version of the prep kernel (ed25519_kernel.prep_plain)
against the JAX package, on a small differential corpus, in both modes:
JAX k_mod_l_96, decompress_neg (canonicalised, on valid lanes), the six
strict flags of _verify_full, and verifier.host_prepare. Exact."""

import numpy as np
import pytest
import torch

from stellar_core_tpu.ops import ed25519_kernel as jek
from stellar_core_tpu.ops import fe8
from stellar_core_tpu.ops import sha512 as jsha
from stellar_core_tpu.ops.testvectors import make_differential_vectors
from stellar_core_tpu.ops.verifier import host_prepare
from stellar_core_tpu_torch.ops import ed25519_kernel as EK
from stellar_core_tpu_torch.ops import field as F
from stellar_core_tpu_torch.ops.verifier import host_k


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus():
    items = make_differential_vectors(10, seed=77)
    pubs = np.frombuffer(b"".join(p for p, _, _ in items),
                         np.uint8).reshape(-1, 32).copy()
    sigs = np.frombuffer(b"".join(s for _, s, _ in items),
                         np.uint8).reshape(-1, 64).copy()
    msgs = [m for _, _, m in items]
    rng = np.random.default_rng(78)
    m32 = rng.integers(0, 256, (len(items), 32)).astype(np.uint8)
    return pubs, sigs, msgs, m32


def _t(x):
    return torch.from_numpy(np.array(x))


def _jl(x):
    return np.ascontiguousarray(x.astype(np.int32).T)


def test_msg32_k_matches_jax_k_mod_l_96(corpus):
    pubs, sigs, _, m32 = corpus
    k, _, _ = EK.prep_plain(_t(pubs), _t(sigs[:, :32]), _t(sigs[:, 32:]),
                            _t(m32), EK.MODE_MSG32)
    want = np.asarray(jsha.k_mod_l_96(sigs[:, :32], pubs, m32))
    assert torch.equal(k, F.from_jax_limbs(want))


@pytest.fixture(scope="module")
def jax_prep(corpus):
    """JAX decompress_neg (canonicalised) and the six flags, once."""
    pubs, sigs, _, _ = corpus
    a_b, r_b, s_b = _jl(pubs), _jl(sigs[:, :32]), _jl(sigs[:, 32:])
    sign_a = a_b[31] >> 7
    y_a = a_b.copy()
    y_a[31] &= 0x7F
    y_r = r_b.copy()
    y_r[31] &= 0x7F
    neg_ax, ay, a_valid = jek.decompress_neg(y_a, sign_a)
    a_valid = np.array(a_valid)
    flags = (np.asarray(jek._lt_const(s_b, jek._L_BYTES))
             & np.asarray(jek._lt_const(y_a, jek._P_BYTES))
             & ~np.asarray(jek._is_torsion_y(y_a)) & a_valid
             & np.asarray(jek._lt_const(y_r, jek._P_BYTES))
             & ~np.asarray(jek._is_torsion_y(y_r)))
    return (F.from_jax_limbs(np.asarray(fe8.to_canonical(neg_ax))),
            F.from_jax_limbs(np.asarray(fe8.to_canonical(ay))),
            torch.from_numpy(a_valid), flags)


@pytest.mark.parametrize("mode", [EK.MODE_MSG32, EK.MODE_K])
def test_flags_and_decompress_match_jax(corpus, jax_prep, mode):
    pubs, sigs, msgs, m32 = corpus
    mk = m32 if mode == EK.MODE_MSG32 else host_k(pubs, sigs, msgs)
    k, neg_a, ok = EK.prep_plain(_t(pubs), _t(sigs[:, :32]),
                                 _t(sigs[:, 32:]), _t(mk), mode)
    if mode == EK.MODE_K:
        assert torch.equal(k, _t(mk))
    nx, yy, lanes, flags = jax_prep
    assert ok.numpy().astype(bool).tolist() == flags.tolist()
    # the corpus reaches both outcomes of every check
    assert 0 < int(ok.sum()) < len(ok)
    assert torch.equal(neg_a[lanes, :32], nx[lanes])
    assert torch.equal(neg_a[lanes, 32:], yy[lanes])


def test_matches_host_prepare(corpus):
    """Where host_prepare accepts, (k, neg_a) agree and prep accepts;
    prep never rejects a lane host_prepare accepts. (host_prepare also
    decompresses R; prep leaves an off-curve R to the final compare.)"""
    pubs, sigs, msgs, _ = corpus
    hk, hneg, hok = host_prepare(pubs, sigs, msgs)
    k, neg_a, ok = EK.prep_plain(_t(pubs), _t(sigs[:, :32]),
                                 _t(sigs[:, 32:]),
                                 _t(host_k(pubs, sigs, msgs)), EK.MODE_K)
    hok = torch.from_numpy(np.asarray(hok, dtype=bool))
    assert bool((ok.bool() | ~hok).all())
    assert torch.equal(k[hok], _t(hk)[hok])
    assert torch.equal(neg_a[hok], _t(hneg)[hok])
    m32 = [i for i, m in enumerate(msgs) if len(m) == 32]
    sel = torch.tensor(m32)
    k32, _, ok32 = EK.prep_plain(
        _t(pubs[m32]), _t(sigs[m32, :32]), _t(sigs[m32, 32:]),
        _t(np.frombuffer(b"".join(msgs[i] for i in m32),
                         np.uint8).reshape(-1, 32)), EK.MODE_MSG32)
    assert torch.equal(ok32, ok[sel])
    lanes = hok[sel]
    assert torch.equal(k32[lanes], _t(hk)[sel][lanes])
