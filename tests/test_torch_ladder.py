"""The plain version of the ladder kernel (ladder.ladder_plain) against
the JAX package's Pallas ladder (interpret mode, blk=8) followed by
fe8.to_canonical: identical canonical (x, y) bytes on every lane, on the
prepared inputs of tests/test_tpu_verifier.py's Pallas test plus lanes
whose S is at least 2^253 (the ladder covers all 256 bits); against the
oracle's point arithmetic on edge scalars; and the signed radix-16
recoding the kernel and the plain version share. Exact."""

import hashlib

import numpy as np
import pytest
import torch

from stellar_core_tpu.crypto import ed25519_ref as ref
from stellar_core_tpu.crypto.keys import SecretKey
from stellar_core_tpu.ops import ed25519_pallas as ep
from stellar_core_tpu.ops import fe8
from stellar_core_tpu.ops.verifier import host_prepare
from stellar_core_tpu_torch.ops import ed25519_kernel as EK
from stellar_core_tpu_torch.ops import field as F
from stellar_core_tpu_torch.ops import ladder as LD
from stellar_core_tpu_torch.ops.testvectors import edge_scalar_lanes
from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def prepared():
    """16 lanes: the 8 of test_pallas_ladder_interpret_matches_oracle
    (one S corrupted), then the same 8 with S replaced by values >= 2^253
    (S + 2^253 * j, S + 8L, and 2^256 - 1)."""
    items = []
    for i in range(8):
        sk = SecretKey.pseudo_random_for_testing(9 * 1000 + i)
        msg = hashlib.sha256(b"msg%d-%d" % (9, i)).digest()
        items.append((sk.public_key().raw, sk.sign(msg), msg))
    pubs = np.frombuffer(b"".join(p for p, _, _ in items),
                         np.uint8).reshape(-1, 32).copy()
    sigs = np.frombuffer(b"".join(s for _, s, _ in items),
                         np.uint8).reshape(-1, 64).copy()
    msgs = [m for _, _, m in items]
    sigs[3, 40] ^= 0x10
    k, neg_a, ok = host_prepare(pubs, sigs, msgs)
    assert ok.all()
    big = sigs[:, 32:].copy()
    for j in range(8):
        s = int.from_bytes(big[j].tobytes(), "little")
        s = (2**256 - 1 if j == 7 else s + 8 * ref.L if j == 6
             else s + 2**253 * (j + 1))
        big[j] = np.frombuffer((s % 2**256).to_bytes(32, "little"), np.uint8)
    s_all = np.concatenate([sigs[:, 32:], big])
    assert all(int.from_bytes(x.tobytes(), "little") >= 2**253
               for x in s_all[8:])
    sigs_all = np.concatenate([sigs, np.concatenate([sigs[:, :32], big], 1)])
    return dict(s=s_all, k=np.concatenate([k, k]),
                neg_a=np.concatenate([neg_a, neg_a]), sigs=sigs_all,
                pubs=np.concatenate([pubs, pubs]), msgs=msgs + msgs)


def _jl(x):
    return np.ascontiguousarray(x.astype(np.int32).T)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pallas_args(d):
    return (_jl(d["s"]), _jl(d["k"]), _jl(d["neg_a"][:, :32]),
            _jl(d["neg_a"][:, 32:]))


@pytest.fixture(scope="module")
def plain_xy(prepared):
    """The plain ladder on all 16 lanes, once."""
    d = prepared
    return LD.ladder(_t(d["s"]), _t(d["k"]), _t(d["neg_a"][:, :32]),
                     _t(d["neg_a"][:, 32:]))


def test_plain_ladder_matches_pallas_interpret(prepared, plain_xy):
    jx, jy = ep.ladder(*_pallas_args(prepared), interpret=True, blk=8)
    want_x = F.from_jax_limbs(np.asarray(fe8.to_canonical(jx)))
    want_y = F.from_jax_limbs(np.asarray(fe8.to_canonical(jy)))
    x, y = plain_xy
    assert torch.equal(x, want_x)
    assert torch.equal(y, want_y)


def test_verifier_matches_pallas_verify_kernel(prepared):
    """The whole slice against JAX host_prepare + verify_kernel_pallas
    (interpret, blk=8; the same shapes as above, so the compiled ladder
    is reused): CudaBatchVerifier(device="cpu") gives the same verdicts,
    which are also the oracle's."""
    d = prepared
    eq = np.asarray(ep.verify_kernel_pallas(
        *_pallas_args(d), _jl(d["sigs"][:, :32]), interpret=True, blk=8))
    _, _, host_ok = host_prepare(d["pubs"], d["sigs"], d["msgs"])
    want = (eq & host_ok).tolist()
    assert want[:8] == [True, True, True, False, True, True, True, True]
    items = [(bytes(p), bytes(s), m)
             for p, s, m in zip(d["pubs"], d["sigs"], d["msgs"])]
    assert CudaBatchVerifier(device="cpu").verify_tuples(items) == want
    assert want == [ref.verify(*it) for it in items]


def test_ladder_then_finish_matches_oracle(prepared, plain_xy):
    """finish(ladder) on the 8 canonical lanes accepts exactly the
    oracle's lanes (one S was corrupted)."""
    d = prepared
    x, y = (c[:8] for c in plain_xy)
    ok = torch.ones(8, dtype=torch.uint8)
    got = EK.finish(x, y, _t(d["sigs"][:8, :32]), ok).tolist()
    assert got == [True, True, True, False, True, True, True, True]


@pytest.mark.parametrize("seed", [0, 1])
def test_recode_reconstructs_scalar(seed):
    rng = np.random.default_rng(seed)
    vals = [0, 1, ref.L - 1, 2**253, 2**256 - 1] + [
        int.from_bytes(rng.integers(0, 256, 32).astype(np.uint8).tobytes(),
                       "little") for _ in range(16)]
    b = torch.tensor([list(v.to_bytes(32, "little")) for v in vals],
                     dtype=torch.uint8)
    d = LD.recode(b)
    assert d.shape == (len(vals), LD.WINDOWS)
    assert int(d.min()) >= -8 and int(d.max()) <= 8
    assert set(d[:, 64].tolist()) <= {0, 1}
    assert [sum(x << (4 * i) for i, x in enumerate(row))
            for row in d.tolist()] == vals


def test_plain_ladder_matches_oracle_on_edge_scalars(monkeypatch):
    """S and k over 0, 1, L-1 and 2^256-1 against each other, with valid
    -A: the affine [S]B + [k](-A) of crypto/ed25519_ref. The same run
    counts the field products of the plain version, which follows the
    kernel's schedule: LADDER_MULS multiplies and LADDER_SQS squarings
    (chip_smoke.py prints LADDER_PRODUCTS as the schedule's count)."""
    counts = {"mul": 0, "sq": 0}
    mul, sq = F.mul, F.sq

    def count(name, fn):
        def wrapped(*a):
            counts[name] += 1
            return fn(*a)
        return wrapped
    monkeypatch.setattr(F, "mul", count("mul", mul))
    monkeypatch.setattr(F, "sq", count("sq", sq))
    e = edge_scalar_lanes()
    edges = (0, 1, ref.L - 1, 2**256 - 1)
    pairs = [(int.from_bytes(sr.tobytes(), "little"),
              int.from_bytes(kr.tobytes(), "little"))
             for sr, kr in zip(e["s"], e["k"])]
    assert pairs == [(a, b) for a in edges for b in edges]
    want = []
    for (sv, kv), pt in zip(pairs, e["points"]):
        w = ref.pt_add(ref.pt_mul(sv, ref.BASE),
                       ref.pt_mul(kv, ref.pt_neg(pt)))
        wzi = pow(w[2], ref.P - 2, ref.P)
        want.append((w[0] * wzi % ref.P, w[1] * wzi % ref.P))
    x, y = LD.ladder(*(_t(e[key]) for key in ("s", "k", "neg_ax", "neg_ay")))
    got = [(int.from_bytes(bytes(a.tolist()), "little"),
            int.from_bytes(bytes(b.tolist()), "little")) for a, b in zip(x, y)]
    assert got == want
    assert (counts["mul"], counts["sq"]) == (LD.LADDER_MULS, LD.LADDER_SQS)
    assert LD.LADDER_PRODUCTS == 252290


def test_wrapper_checks_inputs():
    z = torch.zeros((4, 32), dtype=torch.uint8)
    with pytest.raises(ValueError):
        LD.ladder(z, z, z, torch.zeros((4, 31), dtype=torch.uint8))
    with pytest.raises(ValueError):
        LD.ladder(z, z, z, z.to(torch.int32))
    with pytest.raises(ValueError):
        LD.ladder(z, z, z, torch.zeros((32, 4), dtype=torch.uint8).T)
