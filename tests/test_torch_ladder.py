"""The plain version of the ladder kernel (ladder.ladder_plain) against
the JAX package's Pallas ladder (interpret mode, blk=8) followed by
fe8.to_canonical: identical canonical (x, y) bytes on every lane, on the
prepared inputs of tests/test_tpu_verifier.py's Pallas test plus lanes
whose S is at least 2^253 (the ladder covers all 256 bits); against the
oracle's point arithmetic on edge scalars; and the signed radix-16
recoding the kernel and the plain version share. The verdict form
(ladder.ladder_verdict, the kernel's epilogue with the compare with R
and prep's flags) against verify_kernel_pallas AND the host's flags, on
edge rows of R and ok, and, with the launches mocked, the two kernel
wrappers a dispatch on the card reaches. Exact."""

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


@pytest.fixture(scope="module")
def pallas_eq(prepared):
    """verify_kernel_pallas (interpret, blk=8) on the 16 lanes: the
    equation match, and the host's strict flags beside it."""
    d = prepared
    eq = np.asarray(ep.verify_kernel_pallas(
        *_pallas_args(d), _jl(d["sigs"][:, :32]), interpret=True, blk=8))
    _, _, host_ok = host_prepare(d["pubs"], d["sigs"], d["msgs"])
    return eq, host_ok


@pytest.fixture
def reuse_plain_xy(prepared, plain_xy, monkeypatch):
    """ladder_plain answers from plain_xy for the fixture's lanes (R is no
    input of the ladder, so rows that differ in R or ok reuse them), so
    that the verdict tests run no plain ladder of their own."""
    d = prepared
    rows = {(bytes(s), bytes(k), bytes(a)): i for i, (s, k, a) in
            enumerate(zip(d["s"], d["k"], d["neg_a"]))}

    def lookup(s, k, nax, nay):
        idx = [rows[(bytes(s[i].tolist()), bytes(k[i].tolist()),
                     bytes(nax[i].tolist()) + bytes(nay[i].tolist()))]
               for i in range(s.shape[0])]
        return plain_xy[0][idx], plain_xy[1][idx]
    monkeypatch.setattr(LD, "ladder_plain", lookup)


def _encoding(x, y):
    """Independent of the port: y with x's parity in bit 255, (n,32)."""
    enc = y.numpy().copy()
    enc[:, 31] |= (x.numpy()[:, 0] & 1) << 7
    return enc


def test_plain_ladder_matches_pallas_interpret(prepared, plain_xy):
    jx, jy = ep.ladder(*_pallas_args(prepared), interpret=True, blk=8)
    want_x = F.from_jax_limbs(np.asarray(fe8.to_canonical(jx)))
    want_y = F.from_jax_limbs(np.asarray(fe8.to_canonical(jy)))
    x, y = plain_xy
    assert torch.equal(x, want_x)
    assert torch.equal(y, want_y)


def test_verifier_matches_pallas_verify_kernel(prepared, pallas_eq):
    """The whole slice against JAX host_prepare + verify_kernel_pallas
    (interpret, blk=8; the same shapes as above, so the compiled ladder
    is reused): CudaBatchVerifier(device="cpu") gives the same verdicts,
    which are also the oracle's."""
    d = prepared
    eq, host_ok = pallas_eq
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
    got = LD.finish(x, y, _t(d["sigs"][:8, :32]), ok).tolist()
    assert got == [True, True, True, False, True, True, True, True]


def test_verdict_matches_pallas_verify_kernel_and_host_flags(
        prepared, plain_xy, pallas_eq, reuse_plain_xy):
    """ladder_verdict's CPU path (the kernel's plain version, prep's
    (n,64) -A read in place) equals verify_kernel_pallas AND the host's
    flags on all 16 lanes, and the oracle; the x and y it compared are
    the plain ladder's."""
    d = prepared
    eq, host_ok = pallas_eq
    ok = _t(host_ok.astype(np.uint8))
    got, x, y = LD.ladder_verdict(_t(d["s"]), _t(d["k"]), _t(d["neg_a"]),
                                  _t(d["sigs"][:, :32]), ok, xy=True)
    assert got.dtype == torch.bool
    assert got.tolist() == (eq & host_ok).tolist()
    assert got.tolist() == [ref.verify(bytes(p), bytes(s), m) for p, s, m
                            in zip(d["pubs"], d["sigs"], d["msgs"])]
    assert torch.equal(x, plain_xy[0]) and torch.equal(y, plain_xy[1])


def _edge_rows(case, enc, r):
    """(R, ok, want) for one edge case over the 16 lanes: R from the
    lanes' own R or the encoding the ladder gives, ok None or uint8."""
    n = enc.shape[0]
    ones = np.ones(n, np.uint8)
    if case == "r_sign_flipped":
        r2 = enc.copy()
        r2[:, 31] ^= 0x80
        return r2, ones, np.zeros(n, bool)
    if case == "r_is_encoding_ok_0":
        ok = np.zeros(n, np.uint8)
        ok[::3] = 1
        return enc, ok, ok.astype(bool)
    if case == "r_byte_0":
        r2 = enc.copy()
        r2[:, 0] ^= 1
        return r2, ones, np.zeros(n, bool)
    if case == "r_byte_31_low_bits":
        r2 = enc.copy()
        r2[:, 31] ^= np.arange(1, n + 1, dtype=np.uint8) & 0x7F
        return r2, ones, np.zeros(n, bool)
    # the v1 form: no flags, the lanes' own R
    return r, None, (enc == r).all(1)


@pytest.mark.parametrize("case", ["r_sign_flipped", "r_is_encoding_ok_0",
                                  "r_byte_0", "r_byte_31_low_bits",
                                  "v1_no_flags"])
def test_verdict_on_edge_rows(prepared, plain_xy, pallas_eq,
                              reuse_plain_xy, case):
    """Rows built from the same lanes: R with its sign bit flipped, R
    equal to the encoding with ok 0 on two lanes of three, R off in byte 0
    or in byte 31's low bits (each with ok 1): the verdict is exactly
    (R == encoding) AND ok. With ok None (the v1 form) it is the
    equation alone, verify_kernel_pallas's match."""
    d = prepared
    enc = _encoding(*plain_xy)
    r, ok, want = _edge_rows(case, enc, d["sigs"][:, :32].copy())
    got = LD.ladder_verdict(_t(d["s"]), _t(d["k"]), _t(d["neg_a"]), _t(r),
                            None if ok is None else _t(ok))
    assert got.tolist() == want.tolist()
    if case == "v1_no_flags":
        assert got.tolist() == pallas_eq[0].tolist()
        assert EK.verify_kernel(
            _t(d["s"]), _t(d["k"]), _t(d["neg_a"][:, :32]),
            _t(d["neg_a"][:, 32:]), _t(r)).tolist() == want.tolist()


def test_dispatch_on_a_card_reaches_two_kernel_wrappers(monkeypatch):
    """With the launches mocked and the inputs reported on a card: each
    device entry reaches ed25519_prep (not the v1 entry) then
    ed25519_ladder, in its verdict form, with prep's -A and ok as prep
    returned them (no copy) and R as given; no plain version runs and
    each launch counter moves by one."""
    from stellar_core_tpu_torch.ops import _build
    cuda = torch.device("cuda", 0)
    calls = []

    def plain(name):
        def refuse(*a, **kw):
            raise AssertionError(f"{name} ran on a card's tensors")
        return refuse
    for mod, name in ((LD, "ladder_plain"), (LD, "ladder_verdict_plain"),
                      (LD, "ladder_windows_plain"), (LD, "finish"),
                      (LD, "encodes_r"), (EK, "prep_plain")):
        monkeypatch.setattr(mod, name, plain(name))
    monkeypatch.setattr(_build, "lib", lambda defines=(): "lib")
    monkeypatch.setattr(LD, "_check", lambda name, *ts: cuda)
    monkeypatch.setattr(EK, "_check", lambda name, *ts: cuda)
    monkeypatch.setattr(LD, "_verdict_inputs",
                        lambda name, dev, n, neg_a, ok: (None, None))

    def launch_prep(lib, a, r, s, mk, mode):
        out = (torch.zeros_like(a), torch.zeros((a.shape[0], 64),
                                                dtype=torch.uint8),
               torch.ones(a.shape[0], dtype=torch.uint8))
        calls.append(("prep", mode, out))
        return out

    def launch_ladder(lib, s, k, neg_a, r=None, ok=None, xy=False,
                      windows_only=False):
        calls.append(("ladder", k, neg_a, r, ok, xy, windows_only))
        return torch.zeros(s.shape[0], dtype=torch.bool), None, None
    monkeypatch.setattr(EK, "launch_prep", launch_prep)
    monkeypatch.setattr(LD, "launch_ladder", launch_ladder)
    z = [torch.zeros((3, 32), dtype=torch.uint8) for _ in range(4)]
    for entry, mode in ((EK.verify_kernel_msg32, EK.MODE_MSG32),
                        (EK.verify_kernel_full, EK.MODE_K)):
        calls.clear()
        before = (EK.prep.launches, LD.ladder.launches)
        entry(*z)
        assert [c[0] for c in calls] == ["prep", "ladder"]
        k, neg_a, ok = calls[0][2]
        assert calls[0][1] == mode
        _, k_in, neg_a_in, r_in, ok_in, xy, windows_only = calls[1]
        assert k_in is k and neg_a_in is neg_a and ok_in is ok
        assert r_in is z[1] and not xy and not windows_only
        assert (EK.prep.launches, LD.ladder.launches) == (before[0] + 1,
                                                          before[1] + 1)
    calls.clear()
    EK.verify_kernel(*z, z[1])
    assert [c[0] for c in calls] == ["ladder"]
    _, k_in, (nax, nay), r_in, ok_in, _, _ = calls[0]
    assert k_in is z[1] and nax is z[2] and nay is z[3] and r_in is z[1]
    assert ok_in is None


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
