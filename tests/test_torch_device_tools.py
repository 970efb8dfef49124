"""The port's device tools on the CPU: graft_entry (entry and
dryrun_multichip), the ladder's windows-only plain version, the build
module's variant keys, scaling_curve's folding and its refusal of the
reference's artifact paths, and the launch counts chip_smoke.py's phase
19 predicts.

The kernels themselves run on the card only (tests/test_torch_gpu.py,
chip_smoke.py phase 19); here the wrappers take their plain versions.
This file runs five plain-version dispatches (about 3 s each) and no
XLA compile: the reference's __graft_entry__._example_batch is host
code.
"""

import json
import os

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_graft

import chip_smoke
from stellar_core_tpu_torch import graft_entry
from stellar_core_tpu_torch.crypto import ed25519_ref as ref
from stellar_core_tpu_torch.ops import _build
from stellar_core_tpu_torch.ops import ladder as LD
from stellar_core_tpu_torch.ops import verifier as V
from stellar_core_tpu_torch.ops.testvectors import oracle_results
from stellar_core_tpu_torch.scripts import (kernel_profile, kernel_sweep,
                                            scaling_curve)


def test_entry_matches_the_reference_and_the_oracle():
    fn, args = graft_entry.entry(device="cpu")
    want = ref_graft._example_batch(128)
    assert len(args) == 4
    for got, w in zip(args, want):
        assert got.device.type == "cpu" and got.dtype == torch.uint8
        assert got.shape == (128, 32)
        assert np.array_equal(got.numpy(), w)
    pubs, sigs, msgs, k = graft_entry.example_batch(128)
    assert np.array_equal(k, want[3])
    verdicts = fn(*args).tolist()
    assert verdicts == oracle_results(
        [(pubs[i].tobytes(), sigs[i].tobytes(), msgs[i])
         for i in range(128)])
    assert verdicts == [True] * 128


def test_dryrun_on_the_cpu_runs_the_sharded_verifier_not_the_node():
    out = graft_entry.dryrun_multichip(2, device="cpu")
    assert out["node"] == "not run: device cpu"
    assert out["sharded"] == {"positions": 2, "batch": 8}
    assert out["hybrid"].startswith("not run")


@pytest.mark.parametrize("n, b", [(1, 8), (2, 8), (3, 9), (4, 8), (8, 8),
                                  (12, 12)])
def test_dryrun_batch_is_the_reference_s(n, b):
    assert graft_entry._batch_size(n) == b


def _point_bytes(v):
    return bytes(v.tolist())


def test_windows_plain_is_the_ladder_before_its_epilogue():
    """For 64 seeded rows, X Z^-1 and Y Z^-1 of ladder_windows_plain
    (Python integers mod p) are ladder_plain's x and y, which are the
    oracle's [S]B + [k](-A)."""
    rng = np.random.default_rng(17)
    n = 64
    s = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    k = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    s[:, 31] &= 0x1F            # some scalars below L, some above
    k[::2, 31] &= 0x0F
    a_pts = [ref.pt_mul(int(rng.integers(1, 2**62)), ref.BASE)
             for _ in range(n)]
    nax, nay = np.zeros((n, 32), np.uint8), np.zeros((n, 32), np.uint8)
    for i, (x, y, z, _) in enumerate(a_pts):
        zi = pow(z, ref.P - 2, ref.P)
        nax[i] = np.frombuffer(((-x * zi) % ref.P).to_bytes(32, "little"),
                               np.uint8)
        nay[i] = np.frombuffer((y * zi % ref.P).to_bytes(32, "little"),
                               np.uint8)
    args = [torch.from_numpy(a) for a in (s, k, nax, nay)]
    X, Y, Z = LD.ladder_windows_plain(*args)
    x, y = LD.ladder_plain(*args)
    for i in range(n):
        xi, yi, zi = (int.from_bytes(_point_bytes(c[i]), "little")
                      for c in (X, Y, Z))
        assert max(xi, yi, zi) < ref.P
        inv = pow(zi, ref.P - 2, ref.P)
        assert (xi * inv % ref.P).to_bytes(32, "little") == \
            _point_bytes(x[i])
        assert (yi * inv % ref.P).to_bytes(32, "little") == \
            _point_bytes(y[i])
        sa = int.from_bytes(s[i].tobytes(), "little")
        ka = int.from_bytes(k[i].tobytes(), "little")
        ax, ay, az, at = a_pts[i]
        neg_a = ((-ax) % ref.P, ay, az, (-at) % ref.P)
        want = ref.pt_add(ref.pt_mul(sa, ref.BASE), ref.pt_mul(ka, neg_a))
        wz = pow(want[2], ref.P - 2, ref.P)
        assert (xi * inv - want[0] * wz) % ref.P == 0
        assert (yi * inv - want[1] * wz) % ref.P == 0


def test_variant_keys_need_no_nvcc(monkeypatch):
    """A variant's library is keyed by its defines too; the default call
    keys exactly as an empty define set, and knob names map to macros."""
    def no_nvcc():
        raise AssertionError("the key must not run nvcc")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    default = _build._key()
    assert _build._key(()) == default
    sets = [_build.defines_of(k) for k in (
        {"kLadderThreads": 64}, {"kLadderMinBlocks": 3},
        {"kPrepMinBlocks": 4},
        {"kLadderThreads": 64, "kPrepMinBlocks": 4})]
    sets.append((_build.WINDOWS_ONLY,))
    keys = [_build._key(d) for d in sets]
    assert len(set(keys + [default])) == len(keys) + 1
    assert _build.defines_of({"kLadderMinBlocks": 3}) == \
        ("ED25519_LADDER_MIN_BLOCKS=3",)
    assert _build.defines_of({"kPrepMinBlocks": 4, "kLadderThreads": 64}) \
        == _build.defines_of({"kLadderThreads": 64, "kPrepMinBlocks": 4})
    assert _build._key(("B=1", "A")) == _build._key(("A", "B=1"))
    with pytest.raises(ValueError, match="unknown knob"):
        _build.defines_of({"kWarps": 2})


def test_sources_name_every_knob_with_today_s_default():
    """Each knob's macro is overridable in csrc/ and defaults to the
    value the main path runs."""
    src = open(os.path.join(_build.CSRC, "ed25519.cu")).read()
    defaults = {"ED25519_PREP_THREADS": 128, "ED25519_PREP_MIN_BLOCKS": 3,
                "ED25519_LADDER_THREADS": 128, "ED25519_LADDER_MIN_BLOCKS": 4}
    for macro, value in defaults.items():
        assert f"#ifndef {macro}\n#define {macro} {value}\n#endif" in src
    assert set(_build.KNOBS.values()) == set(defaults)
    assert src.count(f"#ifdef {_build.WINDOWS_ONLY}") == 3


def test_kernel_sweep_sets_parse():
    assert kernel_sweep.parse_set("kLadderThreads=64,kPrepMinBlocks=4") == \
        {"kLadderThreads": 64, "kPrepMinBlocks": 4}
    assert kernel_sweep.label({}) == "today"
    assert [kernel_sweep.label(s) for s in kernel_sweep.DEFAULT_SETS] == [
        "today", "kLadderThreads=64", "kLadderMinBlocks=3",
        "kPrepMinBlocks=4"]


def test_scaling_curve_folds_efficiency_and_projection():
    t1_of = {1024: 0.010, 512: 0.006, 256: 0.004, 128: 0.003}
    t_n = {1: 0.010, 2: 0.011, 4: 0.020, 8: 0.030}
    rows = scaling_curve.fold(t1_of, t_n, 1024)
    assert [r["ndev"] for r in rows] == [1, 2, 4, 8]
    eff = [r["sharding_efficiency"] for r in rows]
    assert eff == pytest.approx([1.0, 2 * 0.006 / 0.011, 4 * 0.004 / 0.020,
                                 8 * 0.003 / 0.030])
    assert rows[2]["t1_shard_ms"] == pytest.approx(4.0)
    assert rows[3]["rate"] == pytest.approx(1024 / 0.030)
    proj = scaling_curve.projection(rows, card_rate=2e6, native_rate=1e4)
    assert proj["vs_native"] == pytest.approx(200.0)
    assert proj["assumed_efficiency"] == pytest.approx(0.8)
    assert proj["projected_rate_8"] == pytest.approx(2e6 * 8 * 0.8)
    assert proj["cards_to_10x_vs_native"] == 1
    slow = scaling_curve.projection(rows, card_rate=2e4, native_rate=1e4)
    assert slow["cards_to_10x_vs_native"] == 7     # ceil(10 / (2 * 0.8))
    assert scaling_curve.positions(["a", "b", "c"], 8) == \
        ["a", "b", "c", "a", "b", "c", "a", "b"]


def test_scaling_curve_refuses_the_reference_s_artifact_paths(tmp_path):
    root = scaling_curve.REPO
    for name in ("SCALING_r05.json", "SCALING_r99.json", "X_r1.json"):
        with pytest.raises(SystemExit, match="refusing"):
            scaling_curve.refuse_out(os.path.join(root, name))
    for ok in (os.path.join(root, "out", "SCALING_r05.json"),
               os.path.join(root, "scaling.json"),
               str(tmp_path / "SCALING_r05.json")):
        scaling_curve.refuse_out(ok)
    with pytest.raises(SystemExit, match="refusing"):
        scaling_curve.main(["--out", os.path.join(root, "SCALING_r17.json")])
    assert not os.path.exists(os.path.join(root, "SCALING_r17.json"))


def test_scaling_rows_are_the_reference_s_with_every_97th_corrupted():
    pubs, sigs, msgs, bad = scaling_curve.make_rows(200)
    assert np.flatnonzero(bad).tolist() == [0, 97, 194]
    offsets = np.arange(201, dtype=np.uint64) * 32
    from stellar_core_tpu_torch.native.loader import get_lib
    got = get_lib().batch_verify(pubs, sigs, b"".join(msgs), offsets)
    assert (got == ~bad).all()
    held = [0, 1, 97, 150]
    assert oracle_results([(pubs[i].tobytes(), sigs[i].tobytes(), msgs[i])
                           for i in held]) == [False, True, False, True]


def test_phase_19_predictions_are_the_tools_counts():
    """chip_smoke.TOOLS_EXPECTED against the tools' own counts: the
    profile's and the curve's expected_launches, entry's one host-k
    dispatch, and the dry run's node part rehearsed here with its
    verifier's shards counted (the Application's device verifier on the
    CPU, one card seen, the native verifier answering in place of the
    plain kernels) plus its sharded and hybrid batches over four
    positions, host k."""
    prof = kernel_profile.expected_launches()
    assert chip_smoke.TOOLS_EXPECTED["kernel_profile"] == {
        "msg32": prof["prep_msg32"], "k": prof["prep_k"],
        "ladder": prof["ladder"], "windows": prof["ladder_windows"]}
    curve = scaling_curve.expected_launches()
    assert chip_smoke.TOOLS_EXPECTED["scaling_curve"] == {
        "msg32": curve, "k": 0, "ladder": curve, "windows": 0}
    assert chip_smoke.TOOLS_EXPECTED["entry"] == {
        "msg32": 0, "k": 1, "ladder": 1, "windows": 0}

    shards = []

    def counted(pubs, sigs, msgs, device_sha, sh):
        msg32 = device_sha and all(len(m) == 32 for m in msgs)
        shards.extend("msg32" if msg32 else "k" for _, c in sh if c)
        res = torch.from_numpy(np.array(
            [ref.verify(pubs[i].tobytes(), sigs[i].tobytes(), msgs[i])
             for i in range(len(msgs))]))
        return res, []
    node = _node_rehearsal(counted)
    assert node["batches"] == [4]
    n = chip_smoke.TOOLS_DRYRUN_N
    want = {"msg32": shards.count("msg32"), "k": shards.count("k") + 2 * n,
            "ladder": len(shards) + 2 * n, "windows": 0}
    assert chip_smoke.TOOLS_EXPECTED["dryrun"] == want


def _node_rehearsal(launch):
    """dryrun_multichip's node part on the CPU: the Application's
    ShardedBatchVerifier on one CPU position, torch seeing one card, its
    shards through `launch`."""
    from unittest import mock
    from stellar_core_tpu_torch.main import Application, get_test_config
    from stellar_core_tpu_torch.simulation.drive import \
        validate_txset_through_batch_verifier
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    base = V.ShardedBatchVerifier.__init__

    def on_the_cpu(self, devices=None, *args, **kwargs):
        base(self, ["cpu"] if devices is None else devices, *args, **kwargs)
    cfg = get_test_config()
    cfg.SIGNATURE_VERIFY_BACKEND = "cuda"
    cfg.SIGNATURE_VERIFY_MESH = "sharded"
    cfg.VERIFY_DEVICE_MIN_BATCH = 1      # as dryrun_multichip sets it
    with mock.patch.object(V.ShardedBatchVerifier, "__init__", on_the_cpu), \
            mock.patch.object(V, "_launch_shards", launch), \
            mock.patch("torch.cuda.device_count", lambda: 1):
        app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg)
        app.start()
        try:
            assert app.batch_verifier.ndev == 1
            return {"batches": validate_txset_through_batch_verifier(app)}
        finally:
            app.shutdown()


def test_dryrun_node_settings_are_the_rehearsal_s():
    """The rehearsal above sets what dryrun_multichip's node part sets."""
    import inspect
    src = inspect.getsource(graft_entry.dryrun_multichip)
    for line in ('cfg.SIGNATURE_VERIFY_BACKEND = "cuda"',
                 'cfg.SIGNATURE_VERIFY_MESH = "sharded"',
                 "cfg.VERIFY_DEVICE_MIN_BATCH = 1"):
        assert line in src


def test_tools_print_json_and_the_card_last(monkeypatch, capsys):
    """The tools' main: one JSON object, then the card's line last."""
    monkeypatch.setattr(kernel_sweep, "run", lambda *a, **k: {
        "card": "CARD, 700 W", "built": [{"set": "today",
                                          "checks": {200: {"prep": True,
                                                           "ladder": True}}}],
        "not_built": []})
    assert kernel_sweep.main(["200"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["card"] == "CARD, 700 W"
    assert lines[-1] == "CARD, 700 W"
    monkeypatch.setattr(kernel_sweep, "run", lambda *a, **k: {
        "card": "C", "built": [{"set": "today", "checks": {
            200: {"prep": True, "ladder": False}}}], "not_built": []})
    assert kernel_sweep.main(["200"]) == 1
    monkeypatch.setattr(kernel_sweep, "run", lambda *a, **k: {
        "card": "C", "built": [], "not_built": [
            {"set": "kLadderMinBlocks=3", "error": "nvcc failed"}]})
    assert kernel_sweep.main(["200"]) == 1
    assert kernel_sweep.main(["200", "--variant", "kLadderMinBlocks=3"]) == 0
