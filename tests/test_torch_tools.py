"""The port's tools (stellar_core_tpu_torch/scripts/, each run as
`python -m stellar_core_tpu_torch.scripts.<name>`), the modules of its
last host slice (xdr/native_codec.py, xdr/runtime.py's codec hook,
analysis/) and the native library's batch verifier and sanitizer build.

- Every module the slice copied equals the reference's on the AST, its
  docstrings aside, once the package name is swapped, except for the
  deliberate differences in DIFFERENCES (ROADMAP.md Queue 3): those lines
  are put back to the reference's before the comparison, so every other
  line is held.
- tests/test_crypto.py::test_native_batch runs on both packages;
  tests/test_settings_upgrade_tool.py runs the port's tool against a port
  Application; tests/test_tpu_hw_differential.py's CPU smoke is
  cuda_differential's `run --device cpu` (its card cases are in
  tests/test_torch_gpu.py, marked `gpu`).
- chaos_soak gives the reference script's document but for its wall,
  with the port's device verifier on the CPU (the package keeps no CPU
  fallback); native_sanitize runs tests/test_torch_native.py under
  ASan+UBSan; profile_catchup publishes and replays, and chip_smoke.py
  phase 18's replays rehearse on the CPU.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

import test_crypto as ref_crypto
import test_settings_upgrade_tool as ref_settings
from torch_cpu_verifier import cpu_device_verifier, sitecustomize_source
from torch_rebind import (module_code, port_function, rebound,
                          reference_cases, run_case)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "stellar_core_tpu_torch"
REF_ROOT = "REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(" \
    "__file__)))"
OUR_ROOT = "REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(\n" \
    "    os.path.abspath(__file__))))"
REF_PATH = "sys.path.insert(0, os.path.dirname(os.path.dirname(\n" \
    "    os.path.abspath(__file__))))"
OUR_PATH = "sys.path.insert(0, os.path.dirname(os.path.dirname(" \
    "os.path.dirname(\n    os.path.abspath(__file__)))))"
# the modules this slice copied (port path, reference path), in the
# order each depends only on those before it
COPIED = [("xdr/native_codec.py", "stellar_core_tpu/xdr/native_codec.py"),
          ("xdr/runtime.py", "stellar_core_tpu/xdr/runtime.py")] + \
    [(f"analysis/{m}.py", f"stellar_core_tpu/analysis/{m}.py")
     for m in ("astgraph", "allowlist", "determinism", "domains",
               "registry", "__init__")] + \
    [(f"scripts/{m}.py", f"scripts/{m}.py")
     for m in ("analyze", "native_sanitize", "profile_catchup",
               "chaos_soak", "replay_report", "soroban_settings_upgrade")]


def _between(path, start, end):
    text = (ROOT / path).read_text()
    return text[text.index(start):text.index(end)]


_CODEC_START = '_BUILD = os.path.join(_PKG, "native", "build")\n'
_CODEC_END = "\n\ndef _load_ext():"
# the deliberate differences: (the port's code, the reference's), each
# once in its file
DIFFERENCES = {
    # the build: hashed name, temporary file and rename, no stale path
    "xdr/native_codec.py": [
        ("import os\n", "import os\nimport subprocess\n"),
        (_between("stellar_core_tpu_torch/xdr/native_codec.py",
                  _CODEC_START, _CODEC_END),
         _between("stellar_core_tpu/xdr/native_codec.py",
                  _CODEC_START, _CODEC_END))],
    # the scripts live one directory deeper
    "scripts/analyze.py": [(OUR_ROOT, REF_ROOT)],
    "scripts/native_sanitize.py": [
        (OUR_ROOT, REF_ROOT),
        ('DEFAULT_TESTS = ["tests/test_torch_native.py"]',
         'DEFAULT_TESTS = ["tests/test_crypto.py", '
         '"tests/test_native_xdr.py"]')],
    "scripts/profile_catchup.py": [
        ('sys.path.insert(0, __file__.rsplit("/", 3)[0])',
         'sys.path.insert(0, __file__.rsplit("/", 2)[0])'),
        # bench.py imports the JAX package
        ("    from stellar_core_tpu_torch.work.basic_work import State\n",
         "    from stellar_core_tpu_torch.work.basic_work import State\n\n"
         "    import bench\n"),
        # the LCL's hashes, so that two replays can be held equal
        ('ledgers/s")\n    lcl = app2.ledger_manager.get_last_closed_ledger_'
         'header()\n    print(f"LCL {n} hash "\n          f"{app2.ledger_'
         'manager.get_last_closed_ledger_hash().hex()} "\n          '
         'f"bucket list {bytes(lcl.bucketListHash).hex()}\\n")\n',
         'ledgers/s\\n")\n')],
    "scripts/chaos_soak.py": [(OUR_PATH, REF_PATH)],
    "scripts/replay_report.py": [(OUR_PATH, REF_PATH)],
    "scripts/soroban_settings_upgrade.py": [
        (OUR_ROOT.replace("REPO_ROOT", "REPO"),
         REF_ROOT.replace("REPO_ROOT", "REPO"))],
}


@pytest.mark.parametrize("path,ref", COPIED, ids=[p for p, _ in COPIED])
def test_copied_modules_equal_the_reference_on_the_ast(path, ref, tmp_path):
    text = (PORT / path).read_text()
    for ours, theirs in DIFFERENCES.get(path, ()):
        assert text.count(ours) == 1, ours
        text = text.replace(ours, theirs)
    put_back = tmp_path / "module.py"
    put_back.write_text(text)
    assert module_code(put_back) == module_code(ROOT / ref, swap=True)


def test_allowlist_is_the_reference_s_but_for_wording():
    def keys(path):
        return [line.partition("#")[0].strip()
                for line in path.read_text().splitlines()
                if line.strip() and not line.startswith("#")]
    assert keys(PORT / "analysis" / "ALLOWLIST") == \
        keys(ROOT / "stellar_core_tpu" / "analysis" / "ALLOWLIST")


def test_every_tool_imports_without_the_jax_package():
    """The scripts subpackage holds a counterpart of each reference tool
    this slice ports, and none imports jax or the JAX package."""
    names = sorted(p.stem for p in (PORT / "scripts").glob("*.py"))
    assert names == ["__init__", "analyze", "chaos_soak",
                     "cuda_differential", "native_sanitize",
                     "profile_catchup", "replay_report",
                     "soroban_settings_upgrade"]
    code = ("import sys; before = set(sys.modules)\n"
            + "".join(f"import stellar_core_tpu_torch.scripts.{n}\n"
                      for n in names[1:])
            + "bad = [m for m in set(sys.modules) - before if m in "
              "('jax', 'stellar_core_tpu') or m.startswith(('jax.', "
              "'stellar_core_tpu.'))]\nprint(sorted(bad))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0 and res.stdout.strip() == "[]", \
        res.stdout + res.stderr


# ------------------------------------------------- the native library --

@pytest.mark.parametrize("case", [
    c for c in reference_cases(ref_crypto)
    if c.values[0][2] == "test_native_batch"])
def test_reference_native_batch_passes_on_both(case):
    assert run_case(case, False, {}) is None
    assert run_case(case, True, {}) is None


def test_batch_verify_checks_shapes():
    import numpy as np

    from stellar_core_tpu_torch.native import loader
    lib = loader.get_lib()
    pubs, sigs = np.zeros((2, 32), np.uint8), np.zeros((2, 64), np.uint8)
    with pytest.raises(ValueError, match="batch_verify"):
        lib.batch_verify(pubs, sigs, b"ab", np.array([0, 1], np.uint64))
    # out of order: the C side would read from offset 2 for 2**64 - 1 bytes
    with pytest.raises(ValueError, match="batch_verify"):
        lib.batch_verify(pubs, sigs, b"ab", np.array([0, 2, 1], np.uint64))
    with pytest.raises(ValueError, match="batch_prepare"):
        lib.batch_prepare(pubs, sigs, b"ab", np.array([0, 2, 1], np.uint64))
    assert lib.batch_verify(pubs[:0], sigs[:0], b"",
                            np.zeros(1, np.uint64)).tolist() == []
    assert not loader.sanitize_enabled()


def test_native_sanitize_runs_the_native_tests():
    """native_sanitize builds the ASan+UBSan library beside the fast one
    (its own hashed name) and reruns tests/test_torch_native.py with
    libasan preloaded."""
    res = subprocess.run(
        [sys.executable, "-m",
         "stellar_core_tpu_torch.scripts.native_sanitize"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items()
             if k not in ("SC_NATIVE_SANITIZE", "LD_PRELOAD")})
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    built = res.stdout.splitlines()[0]
    assert re.search(r"native/build/libscnative-san_[0-9a-f]{16}\.so$",
                     built), built
    assert re.search(r"\b4 passed\b", res.stdout), res.stdout[-2000:]


# ------------------------------------------------------------- tools --

def test_settings_upgrade_tool_against_a_port_application(tmp_path):
    """tests/test_settings_upgrade_tool.py with the port's tool (run as
    a file, as the reference runs its own) against a port Application
    and its HTTP admin API."""
    g = rebound(ref_settings)
    g["TOOL"] = str(PORT / "scripts" / "soroban_settings_upgrade.py")
    assert g["Application"].__module__.startswith("stellar_core_tpu_torch.")
    port_function(ref_settings.test_settings_upgrade_tool_end_to_end,
                  g)(tmp_path=tmp_path)


def test_differential_vectors_on_cpu_smoke(tmp_path):
    """tests/test_tpu_hw_differential.py's CPU smoke on the port:
    cuda_differential `run --device cpu` at a small n, the plain
    versions against the oracle."""
    out = tmp_path / "cpu.npz"
    res = subprocess.run(
        [sys.executable, "-m",
         "stellar_core_tpu_torch.scripts.cuda_differential", "run",
         "--device", "cpu", "--out", str(out), "--n", "64"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stdout + res.stderr
    doc = json.loads(res.stdout.strip().splitlines()[-1])
    assert doc["device"] == "cpu" and doc["mismatches_vs_oracle"] == 0
    assert doc["n"] > 64 and out.exists()
    # the plain versions launch no kernel
    assert doc["launches"] == {"msg32": 0, "k": 0, "ladder": 0}


def _reference_chaos_soak():
    spec = importlib.util.spec_from_file_location(
        "reference_chaos_soak", ROOT / "scripts" / "chaos_soak.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chaos_soak_documents_equal(tmp_path, monkeypatch):
    """One honest-but-faulty round of each package's chaos_soak at its
    default target: the same document but for the wall, with the
    port's device verifier on the CPU."""
    from stellar_core_tpu_torch.scripts import chaos_soak
    docs = []
    for mod in (_reference_chaos_soak(), chaos_soak):
        out = tmp_path / f"{mod.__name__}.json"
        monkeypatch.setattr(sys, "argv", ["chaos_soak", "1", "--out",
                                          str(out)])
        with cpu_device_verifier():
            assert mod.main() == 0
        doc = json.loads(out.read_text())
        doc.pop("wall_seconds")
        docs.append(doc)
    assert docs[0] == docs[1]
    assert docs[1]["passed"] == 1


def test_profile_catchup_publishes_and_replays():
    res = subprocess.run(
        [sys.executable, "-m",
         "stellar_core_tpu_torch.scripts.profile_catchup", "64", "2"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert re.search(r"replayed to ledger 63 in [\d.]+s = [\d.]+ "
                     r"ledgers/s\nLCL 63 hash [0-9a-f]{64} bucket list "
                     r"[0-9a-f]{64}\n", res.stdout), res.stdout[:2000]
    # the profile shows the native codec's calls
    assert "_scxdr.clone" in res.stdout


def test_phase_18_replays_rehearse_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py phase 18's replays at 2 payments per ledger on the
    plain versions (each replay process gets the device verifier on the
    CPU from a sitecustomize on its PYTHONPATH): R1 (codec on) and R2
    (SC_XDR_NATIVE=0) in fresh processes and R3 (profile_catchup as it
    is) pass profile_problems: the publisher's hash at ledger 63, one
    dispatch of the 123 signatures each, the supervisors CLOSED, the
    codec's calls in R1's profile only. No kernel launches on the CPU."""
    import chip_smoke as cs
    (tmp_path / "sitecustomize.py").write_text(sitecustomize_source())
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), str(ROOT)]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    try:
        last, hashes, (r1, r2, r3), items = cs.profile_runs(payments=2)
    except SystemExit as e:
        pytest.fail(str(e))
    assert cs.profile_problems(last, hashes, r1, r2, r3, 2) == []
    assert r1["launches"] == r2["launches"] == \
        {"msg32": 0, "k": 0, "ladder": 0}
    assert last == 63 and len(items) == 123
