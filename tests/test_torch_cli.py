"""The command line and the tools beside it (main/command_line.py, the
package's two __main__ modules, main/fuzzer.py, main/fuzz_coverage.py,
replay/, util/xdrquery.py, util/tracemerge.py, xdr/json_repr.py) and the
multi-process harnesses' modules: the JAX package's side and the port's.

Every module this slice copied equals the reference's on the AST, its
docstrings aside, once the package name is swapped, except for the
device verifier the chaos and Byzantine scenarios build (DIFFERENCES,
ROADMAP.md Queue 3): those lines are put back to the reference's before
the comparison, so every other line is held.

tests/test_command_line.py, test_replay.py, test_fuzz.py,
test_fuzz_coverage.py and test_xdrquery.py run twice: as written, and
rebound to the port (tests/torch_rebind.py), each run recording every
try_add result and every close (tests/torch_node_parity.py); the two
records must be equal.

A port node boots from the command line as an operator starts one
(`python -m stellar_core_tpu_torch --conf node.cfg run`) and is driven
over its admin HTTP port; on the device backend with no card (the child
sees none) `run` and `self-check` exit with resolve_device's error and
never fall back to the native verifier. Every child process has a
deadline of its own and is killed in a `finally`.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

import test_command_line as ref_command_line
import test_fuzz as ref_fuzz
import test_fuzz_coverage as ref_fuzz_coverage
import test_replay as ref_replay
import test_xdrquery as ref_xdrquery
from torch_node_parity import run_both
from torch_rebind import module_code, rebound, reference_cases

ROOT = Path(__file__).resolve().parents[1]
# the modules this slice copied, in the order each depends only on
# those before it, with the package name swapped
COPIED = ("xdr/json_repr.py", "util/xdrquery.py", "util/tracemerge.py",
          "replay/log.py", "replay/recorder.py", "replay/replayer.py",
          "replay/__init__.py", "simulation/chaos.py", "replay/scenario.py",
          "simulation/byzantine.py", "simulation/drive.py",
          "main/fuzzer.py", "main/fuzz_coverage.py",
          "main/command_line.py", "main/__main__.py", "__main__.py",
          "simulation/cluster.py")
# the device verifier's deliberate differences: (the port's code, the
# reference's), each once in its file
DIFFERENCES = {
    "simulation/chaos.py": [
        ("import CudaBatchVerifier", "import TpuBatchVerifier"),
        ("inner = CudaBatchVerifier(", "inner = TpuBatchVerifier(")],
    "simulation/byzantine.py": [
        ("import CudaBatchVerifier", "import TpuBatchVerifier"),
        ("bv = CudaBatchVerifier(", "bv = TpuBatchVerifier(")],
}


@pytest.mark.parametrize("path", COPIED)
def test_copied_modules_equal_the_reference_on_the_ast(path, tmp_path):
    text = (ROOT / "stellar_core_tpu_torch" / path).read_text()
    for ours, theirs in DIFFERENCES.get(path, ()):
        assert text.count(ours) == 1, ours
        text = text.replace(ours, theirs)
    put_back = tmp_path / "module.py"
    put_back.write_text(text)
    assert module_code(put_back) == \
        module_code(ROOT / "stellar_core_tpu" / path, swap=True)


# ------------------------------------------------ rebound reference tests --

MODULES = (ref_command_line, ref_replay, ref_fuzz, ref_fuzz_coverage,
           ref_xdrquery)
CASES = [c for m in MODULES for c in reference_cases(m)]


@pytest.mark.parametrize("case", CASES)
def test_reference_cli_tests_on_both_with_equal_records(case, tmp_path,
                                                        capsys):
    jax_run, port_run = run_both(case, tmp_path,
                                 builtin={"capsys": capsys})
    assert jax_run == port_run


def test_replay_report_is_the_port_s():
    """test_replay's replay_report (the reference's scripts/) rebinds to
    the port's copy in its scripts subpackage, whose functions import
    the port."""
    from stellar_core_tpu_torch.scripts import replay_report
    assert rebound(ref_replay)["replay_report"] is replay_report
    assert "stellar_core_tpu_torch.replay" in \
        replay_report._load_trace.__code__.co_names


def test_cases_cover_every_reference_test():
    names = {(c.values[0][0].__name__, c.values[0][2]) for c in CASES}
    for module in MODULES:
        for n, obj in vars(module).items():
            if n.startswith("test_") and callable(obj):
                assert (module.__name__, n) in names, n
    for cls in (ref_fuzz.TestXdrFuzz, ref_fuzz.TestOverlayFuzz,
                ref_fuzz.TestPeerDbAndBans, ref_fuzz.TestFuzzHarness):
        for n in vars(cls):
            if n.startswith("test_"):
                assert ("test_fuzz", n) in names, n
    assert len(CASES) == 48


# ------------------------------------------------- a node from the CLI --

STANDALONE = """RUN_STANDALONE = true
MANUAL_CLOSE = true
HTTP_PORT = 0
NETWORK_PASSPHRASE = "Standalone Network ; February 2017"
SIGNATURE_VERIFY_BACKEND = "{backend}"
DATABASE = "sqlite3://{dir}/stellar.db"
BUCKET_DIR_PATH = "{dir}/buckets"
"""
DEADLINE_S = 60.0


def _conf(tmp_path, backend):
    path = tmp_path / "node.cfg"
    path.write_text(STANDALONE.format(backend=backend, dir=tmp_path))
    return str(path)


def _cli(conf, *args, timeout=DEADLINE_S, env=None):
    return subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch", "--conf", conf,
         *args], cwd=ROOT, capture_output=True, text=True,
        timeout=timeout, env=env)


def _get(port, route):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/{route}",
                                timeout=5.0) as resp:
        return json.loads(resp.read())


def test_port_node_runs_from_the_command_line(tmp_path):
    """`new-db`, then `run --port-file`: the node reports its ephemeral
    admin port, is Synced!, closes ledgers through `manualclose`, exits
    0 on SIGTERM, and a second `run` on the same files reloads its
    LCL."""
    conf = _conf(tmp_path, "native")
    res = _cli(conf, "new-db")
    assert res.returncode == 0, res.stderr
    port_file = tmp_path / "http.port"
    lcl = None
    for closes in (2, 1):
        port_file.unlink(missing_ok=True)
        with open(tmp_path / "node.log", "ab") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "stellar_core_tpu_torch", "--conf",
                 conf, "run", "--port-file", str(port_file)],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + DEADLINE_S
            while not (port_file.exists() and port_file.read_text()):
                assert proc.poll() is None, \
                    (tmp_path / "node.log").read_text()
                assert time.monotonic() < deadline, "no port file"
                time.sleep(0.1)
            port = int(port_file.read_text())
            info = _get(port, "info")["info"]
            assert info["state"] == "Synced!"
            assert info["http_port"] == port
            if lcl is not None:
                assert info["ledger"]["num"] == lcl
            for _ in range(closes):
                assert "exception" not in _get(port, "manualclose")
            lcl = _get(port, "info")["info"]["ledger"]["num"]
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(DEADLINE_S) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(10)
    assert lcl == 4


@pytest.mark.parametrize("backend", ["cuda", "tpu"])
@pytest.mark.parametrize("command", ["run", "self-check"])
def test_device_backend_without_a_card_exits(tmp_path, backend, command):
    """With the device backend and no card visible, `run` and
    `self-check` exit non-zero with resolve_device's error: the node
    never comes up on the native verifier in its place."""
    conf = _conf(tmp_path, backend)
    assert _cli(conf, "new-db").returncode == 0
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _cli(conf, command, env=env)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr, res.stderr[-2000:]
    assert "application started" not in res.stderr
    assert res.stdout == ""
