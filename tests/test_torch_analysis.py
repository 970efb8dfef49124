"""The port's static analyzer (stellar_core_tpu_torch/analysis/, its
ALLOWLIST, and `python -m stellar_core_tpu_torch.scripts.analyze`).

tests/test_analysis.py and tests/test_determinism_lint.py run twice: as
written (the JAX package's analyzer over the JAX package), and rebound to
the port (tests/torch_rebind.py), where `analysis.run_all()` analyzes the
port with the port's ALLOWLIST. Both runs must pass. The committed port
analyzes clean, from the library and from the command line, with no
allowlist rot.
"""

import functools
import subprocess
import sys
from pathlib import Path

import pytest

# the two reference modules put the repo root on sys.path as "tests/..";
# a port module imported through that entry would carry the unnormalized
# path in its code objects, which main/fuzz_coverage.py's prefix test
# does not match, so the entries go again once they are imported
_PATH = list(sys.path)
import test_analysis as ref_analysis               # noqa: E402
import test_determinism_lint as ref_lint           # noqa: E402
sys.path[:] = _PATH
from torch_rebind import (port_function, rebound, reference_cases,  # noqa
                          run_case)
from stellar_core_tpu_torch import analysis
from stellar_core_tpu_torch.util import threads

ROOT = Path(__file__).resolve().parents[1]
CASES = reference_cases(ref_analysis)
LINT = [n for n in vars(ref_lint) if n.startswith("test_")]


@pytest.mark.parametrize("case", CASES)
def test_reference_analysis_tests_pass_on_both(case, tmp_path):
    for port in (False, True):
        tmp = tmp_path / ("port" if port else "jax")
        tmp.mkdir()
        assert run_case(case, port, {"tmp_path": tmp}) is None


@functools.lru_cache(maxsize=1)
def _port_lint():
    """test_determinism_lint's globals rebound to the port, its cached
    determinism run (`_findings`, an lru_cache the rebinding leaves
    alone) rebuilt over them."""
    g = rebound(ref_lint)
    g["_findings"] = functools.lru_cache(maxsize=1)(
        port_function(ref_lint._findings.__wrapped__, g))
    return g


@pytest.mark.parametrize("name", LINT)
def test_reference_determinism_lint_passes_on_both(name):
    getattr(ref_lint, name)()
    g = _port_lint()
    assert g["analysis"] is analysis
    port_function(getattr(ref_lint, name), g)()


def test_rebinding_reaches_the_port_analyzer():
    g = rebound(ref_analysis)
    assert g["analysis"] is analysis and g["threads"] is threads
    assert len(CASES) == 14 and len(LINT) == 4
    assert [f for f in _port_lint()["_findings"]()
            if f.pass_name == "determinism"] == []


def test_port_analyzes_clean_with_its_allowlist():
    res = analysis.run_all()
    assert res.index.pkg_name == "stellar_core_tpu_torch"
    assert res.allowlist.path == str(
        ROOT / "stellar_core_tpu_torch" / "analysis" / "ALLOWLIST")
    assert not res.findings, "\n" + "\n".join(f.render()
                                              for f in res.findings)
    assert all(res.allowlist.entries.values())
    doc = res.to_json()
    assert doc["counts"] == {} and doc["modules"] > 190
    # every module of the port is indexed, its tools among them
    assert "scripts.cuda_differential" in res.index.modules
    assert "xdr.native_codec" in res.index.modules


def test_analyze_command_exits_0():
    res = subprocess.run(
        [sys.executable, "-m", "stellar_core_tpu_torch.scripts.analyze",
         "--json", "-"], capture_output=True, text=True, cwd=ROOT,
        timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 finding(s)" in res.stderr
    assert '"metric": "analysis.allowlist_size"' in res.stdout
