"""The scenario matrix on the port: stellar_core_tpu_torch/scripts/
bench_matrix.py, the counterpart of the JAX package's scripts/
bench_matrix.py.

The copy equals the reference's on the AST, docstrings aside, once the
package name is swapped and its path to the repository root (one
directory deeper) is put back. tests/test_matrix_schema.py runs a
second time rebound to the port (tests/torch_rebind.py: `bench_matrix`
is the port's copy, the cluster harness and chaos the port's modules):
the cell list, the typed failed-cell doc, the artifact folding and
scripts/check_artifacts.py's MATRIX schema on the port's artifact, and
the cluster's fault-schedule functions. The cells are the reference's.
No cell runs here: each is a cluster of node processes (CHANGES.md has
one smoke_uniform run of each package).
"""

from pathlib import Path

import pytest

import test_matrix_schema as ref_matrix
from torch_rebind import module_code, rebound, reference_cases, run_case

from stellar_core_tpu_torch.scripts import bench_matrix

ROOT = Path(__file__).resolve().parents[1]
# the copy's deliberate differences: (the port's code, the reference's)
DIFFERENCES = [
    ("_REPO = os.path.dirname(os.path.dirname(os.path.dirname(\n"
     "    os.path.abspath(__file__))))",
     "_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))")]


def test_copy_equals_the_reference_on_the_ast(tmp_path):
    text = (ROOT / "stellar_core_tpu_torch" / "scripts"
            / "bench_matrix.py").read_text()
    for ours, theirs in DIFFERENCES:
        assert text.count(ours) == 1, ours
        text = text.replace(ours, theirs)
    put_back = tmp_path / "bench_matrix.py"
    put_back.write_text(text)
    assert module_code(put_back) == \
        module_code(ROOT / "scripts" / "bench_matrix.py", swap=True)


def test_reference_test_module_rebinds_to_the_port():
    g = rebound(ref_matrix)
    assert g["bench_matrix"] is bench_matrix
    assert g["Cluster"].__module__ == "stellar_core_tpu_torch.simulation.cluster"
    assert g["check_artifacts"] is ref_matrix.check_artifacts


@pytest.mark.parametrize("scale", ["default", "smoke"])
def test_default_cells_equal_the_reference_s(scale):
    assert bench_matrix.default_cells(scale) == \
        ref_matrix.bench_matrix.default_cells(scale)
    assert bench_matrix.CELL_VERDICT_KEYS == \
        ref_matrix.bench_matrix.CELL_VERDICT_KEYS


@pytest.mark.parametrize("case", reference_cases(ref_matrix))
def test_reference_matrix_tests_on_the_port(case, tmp_path):
    run_case(case, port=True, builtin={"tmp_path": tmp_path})
