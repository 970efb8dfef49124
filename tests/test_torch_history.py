"""History and catchup on the node: the JAX package's own
Application-level catchup tests run on both packages.

tests/test_history_catchup.py (all 16 tests), test_catchup_acceptance.py
and test_catchup_pipeline.py run twice: as written, and rebound to the
port (tests/torch_rebind.py), each run recording every try_add result
and every close (tests/torch_node_parity.py); the two records must be
equal. Where a test selects the device backend both Applications build a
counting host verifier in its place, except the north-star test
(test_history_catchup.py::test_catchup_with_tpu_batch_prevalidation),
whose port run builds the port's CudaBatchVerifier(device="cpu") (the
plain kernels; the TpuBatchVerifier it imports is that verifier on the
port, torch_rebind.RENAMED).
"""

import pytest

import test_catchup_acceptance as ref_catchup_acceptance
import test_catchup_pipeline as ref_catchup_pipeline
import test_history_catchup as ref_history_catchup
from torch_node_parity import counting_verifier, plain_kernels, run_both
from torch_rebind import reference_cases

NORTH_STAR = "test_catchup_with_tpu_batch_prevalidation"
MODULES = (ref_history_catchup, ref_catchup_acceptance, ref_catchup_pipeline)
CASES = [c for m in MODULES for c in reference_cases(m)]


@pytest.mark.parametrize("case", CASES)
def test_reference_history_tests_on_both_with_equal_records(case, tmp_path,
                                                            caplog):
    jax_run, port_run = run_both(
        case, tmp_path, builtin={"caplog": caplog},
        port_verifier=plain_kernels if case[2] == NORTH_STAR
        else counting_verifier)
    assert jax_run == port_run


def test_cases_cover_every_reference_test():
    names = {(c.values[0][0].__name__, c.values[0][2]) for c in CASES}
    for module in MODULES:
        for n, obj in vars(module).items():
            if n.startswith("test_") and callable(obj):
                assert (module.__name__, n) in names, n
    assert sum(c.values[0][0] is ref_history_catchup for c in CASES) == 16
    assert len(CASES) == 28
