"""The harnesses that drive many nodes (simulation/chaos.py,
simulation/byzantine.py, simulation/drive.py, simulation/cluster.py):
the JAX package's own tests run on both packages.

tests/test_chaos.py, test_byzantine.py and test_cluster_harness.py run
twice: as written, and rebound to the port (tests/torch_rebind.py), each
run recording every try_add result and every close in this process
(tests/torch_node_parity.py); the two records must be equal. The
reference's `slow` cases stay `slow` here.

Where the chaos and Byzantine scenarios build the device verifier
(`CudaBatchVerifier(...)` in the port, `TpuBatchVerifier(...)` in the
reference), the port's run builds it on the CPU, as the rebinding does
for a test's own `TpuBatchVerifier`: at the scenarios' cutoffs every
flush stays on the host, so no plain kernel runs. The package keeps no
CPU fallback: without this, construction raises here
(tests/test_torch_app.py).

The multinode chaos scenario ends with an archive leg whose fetch runs
`cp` processes while the scenario's shared virtual clock cranks on, so
how many more ledgers the nodes close meanwhile follows the wall clock:
for it, as for the TCP tests of tests/test_torch_overlay.py, only the
try_add results are compared.

The cluster tests spawn `python -m stellar_core_tpu` in the JAX run and
`python -m stellar_core_tpu_torch` in the port's, each node process on
the native verifier, over real TCP on ports the system hands out (no
port shift). The harness kills every node it started when the test
leaves its `with Cluster(...)` block, passing or failing, and bounds
every wait with a deadline.
"""

import pytest

import test_byzantine as ref_byzantine
import test_chaos as ref_chaos
import test_cluster_harness as ref_cluster_harness
from torch_cpu_verifier import cpu_device_verifier
from torch_node_parity import run_both
from torch_rebind import reference_cases

MODULES = (ref_chaos, ref_byzantine, ref_cluster_harness)


def _kept_slow(param):
    """The case with the reference test's `slow` mark, if it has one."""
    module, owner, name, _ = param.values[0]
    fn = getattr(getattr(module, owner) if owner else module, name)
    slow = [m for m in getattr(fn, "pytestmark", []) if m.name == "slow"]
    return pytest.param(*param.values, marks=slow, id=param.id) if slow \
        else param


CASES = [_kept_slow(c) for m in MODULES for c in reference_cases(m)]
# the chaos scenario's tests, whose closes follow the wall clock
WALL_CLOCK = {"test_multinode_chaos_scenario_converges",
              "test_chaos_convergence_soak"}


def _compared(case, run):
    if case[0] is ref_chaos and case[2] in WALL_CLOCK:
        return [r for r in run if r[0] != "close"]
    return run


@pytest.mark.parametrize("case", CASES)
def test_reference_harness_tests_on_both_with_equal_records(
        case, tmp_path, tmp_path_factory):
    with cpu_device_verifier():
        jax_run, port_run = run_both(
            case, tmp_path, builtin={"tmp_path_factory": tmp_path_factory},
            shift=case[0] is not ref_cluster_harness)
    assert _compared(case, jax_run) == _compared(case, port_run)


def test_cases_cover_every_reference_test():
    names = {(c.values[0][0].__name__, c.values[0][2]) for c in CASES}
    for module in MODULES:
        for n, obj in vars(module).items():
            if n.startswith("test_") and callable(obj):
                assert (module.__name__, n) in names, n
    slow = {c.values[0][2] for c in CASES if c.marks}
    assert slow == {"test_chaos_convergence_soak",
                    "test_byzantine_tiered_50_nodes_with_churn",
                    "test_cluster_partition_minority_stalls_and_rejoins",
                    "test_cluster_9_nodes_tiered_chaos"}
    assert len(CASES) == 52
