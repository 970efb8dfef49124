"""The control plane the Application builds (ops/slo.py,
util/timeseries.py, ops/controller.py), the read tier (query/) and the
simulation harness (simulation/simulation.py, topologies.py,
load_generator.py): the JAX package's own tests run on both packages.

tests/test_controller.py, test_timeseries_slo.py, test_query_service.py,
test_simulation.py and test_mesh_observatory.py run twice: as written,
and rebound to the port (tests/torch_rebind.py), each run recording
every try_add result and every close (tests/torch_node_parity.py); the
two records must be equal.

Left out (LEFT_OUT), with the reason:
test_timeseries_slo.py::test_verifier_dispatch_accounting: the JAX run
compiles the XLA kernel (about 90 s on the CPU), and on the port its
padding assertion does not hold by design: the port's verifier pads
nothing and records padding 0 (ROADMAP.md Queue 3, deliberate
difference 4). test_port_verifier_dispatch_accounting holds the same
accounting on the port's CudaBatchVerifier(device="cpu"). The six
test_mesh_observatory.py tests over one merged cluster trace, left out
until util/tracemerge.py was ported, run.
"""

import hashlib

import pytest

import test_controller as ref_controller
import test_mesh_observatory as ref_mesh_observatory
import test_query_service as ref_query_service
import test_simulation as ref_simulation
import test_timeseries_slo as ref_timeseries_slo
from torch_node_parity import run_both
from torch_rebind import reference_cases
from torch_tx_parity import P

LEFT_OUT = {
    "test_timeseries_slo": {
        "test_verifier_dispatch_accounting":
            "an XLA compile in the JAX run; the port pads nothing"},
}
MODULES = (ref_controller, ref_timeseries_slo, ref_query_service,
           ref_simulation, ref_mesh_observatory)
CASES = [c for m in MODULES
         for c in reference_cases(m, LEFT_OUT.get(m.__name__, {}))]


@pytest.mark.parametrize("case", CASES)
def test_reference_control_tests_on_both_with_equal_records(case,
                                                            tmp_path,
                                                            capsys):
    jax_run, port_run = run_both(case, tmp_path,
                                 builtin={"capsys": capsys})
    assert jax_run == port_run


def test_cases_cover_every_reference_test_but_the_left_out():
    names = {(c.values[0][0].__name__, c.values[0][2]) for c in CASES}
    for module in MODULES:
        left = LEFT_OUT.get(module.__name__, {})
        for n, obj in vars(module).items():
            if n.startswith("test_") and callable(obj):
                assert ((module.__name__, n) in names) != (n in left), n
    assert len(CASES) == 70


def _sig_items(n):
    from stellar_core_tpu_torch.crypto import ed25519_ref as ref
    seed = bytes(range(32))
    pub = ref.secret_to_public(seed)
    return [(pub, ref.sign(seed, m), m) for m in
            (hashlib.sha256(b"ts-%d" % i).digest() for i in range(n))]


def test_port_verifier_dispatch_accounting():
    """test_timeseries_slo.py::test_verifier_dispatch_accounting on the
    port's verifier (plain kernels on the CPU): one dispatch of 5 counted
    with its size and wall, padding 0 (the port pads nothing), and the
    host bypass below the cutoff not counted as a device dispatch."""
    reg = P.metrics.MetricsRegistry()
    v = P.verifier.CudaBatchVerifier(device="cpu", device_min_batch=1,
                                     metrics=reg)
    assert all(v.verify_tuples(_sig_items(5)))
    batch = reg.new_histogram("crypto.verify.dispatch.batch")
    pad = reg.new_histogram("crypto.verify.dispatch.padding")
    wall = reg.new_timer("crypto.verify.dispatch.wall")
    assert batch.count == 1 and batch._sum == 5.0
    assert pad.count == 1 and pad._sum == 0.0
    assert wall.count == 1
    v2 = P.verifier.CudaBatchVerifier(device="cpu", device_min_batch=64,
                                      metrics=reg)
    assert all(v2.verify_tuples(_sig_items(2)))
    assert batch.count == 1
