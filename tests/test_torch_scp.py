"""The JAX package's consensus tests, rebound to the port.

tests/test_scp.py, test_scp_network.py and test_quorum_intersection.py
run twice: as written, and with their names rebound to the port's
modules (tests/torch_rebind.py; the drivers and buses they define are
rebuilt over the port's SCPDriver). Each run records, in order, every
envelope an SCP's driver emits (its node and the envelope's bytes), every
value it externalizes (node, slot, value) and every verdict of the
quorum-intersection checker (the answer, or the error it raised, and the
split it found); the two records must be equal.

Every test of the three modules runs: the four quorum-intersection
tests that build their quorum maps with simulation/topologies.py or boot
an Application (main/) were left out until those modules were ported.
"""

import contextlib
import importlib

import pytest

import test_quorum_intersection as ref_qi
import test_scp as ref_scp
import test_scp_network as ref_scp_network
from torch_rebind import jax_case, port_case, rebound, reference_cases

# reference test -> the unported module it needs: none is left out
LEFT_OUT = {}
MODULES = (ref_scp, ref_scp_network, ref_qi)
CASES = [p for m in MODULES
         for p in reference_cases(m, LEFT_OUT.get(m.__name__, {}))]


@contextlib.contextmanager
def recording(root):
    """Record, in order, what every SCP of package `root` emits and
    externalizes through its driver, and every answer of its
    QuorumIntersectionChecker; yields the list."""
    scp_cls = importlib.import_module(f"{root}.scp.scp").SCP
    checker = importlib.import_module(
        f"{root}.herder.quorum_intersection").QuorumIntersectionChecker
    out = []
    init, enjoys = scp_cls.__init__, checker.network_enjoys_quorum_intersection

    def recorded_init(self, driver, node_id_raw, *args, **kwargs):
        init(self, driver, node_id_raw, *args, **kwargs)
        node = bytes(node_id_raw)
        emit, ext = driver.emit_envelope, driver.value_externalized

        def emitted(env):
            out.append(("emit", node, env.to_bytes()))
            return emit(env)

        def externalized(slot, value):
            out.append(("externalize", node, slot, bytes(value)))
            return ext(slot, value)
        driver.emit_envelope = emitted
        driver.value_externalized = externalized

    def recorded_enjoys(self):
        try:
            ok = enjoys(self)
        except Exception as e:
            out.append(("intersection", type(e).__name__))
            raise
        split = getattr(self, "potential_split", None)
        out.append(("intersection", ok, None if split is None else
                    tuple(sorted(sorted(s) for s in split))))
        return ok

    scp_cls.__init__ = recorded_init
    checker.network_enjoys_quorum_intersection = recorded_enjoys
    try:
        yield out
    finally:
        scp_cls.__init__ = init
        checker.network_enjoys_quorum_intersection = enjoys


def run_both(case):
    module, owner, name, kw = case
    runs = []
    for root, make in (("stellar_core_tpu", jax_case),
                       ("stellar_core_tpu_torch", port_case)):
        with recording(root) as out:
            make(module, owner, name)(**kw)
        runs.append(out)
    return runs


@pytest.mark.parametrize("case", CASES)
def test_reference_consensus_tests_on_both_with_equal_records(case):
    jax_run, port_run = run_both(case)
    assert jax_run == port_run


def test_cases_cover_every_reference_test_but_the_left_out():
    """Every test of the three modules runs, or is named in LEFT_OUT with
    the unported module it needs; LEFT_OUT is empty: the four tests that
    import simulation/ or main/ run since those modules are ported."""
    names = {(c.values[0][0].__name__, c.values[0][2]) for c in CASES}
    for module in MODULES:
        tests = [n for n in vars(module) if n.startswith("test_")]
        tests += [n for cls in vars(module).values()
                  if isinstance(cls, type) and cls.__name__.startswith("Test")
                  for n in vars(cls) if n.startswith("test_")]
        left = LEFT_OUT.get(module.__name__, {})
        for n in tests:
            assert ((module.__name__, n) in names) != (n in left), n
    assert not LEFT_OUT
    assert len(CASES) == 45
    assert {c.values[0][2] for c in CASES} >= {
        "test_admin_route_reports_intersection",
        "test_hierarchical_generator_output_enjoys_intersection",
        "test_tiered_generator_output_enjoys_intersection",
        "test_tiered_under_thresholded_config_rejected_and_splits"}


def test_the_runs_record_envelopes_and_values():
    """The recorder sees what the five-node network test emits and
    externalizes, alike in both packages."""
    case = next(c.values[0] for c in CASES
                if c.values[0][2] == "test_five_nodes_agree")
    jax_run, port_run = run_both(case)
    assert jax_run == port_run
    kinds = {r[0] for r in port_run}
    assert kinds == {"emit", "externalize"}
    assert sum(r[0] == "externalize" for r in port_run) == 5


def test_rebinding_reaches_the_port_scp():
    """The reference modules' drivers and buses are rebuilt over the
    port's SCPDriver, and their SCP is the port's."""
    from stellar_core_tpu_torch.scp import SCP, SCPDriver
    g = rebound(ref_scp)
    assert issubclass(g["TestDriver"], SCPDriver)
    assert g["TestDriver"] is not ref_scp.TestDriver
    core = g["Core5"]()
    assert isinstance(core.scp, SCP) and isinstance(core.driver,
                                                    g["TestDriver"])
    # zero-argument super() inside a rebuilt method finds the new class
    assert core.driver.compute_hash_node(1, b"", True, 1, b"n") == \
        ref_scp.TestDriver().compute_hash_node(1, b"", True, 1, b"n")
    bus = rebound(ref_scp_network)["Bus"](4, 3)
    assert all(isinstance(s, SCP) for s in bus.nodes.values())
