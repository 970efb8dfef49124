"""The overlay (overlay/: wire path, flow control, floodgate, fetchers,
adverts and demands, peer auth, loopback and TCP peers, the peer and
survey managers, the overlay manager): the JAX package's own overlay
tests run on both packages.

tests/test_overlay.py, test_tcp_overlay.py, test_wire_path.py,
test_flow_control_edges.py, test_flow_priority.py and test_link_faults.py
run twice: as written, and rebound to the port (tests/torch_rebind.py),
each run recording every try_add result and every close
(tests/torch_node_parity.py); the two records must be equal. The TCP
tests run over localhost sockets on the wall clock, so when a ledger
closes, and how many close before the test's condition holds, depend on
the scheduler: for them only the try_add results are compared.

Left out (LEFT_OUT): test_tcp_overlay.py::test_idle_link_kept_alive_by_
keepalive, a wall-clock timing test (a 2 s idle deadline across a 3 s
quiet window, kept by a keepalive at half the deadline). On a loaded host
its outcome depends on scheduling in the JAX package alone: it failed
once in six runs beside eight busy processes on the CPU the tests run
on, and in one of four whole-suite runs here. The reference's own run
of it stays in the suite.
"""

import pytest

import test_flow_control_edges as ref_flow_control_edges
import test_flow_priority as ref_flow_priority
import test_link_faults as ref_link_faults
import test_overlay as ref_overlay
import test_tcp_overlay as ref_tcp_overlay
import test_wire_path as ref_wire_path
from torch_node_parity import PORT_SHIFT, TEST_PORTS, run_both
from torch_rebind import reference_cases

LEFT_OUT = {"test_tcp_overlay": {
    "test_idle_link_kept_alive_by_keepalive":
        "wall-clock timing: flaky on a loaded host in the JAX package"}}
MODULES = (ref_overlay, ref_tcp_overlay, ref_wire_path,
           ref_flow_control_edges, ref_flow_priority, ref_link_faults)
CASES = [c for m in MODULES
         for c in reference_cases(m, LEFT_OUT.get(m.__name__, {}))]


def _compared(case, run):
    if case[0] is ref_tcp_overlay:
        return [r for r in run if r[0] != "close"]
    return run


@pytest.mark.parametrize("case", CASES)
def test_reference_overlay_tests_on_both_with_equal_records(case, tmp_path):
    jax_run, port_run = run_both(case, tmp_path)
    assert _compared(case, jax_run) == _compared(case, port_run)


def test_cases_cover_every_reference_test_but_the_left_out():
    names = {(c.values[0][0].__name__, c.values[0][2]) for c in CASES}
    for module in MODULES:
        left = LEFT_OUT.get(module.__name__, {})
        for n, obj in vars(module).items():
            if n.startswith("test_") and callable(obj):
                assert ((module.__name__, n) in names) != (n in left), n
    assert len(CASES) == 65


def test_loopback_runs_record_equal_header_hashes(tmp_path):
    """Over loopback links on the virtual clock the records hold every
    close's header hash, equal in both packages."""
    case = next(c.values[0] for c in CASES if c.values[0][2] ==
                "test_scp_flood_and_txset_fetch_close_ledger")
    jax_run, port_run = run_both(case, tmp_path)
    closes = [r for r in port_run if r[0] == "close"]
    assert closes and all(len(r[3]) == 32 for r in closes)
    assert closes == [r for r in jax_run if r[0] == "close"]


def test_shifted_ports_lie_below_the_ephemeral_range():
    """Each run's copy of the reference's TCP test ports lies below the
    ports the kernel hands to outgoing sockets, so no other process's
    connection holds one when a run binds it (one did at 46101, when the
    JAX run's copy was 44000-47999)."""
    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    copies = [range(TEST_PORTS.start + s, TEST_PORTS.stop + s)
              for s in PORT_SHIFT.values()]
    assert all(1024 < c.start and c.stop <= low for c in copies)
    assert not set(copies[0]) & set(copies[1])
    assert not any(set(c) & set(TEST_PORTS) for c in copies)
