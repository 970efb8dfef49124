"""The herder, its transaction queue and flood admission: the JAX
package's and the port's side by side.

tests/test_tx_queue_sweep.py runs twice: as written, and rebound to the
port (tests/torch_rebind.py); each run records every
TransactionQueue.try_add result and every closed ledger's hash, and the
two records must be equal.

Every module this slice copied equals the reference's on the AST, its
docstrings aside, once the package name is swapped.

A loopback of four validators of each package (chip_smoke.py phase 15's
`consensus_run` at 40 accounts and 3 measured slots of 20 payments, one
flipped signature byte per slot, and one SCP envelope delivered once
with a corrupted signature) runs from the same seeds and bytes: the
AddResults and bad_sig lists, every node's emitted envelopes, the
externalized values, the LCL hashes, every close's bytes and every
verify_envelope and StellarValue verdict must be equal. Each node is
its package's Application; its verify service and batch verifier are
its package's own, at a device
cutoff above every flush, so every verification is native and the JAX
package compiles nothing. One case sends a burst of 20 through
CudaBatchVerifier("cpu")'s plain kernels: its one plain dispatch.
"""

import contextlib
import importlib
from pathlib import Path

import pytest

import chip_smoke as cs
import test_tx_queue_sweep as ref_tqs
from torch_rebind import jax_case, module_code, port_case, port_function, \
    rebound, reference_cases
from torch_tx_parity import J, P, clear_caches

CASES = reference_cases(ref_tqs)
CUTOFF = 1 << 20           # above every flush: every verify native
ROOT = Path(__file__).resolve().parents[1]
# the modules this slice copied, with the package name swapped
COPIED = ("util/gcpolicy.py", "scp/__init__.py", "scp/driver.py",
          "scp/local_node.py", "scp/quorum_set_utils.py",
          "scp/nomination.py", "scp/ballot.py", "scp/slot.py", "scp/scp.py",
          "herder/tx_queue.py", "herder/pending_envelopes.py",
          "herder/scp_driver.py", "herder/quorum_tracker.py",
          "herder/quorum_intersection.py", "herder/herder.py",
          "herder/__init__.py", "crypto/__init__.py")


@pytest.mark.parametrize("path", COPIED)
def test_copied_modules_equal_the_reference_on_the_ast(path):
    assert module_code(ROOT / "stellar_core_tpu_torch" / path) == \
        module_code(ROOT / "stellar_core_tpu" / path, swap=True)


@pytest.fixture(autouse=True)
def _fresh_caches():
    clear_caches()
    yield
    clear_caches()


@contextlib.contextmanager
def recording(pkg):
    """Record every TransactionQueue.try_add result and every closed
    ledger's hash of `pkg`, in order."""
    out = []
    tq = importlib.import_module(f"{pkg.name}.herder.tx_queue")
    lm_cls = pkg.ledger_manager.LedgerManager
    try_add, close_ledger = tq.TransactionQueue.try_add, lm_cls.close_ledger

    def recorded_add(self, *args, **kwargs):
        res = try_add(self, *args, **kwargs)
        out.append(("add", res.name, self.size_txs()))
        return res

    def recorded_close(self, *args, **kwargs):
        res = close_ledger(self, *args, **kwargs)
        out.append(("close", self.get_last_closed_ledger_hash()))
        return res
    tq.TransactionQueue.try_add = recorded_add
    lm_cls.close_ledger = recorded_close
    try:
        yield out
    finally:
        tq.TransactionQueue.try_add = try_add
        lm_cls.close_ledger = close_ledger


@pytest.mark.parametrize("case", CASES)
def test_reference_tx_queue_tests_on_both_with_equal_records(case):
    module, owner, name, kw = case
    runs = []
    for pkg, make, lm in ((J, jax_case, ref_tqs.lm.__wrapped__),
                          (P, port_case, port_function(
                              ref_tqs.lm.__wrapped__, rebound(ref_tqs)))):
        clear_caches()
        with recording(pkg) as out:
            make(module, owner, name)(lm=lm(), **kw)
        runs.append(out)
    assert runs[0] == runs[1]
    assert any(r[0] == "add" for r in runs[1])


def test_tx_queue_cases_cover_every_reference_test():
    assert sorted(c.values[0][2] for c in CASES) == sorted(
        n for n in vars(ref_tqs) if n.startswith("test_"))
    assert len(CASES) == 19


def _services(pkg, cutoff, made):
    """Node i's (verify service, batch verifier) of `pkg`: its own
    VerifyService over BackendSupervisor over the package's device
    verifier (the port's on the CPU) at the device cutoff `cutoff`, with
    phase 7's knobs, the service's flushes recorded
    (chip_smoke.RecordingVerifier) and the verifier's perf zones its
    own; each stack (perf zones, supervisor, service, recorder) is
    appended to `made`."""
    root = pkg.name
    vs = importlib.import_module(f"{root}.ops.verify_service")
    bs = importlib.import_module(f"{root}.ops.backend_supervisor")
    ver = importlib.import_module(f"{root}.ops.verifier")

    def services(i, clock):
        perf = pkg.perf.ZoneRegistry()
        if root == "stellar_core_tpu":
            v = ver.TpuBatchVerifier(perf=perf, device_min_batch=cutoff)
        else:
            v = ver.CudaBatchVerifier(device="cpu", perf=perf,
                                      device_min_batch=cutoff)
        sup = bs.BackendSupervisor(
            v, clock=clock,
            dispatch_deadline_ms=cs.LIVE["dispatch_deadline_ms"],
            canary_batch=cs.LIVE["canary_batch"])
        rec = cs.RecordingVerifier(sup)
        svc = vs.VerifyService(rec, clock=clock,
                               max_batch=cs.LIVE["max_batch"],
                               deadline_ms=cs.LIVE["deadline_ms"])
        made.append((perf, sup, svc, rec))
        return svc, sup
    return services


def _zone_count(perf, name):
    return perf.report().get(name, {"count": 0})["count"]


@pytest.fixture(scope="module")
def loopback(tmp_path_factory):
    """phase 15's network in each package from the same workload bytes
    (40 accounts, 3 measured slots of 20 payments, bursts of 8, one
    corrupted envelope): (JAX run, port run, workload, the stacks)."""
    wl = cs.close_workload(40, 20, 3, cs.CONSENSUS_SEED, control=False,
                           flooded=True)
    runs, stacks = [], []
    for pkg in (J, P):
        clear_caches()
        made = []
        runs.append(cs.consensus_run(
            wl, str(tmp_path_factory.mktemp(pkg.name)), pkg=pkg,
            services=_services(pkg, CUTOFF, made), burst=8,
            corrupt_first=True))
        stacks.append(made)
    clear_caches()
    return runs[0], runs[1], wl, stacks


@pytest.mark.parametrize("key", ["emitted", "externalized", "lcl",
                                 "closes", "envelopes", "values"])
def test_loopback_records_equal_in_both(loopback, key):
    jax_run, port_run, _, _ = loopback
    assert jax_run[key] == port_run[key]


def test_loopback_admission_equal_in_both(loopback):
    """AddResults and bad_sig lists, burst by burst and node by node;
    only the flipped transactions fail, and only they are bad_sig."""
    jax_run, port_run, wl, _ = loopback
    record = [[(b["slot"], b["node"], b["at"], b["adds"], b["bad_sig"])
               for b in run["bursts"]] for run in (jax_run, port_run)]
    assert record[0] == record[1]
    for b in port_run["bursts"]:
        kinds = wl["closes"][b["slot"] - 2].get("kinds", [])
        flipped = [kinds[b["at"] + j] == "flipped" if kinds else False
                   for j in range(b["n"])]
        assert b["bad_sig"] == flipped
        assert [a != "ADD_STATUS_PENDING" for a in b["adds"]] == flipped
    assert sum(map(sum, (b["bad_sig"] for b in port_run["bursts"]))) == 12


def test_loopback_reaches_consensus_on_every_slot(loopback):
    """Every node externalizes one value per slot, the same everywhere,
    lands on one LCL, and rejected exactly the corrupted envelope."""
    _, port_run, wl, _ = loopback
    slots = list(range(2, 2 + len(wl["closes"])))
    assert all(ext == port_run["externalized"][0] and
               [s for s, _ in ext] == slots
               for ext in port_run["externalized"])
    assert len(set(port_run["lcl"])) == 1
    rejected = [(i, e) for i, es in enumerate(port_run["envelopes"])
                for e in es if not e[2]]
    assert [(i, e[:2]) for i, e in rejected] == [(1, (2, 0)), (2, (2, 0)),
                                                 (3, (2, 0))]
    assert all(ok for vs in port_run["values"] for _, ok in vs)
    assert all(len(e) == len(port_run["emitted"][0])
               for e in port_run["emitted"])


def test_loopback_verifies_through_each_nodes_service(loopback):
    """Every node's flushes went to its package's verifier below the
    cutoff (native, no XLA compile, no plain kernel); the supervisors
    stayed CLOSED with 0 failures and the services with 0 fallbacks;
    txset validation never probed the verify cache (each node's own
    proposal seeds its validity cache)."""
    jax_run, port_run, _, stacks = loopback
    assert jax_run["probes"] == port_run["probes"] == [0, 0]
    for made in stacks:
        assert len(made) == 4
        for perf, sup, svc, rec in made:
            st = sup.status()
            assert st["state"] == "CLOSED" and not any(
                st["failures"].values()) and not st["skips"]
            assert svc.stats()["fallbacks"] == 0
            assert svc.stats()["flushes"] == len(rec.calls) > 0
            assert _zone_count(perf, "crypto.batchVerify.native") == \
                len(rec.calls)
            assert _zone_count(perf, "crypto.batchVerify") == 0
    from stellar_core_tpu.ops.verifier import TpuBatchVerifier
    assert TpuBatchVerifier._shared_jit._cache_size() == 0


def test_one_burst_through_the_plain_kernels(tmp_path):
    """One validator of each package (threshold 1) closes the workload's
    slots; the port's node admits the measured slot's 20 transactions in
    one burst through CudaBatchVerifier("cpu") at the node's cutoff of
    16: one dispatch of the plain kernels, whose verdicts equal the JAX
    node's native ones."""
    wl = cs.close_workload(40, 20, 1, cs.CONSENSUS_SEED, control=False,
                           flooded=True)
    runs, made = [], {}
    for pkg, cutoff in ((J, CUTOFF), (P, cs.LIVE["device_min_batch"])):
        clear_caches()
        made[pkg.name] = []
        runs.append(cs.consensus_run(
            wl, str(tmp_path / pkg.name), pkg=pkg,
            services=_services(pkg, cutoff, made[pkg.name]), nodes=1,
            burst=20))
    for key in ("emitted", "externalized", "lcl", "closes", "values"):
        assert runs[0][key] == runs[1][key], key
    assert [b["bad_sig"] for b in runs[0]["bursts"]] == \
        [b["bad_sig"] for b in runs[1]["bursts"]]
    assert sum(runs[1]["bursts"][-1]["bad_sig"]) == 1
    (perf, sup, svc, rec), = made[P.name]
    sizes = [len(items) for items, _, _ in rec.calls]
    assert sizes.count(20) == 1
    assert all(n < cs.LIVE["device_min_batch"] for n in sizes if n != 20)
    # the burst of 20 is the one dispatch through the plain kernels (the
    # zone is entered at dispatch and again at collect), the rest native
    assert _zone_count(perf, "crypto.batchVerify") == 2
    assert _zone_count(perf, "crypto.batchVerify.native") == len(sizes) - 1
    (jperf, _, _, jrec), = made[J.name]
    assert [c[:2] for c in jrec.calls] == [c[:2] for c in rec.calls]
