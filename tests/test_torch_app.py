"""The node's application layer (main/, the control plane it builds, the
overlay, query/ and simulation/): the JAX package's and the port's side
by side.

Every module the slice copied equals the reference's on the AST, its
docstrings aside, once the package name is swapped, except for the
device backend's deliberate differences (DIFFERENCES, ROADMAP.md
Queue 3): those lines are put back to the reference's before the
comparison, so every other line is held.

The JAX package's tests/test_standalone_app.py, test_restart.py,
test_herder_scp.py, test_config_knobs.py and test_hardening.py run
twice: as written, and rebound to the port (tests/torch_rebind.py); the
two records (tests/torch_node_parity.py: every try_add result and every
close's sequence, result hash and header hash) must be equal. Where a
test selects the device backend, both Applications build a counting
host verifier in its place: nothing compiles and nothing launches.

The repo's config files (docs/*.cfg) load to equal fields in both
packages, and a port node boots from the standalone one, closes ledgers
through the `manualclose` route and reloads its LCL after a restart.
With the device backend and no card, building a port node raises: it
never falls back to the native verifier. The `recordstart` route,
`Simulation.record_all` and `Simulation.merged_trace` give what the JAX
package's give.
"""

import base64
import collections
import importlib
from pathlib import Path

import pytest
import torch

import test_config_knobs as ref_config_knobs
import test_hardening as ref_hardening
import test_herder_scp as ref_herder_scp
import test_restart as ref_restart
import test_standalone_app as ref_standalone_app
import txtest_utils
from torch_node_parity import run_both
from torch_rebind import helper_module, module_code, reference_cases
from torch_tx_parity import J, P

ROOT = Path(__file__).resolve().parents[1]
# the modules this slice copied, in the reference's import order, with
# the package name swapped
COPIED = ("util/rand.py", "util/status.py", "util/scheduler.py",
          "util/__init__.py", "crypto/curve25519.py", "overlay/wire.py",
          "overlay/flow_control.py", "overlay/floodgate.py",
          "overlay/item_fetcher.py", "overlay/tx_advert.py",
          "overlay/peer_auth.py", "overlay/peer.py", "overlay/loopback.py",
          "overlay/tcp_peer.py", "overlay/peer_manager.py",
          "overlay/propagation.py", "overlay/survey.py",
          "overlay/manager.py", "overlay/__init__.py", "ops/slo.py",
          "util/timeseries.py", "ops/controller.py", "query/snapshot.py",
          "query/tx_status.py", "query/service.py", "query/__init__.py",
          "main/config.py", "main/maintainer.py", "main/self_check.py",
          "main/command_handler.py", "main/application.py",
          "main/__init__.py", "simulation/simulation.py",
          "simulation/topologies.py", "simulation/load_generator.py",
          "simulation/__init__.py", "__init__.py")
# the device backend's deliberate differences: (the port's code, the
# reference's), each once in its file
DIFFERENCES = {
    "main/application.py": [
        ('SIGNATURE_VERIFY_BACKEND in ("cuda", "tpu"):',
         'SIGNATURE_VERIFY_BACKEND == "tpu":'),
        ("        import torch\n\n        mode =",
         "        import jax\n\n        mode ="),
        ("ndev = torch.cuda.device_count()", "ndev = len(jax.devices())"),
        ("import CudaBatchVerifier\n            return CudaBatchVerifier(",
         "import TpuBatchVerifier\n            return TpuBatchVerifier("),
        ('if backend in ("cuda", "tpu"):', 'if backend == "tpu":'),
        # info reports whether the native XDR codec serves
        ("        from ..xdr import runtime as xdr_runtime\n", ""),
        ('            "xdr_native": xdr_runtime._nc() is not None,\n', "")],
    "main/self_check.py": [
        ('in ("cuda",\n' + " " * 63 + '"tpu"):', '== "tpu":'),
        ("import CudaBatchVerifier", "import TpuBatchVerifier"),
        ("v = CudaBatchVerifier(", "v = TpuBatchVerifier(")],
    "main/command_handler.py": [
        ('"(SIGNATURE_VERIFY_BACKEND is not cuda or tpu)"',
         '"(SIGNATURE_VERIFY_BACKEND != tpu)"')],
}


@pytest.mark.parametrize("path", COPIED)
def test_copied_modules_equal_the_reference_on_the_ast(path, tmp_path):
    port = ROOT / "stellar_core_tpu_torch" / path
    text = port.read_text()
    for ours, theirs in DIFFERENCES.get(path, ()):
        assert text.count(ours) == 1, ours
        text = text.replace(ours, theirs)
    put_back = tmp_path / "module.py"
    put_back.write_text(text)
    assert module_code(put_back) == \
        module_code(ROOT / "stellar_core_tpu" / path, swap=True)


# ------------------------------------------------ rebound reference tests --

MODULES = (ref_standalone_app, ref_restart, ref_herder_scp, ref_config_knobs,
           ref_hardening)
CASES = [c for m in MODULES for c in reference_cases(m)]


@pytest.mark.parametrize("case", CASES)
def test_reference_app_tests_on_both_with_equal_records(case, tmp_path,
                                                        caplog):
    jax_run, port_run = run_both(case, tmp_path,
                                 builtin={"caplog": caplog})
    assert jax_run == port_run


def test_cases_cover_every_reference_test():
    names = {(c.values[0][0].__name__, c.values[0][2]) for c in CASES}
    for module in MODULES:
        for n, obj in vars(module).items():
            if n.startswith("test_") and callable(obj):
                assert (module.__name__, n) in names, n
    assert len(CASES) == 62


def test_the_runs_record_closes(tmp_path):
    """The recorder sees a reference test's closes and submissions: the
    standalone node's submit-and-close test, with equal header hashes."""
    case = next(c.values[0] for c in CASES if c.values[0][2] ==
                "test_submit_and_manual_close")
    jax_run, port_run = run_both(case, tmp_path)
    closes = [r for r in port_run if r[0] == "close"]
    assert closes and closes == [r for r in jax_run if r[0] == "close"]
    assert all(len(r[3]) == 32 for r in closes)
    assert ("add", "ADD_STATUS_PENDING") in port_run


# ------------------------------------------------------ the repo's configs --

def _fields(value):
    """A Config field as plain data: a SecretKey by its seed, a quorum
    set by its threshold, validators and inner sets."""
    if hasattr(value, "threshold") and hasattr(value, "validators"):
        return (value.threshold, [bytes(v) for v in value.validators],
                [_fields(s) for s in value.inner_sets])
    if hasattr(value, "public_key") and hasattr(value, "sign"):
        return ("seed", value.public_key().raw)
    return value


@pytest.mark.parametrize("name", ["stellar-core-tpu_standalone.cfg",
                                  "stellar-core-tpu_testnet_validator.cfg"])
def test_repo_configs_load_alike(name):
    cfgs = [pkg.config.Config.load(str(ROOT / "docs" / name))
            for pkg in (J, P)]
    fields = [{k: _fields(v) for k, v in vars(c).items()
               if k != "_fallback_jitter_seed"} for c in cfgs]
    assert fields[0] == fields[1]
    assert len(fields[1]) > 150
    assert cfgs[1].network_id() == cfgs[0].network_id()


def _standalone(tmp_path):
    cfg = P.config.Config.load(str(ROOT / "docs" /
                                   "stellar-core-tpu_standalone.cfg"))
    cfg.DATABASE = "sqlite3://" + str(tmp_path / "stellar.db")
    cfg.BUCKET_DIR_PATH = str(tmp_path / "buckets")
    # the file's archive writes under the system's temporary directory
    cfg.HISTORY = {"local": {
        "get": f"cp {tmp_path}/history/{{0}} {{1}}",
        "put": f"mkdir -p $(dirname {tmp_path}/history/{{1}}) && "
               f"cp {{0}} {tmp_path}/history/{{1}}"}}
    return cfg


def test_port_node_boots_from_the_standalone_config(tmp_path):
    """Booted from docs/stellar-core-tpu_standalone.cfg (its database,
    buckets and archive in tmp_path), a port node closes three ledgers
    through the `manualclose` route, one holding a payment submitted
    through the `tx` route, and a second node on the same files reloads
    that LCL and closes on."""
    clock = P.timer.VirtualClock(P.timer.ClockMode.VIRTUAL_TIME)
    app = P.application.Application.create(clock, _standalone(tmp_path))
    try:
        app.start()
        ch = app.command_handler
        assert ch.handle("info")["info"]["state"] == "Synced!"
        m1 = helper_module(ref_standalone_app)
        dest = P.keys.SecretKey.from_seed(bytes(32))
        frame = m1.master_account(app).tx([
            helper_module(txtest_utils).op_create_account(
                m1.AppAccount(app, dest).account_id, 100_0000000)])
        blob = base64.b64encode(frame.envelope.to_bytes()).decode()
        assert ch.handle("tx", {"blob": blob})["status"] == "PENDING"
        for _ in range(3):
            assert "exception" not in ch.handle("manualclose")
        lm = app.ledger_manager
        lcl = (lm.get_last_closed_ledger_num(),
               lm.get_last_closed_ledger_hash())
        assert lcl[0] == 4
        assert m1.app_account_entry(
            app, m1.AppAccount(app, dest).account_id) is not None
    finally:
        app.shutdown()
    again = P.application.Application.create(
        P.timer.VirtualClock(P.timer.ClockMode.VIRTUAL_TIME),
        _standalone(tmp_path), new_db=False)
    try:
        again.start()
        lm = again.ledger_manager
        assert (lm.get_last_closed_ledger_num(),
                lm.get_last_closed_ledger_hash()) == lcl
        assert "exception" not in again.command_handler.handle("manualclose")
        assert lm.get_last_closed_ledger_num() == 5
    finally:
        again.shutdown()


# ------------------------------------------------------- no card, no node --

@pytest.mark.parametrize("backend", ["cuda", "tpu"])
def test_device_backend_without_a_card_raises(backend, monkeypatch,
                                              tmp_path):
    """Building a node on the device backend with no card raises through
    resolve_device, for either backend name; it never builds the native
    verifier in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    cfg = P.config.get_test_config()
    cfg.SIGNATURE_VERIFY_BACKEND = backend
    cfg.BUCKET_DIR_PATH = str(tmp_path / "buckets")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.application.Application.create(
            P.timer.VirtualClock(P.timer.ClockMode.VIRTUAL_TIME), cfg)


def test_unknown_backend_raises_in_both(tmp_path):
    for pkg in (J, P):
        cfg = pkg.config.get_test_config()
        cfg.SIGNATURE_VERIFY_BACKEND = "gpu"
        cfg.BUCKET_DIR_PATH = str(tmp_path / pkg.name)
        with pytest.raises(ValueError, match="SIGNATURE_VERIFY_BACKEND"):
            pkg.application.Application.create(
                pkg.timer.VirtualClock(pkg.timer.ClockMode.VIRTUAL_TIME),
                cfg)


# ------------------------------------------- recording and the merged trace --

def test_record_start_names_the_missing_replay_module():
    """The `recordstart` route, which raised naming the replay module
    until replay/ was ported (the test keeps that name), starts a node's
    input recorder, and `recordstop` reports what it recorded, with
    equal documents from a port node and a JAX one."""
    outs = []
    for pkg in (J, P):
        clock = pkg.timer.VirtualClock(pkg.timer.ClockMode.VIRTUAL_TIME)
        with pkg.application.Application.create(
                clock, pkg.config.get_test_config()) as app:
            app.start()
            h = app.command_handler
            started = h.handle("recordstart")
            # a test config's node key depends on how many the process
            # made before, in each package
            assert started.pop("node") == app.config.node_id().hex()
            app.crank(False)
            app.crank(True)
            outs.append((started, h.handle("recordstop")))
    assert outs[0][0]["status"] == "recording"
    assert outs[0][1]["records"] > 0
    assert outs[1] == outs[0]


def test_simulation_record_and_merged_trace_name_their_modules():
    """`Simulation.record_all` and `merged_trace` raised naming their
    missing modules until replay/ and util/tracemerge.py were ported
    (the test keeps that name). `record_all` gives every node of a pair a
    recorder,
    whose logs `finish_recording` returns, with the same records by
    type and length in both packages (the handshakes' nonces are drawn
    afresh), and `merged_trace` has one process lane per node, with the
    same lanes and the same events by name (the metadata events aside:
    they name the process's threads, which earlier tests leave)."""
    runs = []
    for pkg in (J, P):
        sim = importlib.import_module(
            pkg.name + ".simulation.topologies").pair()
        try:
            sim.record_all()
            sim.start_tracing()
            sim.start_all_nodes()
            assert sim.crank_until(lambda: sim.have_all_externalized(3))
            logs = sim.finish_recording()
            doc = sim.merged_trace()
        finally:
            sim.stop_all_nodes()
        events = doc["traceEvents"]
        runs.append((
            {k: [(r.rtype, len(r.data)) for r in v.records]
             for k, v in logs.items()},
            [e["args"] for e in events if e.get("ph") == "M"
             and e.get("name") == "process_name"],
            collections.Counter(e.get("name") for e in events
                                if e.get("ph") != "M")))
    logs, lanes, names = runs[1]
    assert len(logs) == 2 and all(logs.values())
    assert len(lanes) == 2
    assert names["flood.hop"] > 0
    assert runs[1] == runs[0]
