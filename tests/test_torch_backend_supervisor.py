"""The port's BackendSupervisor against the JAX package's: the same
scripts (scripted transient, fatal and wrong-answer failures, chaos
io_error and hang faults, virtual-clock backoff and probes) run through
both over a duck-typed fake verifier, and must give the same verdicts,
the same transition log (from, to, reason, dispatch-counter snapshots,
times on the virtual clock), the same counters and the same status()
apart from wall times. One more case runs the port's supervisor over
CudaBatchVerifier(device="cpu"), the plain versions, at n <= 16.
Neither package's supervisor imports JAX, so nothing compiles here.
"""

import types

import pytest

import stellar_core_tpu.crypto.keys as jkeys
import stellar_core_tpu.ops.backend_supervisor as jsup
import stellar_core_tpu.util.chaos as jchaos
import stellar_core_tpu.util.metrics as jmetrics
import stellar_core_tpu.util.timer as jtimer
import stellar_core_tpu_torch.crypto.keys as tkeys
import stellar_core_tpu_torch.ops.backend_supervisor as tsup
import stellar_core_tpu_torch.util.chaos as tchaos
import stellar_core_tpu_torch.util.metrics as tmetrics
import stellar_core_tpu_torch.util.timer as ttimer
from stellar_core_tpu_torch.crypto import ed25519_ref as tref

REF = types.SimpleNamespace(sup=jsup, chaos=jchaos, metrics=jmetrics,
                            timer=jtimer, keys=jkeys)
PORT = types.SimpleNamespace(sup=tsup, chaos=tchaos, metrics=tmetrics,
                             timer=ttimer, keys=tkeys)


def _items(n, tag=b"sup", bad=()):
    sk = tkeys.SecretKey.pseudo_random_for_testing(8200)
    out = []
    for i in range(n):
        m = (tag + b"-%d" % i).ljust(32, b".")
        s = sk.sign(m)
        if i in bad:
            s = s[:7] + bytes([s[7] ^ 0x20]) + s[8:]
        out.append((sk.public_key().raw, s, m))
    return out


class _Fake:
    """Duck-typed device verifier with scriptable failures and a
    dispatch counter of its own; verdicts from the package's host
    verifier, or all False when `wrong` is set."""

    _device_min_batch = 7

    def __init__(self, pkg):
        self.pkg = pkg
        self.fail_with = None
        self.wrong = False
        self.dispatches = 0

    def verify_tuples_async(self, items):
        self.dispatches += 1
        if self.fail_with is not None:
            raise self.fail_with
        if self.wrong:
            return lambda: [False] * len(items)
        res = [self.pkg.keys.verify_sig_uncached(p, s, m)
               for p, s, m in items]
        return lambda: res


def _stack(pkg, **kw):
    kw.setdefault("failure_threshold", 3)
    kw.setdefault("probe_base_ms", 500.0)
    kw.setdefault("probe_max_ms", 2000.0)
    kw.setdefault("canary_batch", 2)
    clock = pkg.timer.VirtualClock(pkg.timer.ClockMode.VIRTUAL_TIME)
    reg = pkg.metrics.MetricsRegistry()
    fake = _Fake(pkg)
    sup = pkg.sup.BackendSupervisor(fake, clock=clock, metrics=reg, **kw)
    return fake, clock, reg, sup


def _snapshot(fake, reg, sup):
    """Everything the two packages must agree on; wall times dropped
    (quarantine ages, the probe timer's seconds)."""
    st = sup.status()
    for q in st["quarantined"]:
        del q["age_s"]
    counters = {}
    for name, doc in reg.to_json().items():
        counters[name] = doc["count"] if doc["type"] != "counter" else doc
    return {"status": st, "metrics": counters,
            "inner_dispatches": fake.dispatches, "state": sup.state,
            "consecutive": sup.consecutive_failures,
            "attempt": sup.probe_attempt, "mesh": sup.mesh_status()}


def _script_transient_backoff(pkg):
    items = _items(3, bad=(1,))
    fake, clock, reg, sup = _stack(pkg, jitter_seed=7)
    log = [sup.verify_tuples(items)]
    fake.fail_with = OSError("device gone")
    for _ in range(3):
        log.append(sup.verify_tuples(items))      # failures, fallback
    log.append(_snapshot(fake, reg, sup))
    for _ in range(2):
        log.append(sup.verify_tuples(items))      # OPEN: skipped
    clock.crank(True)                             # probe: still down
    log.append(_snapshot(fake, reg, sup))
    fake.fail_with = None
    clock.crank(True)                             # probe: canary ok
    log.append(sup.verify_tuples(items))
    log.append((clock.now(), _snapshot(fake, reg, sup)))
    return log


def _script_fatal_and_reset(pkg):
    items = _items(2, tag=b"fatal")
    fake, clock, reg, sup = _stack(pkg, jitter_seed=1)
    log = [pkg.sup.classify_error(e) for e in (
        ValueError("shape"), OSError("io"), TimeoutError("t"),
        ConnectionError("c"), RuntimeError("CUDA error 700"))]
    fake.fail_with = ValueError("reshape mismatch")
    log.append(sup.verify_tuples(items))          # trips at once
    log.append(_snapshot(fake, reg, sup))
    log.append(sup.probe_now())                   # still failing
    fake.fail_with = None
    log.append(sup.probe_now())                   # closes
    fake.fail_with = OSError("flap")
    sup.verify_tuples(items)
    sup.verify_tuples(items)
    fake.fail_with = None
    sup.verify_tuples(items)                      # success resets count
    sup.force_trip()
    sup.force_reset()
    log.append(sup._device_min_batch)             # proxied attribute
    log.append(_snapshot(fake, reg, sup))
    return log


def _script_wrong_answer(pkg):
    fake, clock, reg, sup = _stack(pkg, jitter_seed=3)
    fake.wrong = True
    sup.force_trip()
    log = [sup.probe_now(), _snapshot(fake, reg, sup)]
    clock.crank(True)                             # timer probe, wrong again
    fake.wrong = False
    clock.crank(True)
    log.append(_snapshot(fake, reg, sup))
    return log


def _script_chaos(pkg):
    """io_error at ops.backend.dispatch trips the breaker; a
    device-matched io_error at ops.backend.dispatch.device counts
    against device 0; a hang resolves through the 30 ms watchdog."""
    items = _items(4, tag=b"chaos", bad=(2,))
    fake, clock, reg, sup = _stack(pkg, jitter_seed=5,
                                   dispatch_deadline_ms=30.0)
    specs = [
        pkg.chaos.FaultSpec("ops.backend.dispatch", "io_error", start=1,
                            count=2),
        pkg.chaos.FaultSpec("ops.backend.dispatch.device", "io_error",
                            start=1, count=1, match={"device": 0}),
        # a spec counts only the hits that reach it: calls 1 and 2 stop
        # at the io_error spec, so this one sees call 0, call 3, the
        # probe, and then the fifth flush as its hit 3
        pkg.chaos.FaultSpec("ops.backend.dispatch", "hang", start=3,
                            count=1)]
    pkg.chaos.install(pkg.chaos.ChaosEngine(21, specs))
    log = []
    try:
        for _ in range(4):
            log.append(sup.verify_tuples(items))
        log.append(_snapshot(fake, reg, sup))
        clock.crank(True)                         # canary probe closes
        log.append(sup.verify_tuples(items))      # the hang
        log.append(_snapshot(fake, reg, sup))
        log.append(pkg.chaos.engine().log)
        log.append(pkg.chaos.engine().injected)
    finally:
        pkg.chaos.uninstall()
        sup.shutdown()
    return log


SCRIPTS = [_script_transient_backoff, _script_fatal_and_reset,
           _script_wrong_answer, _script_chaos]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[8:])
def test_port_supervisor_matches_reference(script):
    want = script(REF)
    got = script(PORT)
    assert got == want


def test_scripts_exercise_every_breaker_path():
    """What the paired scripts above hold equal, spelled out on the
    port: OPEN after three transient failures with zero device
    dispatches while OPEN, the backoff within its jitter, the canary
    closing the breaker, the fatal trip and the watchdog quarantine."""
    log = _script_transient_backoff(PORT)
    want = [tref.verify(*t) for t in _items(3, bad=(1,))]
    assert want == [True, False, True]
    assert all(v == want for v in log[:4])
    open_snap, probe_snap = log[4], log[7]
    assert open_snap["state"] == "OPEN"
    assert 0.5 <= open_snap["status"]["next_probe_in_s"] <= 0.625
    assert probe_snap["inner_dispatches"] == open_snap[
        "inner_dispatches"] + 1                   # only the canary
    assert probe_snap["status"]["skips"] == 2
    moves = [(t["from"], t["to"], t["reason"])
             for t in log[9][1]["status"]["transitions"]]
    assert moves == [("CLOSED", "OPEN", "failure_threshold"),
                     ("OPEN", "HALF_OPEN", "probe_timer"),
                     ("HALF_OPEN", "OPEN", "probe_transient"),
                     ("OPEN", "HALF_OPEN", "probe_timer"),
                     ("HALF_OPEN", "CLOSED", "probe_ok")]
    fatal = _script_fatal_and_reset(PORT)
    assert fatal[:5] == ["fatal", "transient", "transient", "transient",
                         "fatal"]
    assert fatal[6]["state"] == "OPEN"
    assert fatal[6]["status"]["failures"]["fatal"] == 1
    assert fatal[7:9] == [False, True]
    chaos = _script_chaos(PORT)
    st = chaos[6]["status"]
    assert st["failures"] == {"transient": 3, "fatal": 0, "timeout": 1}
    assert [q["batch"] for q in st["quarantined"]] in ([4], [])
    assert chaos[8]["chaos.injected.hang"] == 1


def test_port_supervisor_over_cuda_verifier_on_cpu():
    """The port's supervisor over CudaBatchVerifier(device="cpu") at
    n <= 16: CLOSED verdicts equal the oracle through the watchdog's
    collect thread; an io_error at ops.verifier.batch resolves natively
    as a transient failure; a forced trip is closed by a canary probe
    through verify_tuples_async_on(0, ...)."""
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    items = _items(6, tag=b"cpu", bad=(1, 4))
    want = [tref.verify(*t) for t in items]
    clock = ttimer.VirtualClock(ttimer.ClockMode.VIRTUAL_TIME)
    sup = tsup.BackendSupervisor(
        CudaBatchVerifier(device="cpu", device_min_batch=2), clock=clock,
        metrics=tmetrics.MetricsRegistry(), canary_batch=2)
    try:
        assert sup.verify_tuples(items) == want
        assert sup._device_min_batch == 2
        tchaos.install(tchaos.ChaosEngine(2, [tchaos.FaultSpec(
            "ops.verifier.batch", "io_error", start=0, count=1)]))
        try:
            assert sup.verify_tuples(items) == want
        finally:
            tchaos.uninstall()
        assert sup.status()["failures"]["transient"] == 1
        assert sup.state == "CLOSED"
        sup.force_trip()
        assert sup.verify_tuples(items[:3]) == want[:3]   # native, skip
        calls = []
        real = sup._inner.verify_tuples_async_on
        sup._inner.verify_tuples_async_on = \
            lambda i, it: calls.append((i, len(it))) or real(i, it)
        assert sup.probe_now() is True
        assert calls == [(0, 2)] and sup.state == "CLOSED"
        st = sup.status()
        assert st["dispatches"] == 3 and st["skips"] == 1
    finally:
        sup.shutdown()
