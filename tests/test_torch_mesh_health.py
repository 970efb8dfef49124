"""The per-device breakers of the port's BackendSupervisor against the JAX
package's, with more than one device: the breaker tier of
tests/test_mesh_health.py as scripts run through both packages, each over
its own four-position host-verify mesh fake (no XLA, no plain versions),
compared on verdicts, transitions with their device-dispatch snapshots,
counters, the fakes' active-set logs and status() apart from wall times.
The sick-device window is the reference's chaos script
(simulation/chaos.py run_sick_device_window) ported here; one more case
runs it over the port's ShardedBatchVerifier on four CPU positions, the
plain versions.
"""

import types

import pytest
import torch

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

REF = types.SimpleNamespace(sup=jsup, chaos=jchaos, metrics=jmetrics,
                            timer=jtimer, keys=jkeys)
PORT = types.SimpleNamespace(sup=tsup, chaos=tchaos, metrics=tmetrics,
                             timer=ttimer, keys=tkeys)
# status() fields read from the wall clock (every clock when the
# supervisor has none; quarantine ages always)
_WALL = ("t", "next_probe_in_s", "last_probe_age_s")


def _items(n, seed, bad=()):
    sk = tkeys.SecretKey.pseudo_random_for_testing(seed)
    out = []
    for i in range(n):
        m = (b"mesh-%d-%d" % (seed, i)).ljust(32, b".")
        s = sk.sign(m)
        if i in bad:
            s = s[:9] + bytes([s[9] ^ 0x08]) + s[10:]
        out.append((sk.public_key().raw, s, m))
    return out


class _Mesh:
    """An N-position mesh stand-in with host-side verify, duck-typing the
    ShardedBatchVerifier surface the supervisor drives (the reference's
    FakeMeshVerifier and _HostMeshVerifier): one per package, verdicts
    from that package's host verifier."""

    _device_min_batch = 1

    def __init__(self, pkg, ndev=4):
        self.pkg = pkg
        self.ndev = ndev
        self._active = tuple(range(ndev))
        self.active_log = []
        self.fail_with = None
        self.probe_pins = []
        self.dispatches = 0

    def set_active_devices(self, indices):
        self._active = tuple(sorted(int(i) for i in indices))
        self.active_log.append(self._active)

    def active_indices(self):
        return self._active

    def verify_tuples_async(self, items):
        self.dispatches += 1
        if self.fail_with is not None:
            raise self.fail_with
        res = [self.pkg.keys.verify_sig_uncached(p, s, m)
               for p, s, m in items]
        return lambda: res

    def verify_tuples_async_on(self, device_index, items):
        self.probe_pins.append(int(device_index))
        return self.verify_tuples_async(items)


def _strip(doc, wall):
    """doc without the fields the wall clock sets."""
    if isinstance(doc, dict):
        return {k: _strip(v, wall) for k, v in doc.items()
                if k != "age_s" and not (wall and k in _WALL)}
    if isinstance(doc, list):
        return [_strip(v, wall) for v in doc]
    return doc


def _snapshot(fake, reg, sup, wall):
    counters = {}
    for name, doc in reg.to_json().items():
        counters[name] = doc["count"] if doc["type"] != "counter" else doc
    return {"status": _strip(sup.status(), wall), "metrics": counters,
            "state": sup.state, "mesh": sup.mesh_status(),
            "active_log": list(fake.active_log),
            "probe_pins": list(fake.probe_pins),
            "inner_dispatches": fake.dispatches}


def _sup(pkg, fake, clock=None, **kw):
    kw.setdefault("failure_threshold", 2)
    kw.setdefault("probe_base_ms", 100.0)
    kw.setdefault("probe_max_ms", 400.0)
    kw.setdefault("canary_batch", 2)
    reg = pkg.metrics.MetricsRegistry()
    return reg, pkg.sup.BackendSupervisor(fake, clock=clock, metrics=reg,
                                          **kw)


def sick_device_window(pkg, inner, seed=11, ndev=4, sick=2, flushes=10):
    """simulation/chaos.py run_sick_device_window of the JAX package, on
    either package and any inner verifier: a device-matched io_error
    window on ops.backend.dispatch.device trips exactly the sick
    position, the mesh shrinks around it with zero dispatches to it while
    its siblings serve exactly, and after the window the canary probes
    readmit it. Returns the reference's verdict flags and record."""
    threshold = 2
    window = threshold + 1      # trip consumes 2 hits, first probe 1
    sup = pkg.sup.BackendSupervisor(inner, clock=None,
                                    failure_threshold=threshold,
                                    probe_base_ms=100.0, probe_max_ms=400.0,
                                    canary_batch=4, jitter_seed=seed,
                                    chaos_label="sickdev")
    sk = pkg.keys.SecretKey.pseudo_random_for_testing(seed)
    items = []
    for i in range(6):
        msg = (b"sick-%d" % i).ljust(32, b".")
        items.append((sk.public_key().raw, sk.sign(msg), msg))
    items[4] = (items[4][0], b"\x01" * 64, items[4][2])   # one invalid
    want = [pkg.keys.verify_sig_uncached(p, s, m) for p, s, m in items]
    eng = pkg.chaos.ChaosEngine(seed, [pkg.chaos.FaultSpec(
        "ops.backend.dispatch.device", "io_error", start=0,
        count=window, match={"device": sick})])
    pkg.chaos.install(eng)
    exact = True
    agg_during_outage = []
    try:
        for _ in range(flushes):
            exact = exact and sup.verify_tuples(items) == want
            if sup.status()["devices"][sick]["state"] == "OPEN":
                agg_during_outage.append(sup.state)
        st = sup.status()
        survivors = [d for d in st["devices"] if d["device"] != sick]
        sick_row = st["devices"][sick]
        tripped = sick_row["state"] == "OPEN"
        siblings_closed = all(d["state"] == "CLOSED" for d in survivors)
        trip_snap = next((t["device_dispatches"]
                          for t in reversed(st["transitions"])
                          if t["device"] == sick and t["to"] == "OPEN"),
                         None)
        quiet = trip_snap is not None and \
            sick_row["dispatches"] == trip_snap
        siblings_served = all(d["dispatches"] > trip_snap
                              for d in survivors) if tripped else False
        shrunk = inner.active_indices() == tuple(
            i for i in range(ndev) if i != sick)
        probe1 = sup.probe_now(device=sick)
        probe2 = sup.probe_now(device=sick)
        regrown = inner.active_indices() == tuple(range(ndev)) and \
            sup.status()["devices"][sick]["state"] == "CLOSED"
        flags = {
            "exact": bool(exact),
            "tripped": bool(tripped),
            "siblings_closed": bool(siblings_closed),
            "quiet_while_open": bool(quiet),
            "siblings_served": bool(siblings_served),
            "shrunk": bool(shrunk),
            "probe_in_window_failed": bool(not probe1),
            "regrown": bool(regrown),
            "aggregate_stayed_closed": bool(
                all(s == "CLOSED" for s in agg_during_outage)),
        }
        return dict(flags, ok=all(flags.values()),
                    injected=dict(eng.injected), log=list(eng.log),
                    status=_strip(sup.status(), wall=True))
    finally:
        pkg.chaos.uninstall()
        sup.shutdown()


# ------------------------------------------------------------ scripts --

def _script_sick_device_window(pkg):
    fake = _Mesh(pkg)
    out = sick_device_window(pkg, fake, seed=11)
    return out, fake.active_log, fake.probe_pins


def _script_device_matched_hang(pkg):
    """A hang matched to one device pins the timeout and the quarantined
    handle to that device; its siblings stay CLOSED."""
    fake = _Mesh(pkg, ndev=3)
    reg, sup = _sup(pkg, fake, dispatch_deadline_ms=40.0,
                    failure_threshold=1)
    items = _items(3, 34)
    pkg.chaos.install(pkg.chaos.ChaosEngine(9, [pkg.chaos.FaultSpec(
        "ops.backend.dispatch.device", "hang", start=0, count=1,
        match={"device": 1})]))
    try:
        got = sup.verify_tuples(items)
        snap = _snapshot(fake, reg, sup, wall=True)
        return got, snap, pkg.chaos.engine().log
    finally:
        pkg.chaos.uninstall()
        sup.shutdown()


def _script_unattributable_failure(pkg):
    """A whole-dispatch failure implicates every participant: after the
    threshold all trip, the mesh is empty, the aggregate goes OPEN and
    flushes skip to the host verifier with frozen device counters."""
    fake = _Mesh(pkg)
    reg, sup = _sup(pkg, fake)
    items = _items(2, 35, bad=(1,))
    fake.fail_with = OSError("link flap")
    log = [sup.verify_tuples(items), sup.state,
           sup.verify_tuples(items), sup.state,
           _snapshot(fake, reg, sup, wall=True)]
    for _ in range(3):
        log.append(sup.verify_tuples(items))
    log.append(_snapshot(fake, reg, sup, wall=True))
    fake.fail_with = None
    sup.force_reset()
    log.append(_snapshot(fake, reg, sup, wall=True))
    sup.shutdown()
    return log


def _script_aggregate_closed_until_empty(pkg):
    fake = _Mesh(pkg, ndev=3)
    reg, sup = _sup(pkg, fake)
    log = []
    for dev in (0, 2, 1):
        sup.force_trip(device=dev)
        log.append((sup.state, sup.mesh_status(), fake.active_indices()))
    sup.force_reset(device=1)
    log.append((sup.state, sup.mesh_status(), fake.active_indices()))
    log.append(_snapshot(fake, reg, sup, wall=True))
    sup.shutdown()
    return log


def _script_probe_timer_regrows(pkg):
    """Each device's probe timer on the virtual clock is its own backoff
    stream: one tripped device probes HALF_OPEN -> CLOSED pinned to
    itself, its siblings never move."""
    clock = pkg.timer.VirtualClock(pkg.timer.ClockMode.VIRTUAL_TIME)
    fake = _Mesh(pkg)
    reg, sup = _sup(pkg, fake, clock=clock, jitter_seed=5)
    sup.force_trip(device=2)
    log = [_snapshot(fake, reg, sup, wall=False)]
    clock.crank(True)                         # the probe timer fires
    log.append((clock.now(), _snapshot(fake, reg, sup, wall=False)))
    sup.shutdown()
    return log


def _script_status_rows_and_targeted_actions(pkg):
    """status() per-device rows under a device-targeted trip, traffic
    over the degraded mesh, a reset, and an out-of-range device."""
    clock = pkg.timer.VirtualClock(pkg.timer.ClockMode.VIRTUAL_TIME)
    fake = _Mesh(pkg)
    reg, sup = _sup(pkg, fake, clock=clock, jitter_seed=2)
    items = _items(4, 36, bad=(3,))
    sup.force_trip(device=3)
    log = [sup.verify_tuples(items), _snapshot(fake, reg, sup, wall=False)]
    sup.force_reset(device=3)
    log.append(sup.verify_tuples(items))
    for action in (sup.force_trip, sup.force_reset):
        try:
            action(device=42)
            log.append(None)
        except Exception as e:                # the same class in both
            log.append(type(e).__name__)
    log.append(_snapshot(fake, reg, sup, wall=False))
    sup.shutdown()
    return log


SCRIPTS = [_script_sick_device_window, _script_device_matched_hang,
           _script_unattributable_failure,
           _script_aggregate_closed_until_empty,
           _script_probe_timer_regrows,
           _script_status_rows_and_targeted_actions]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[8:])
def test_port_breakers_match_reference(script):
    want = script(REF)
    got = script(PORT)
    assert got == want


def test_scripts_show_the_per_device_behaviour():
    """What the paired scripts hold equal, spelled out on the port as
    tests/test_mesh_health.py asserts it on the reference."""
    window, active_log, pins = _script_sick_device_window(PORT)
    assert window["ok"], window
    assert active_log == [(0, 1, 3), (0, 1, 2, 3)] and pins == [2]
    moves = [(t["device"], t["from"], t["to"], t["reason"])
             for t in window["status"]["transitions"]]
    assert moves == [(2, "CLOSED", "OPEN", "failure_threshold"),
                     (2, "OPEN", "HALF_OPEN", "probe_timer"),
                     (2, "HALF_OPEN", "OPEN", "probe_transient"),
                     (2, "OPEN", "HALF_OPEN", "probe_timer"),
                     (2, "HALF_OPEN", "CLOSED", "probe_ok")]
    assert window == _script_sick_device_window(PORT)[0]   # one seed

    got, snap, _ = _script_device_matched_hang(PORT)
    st = snap["status"]
    assert got == [True] * 3
    assert [d["state"] for d in st["devices"]] == ["CLOSED", "OPEN",
                                                   "CLOSED"]
    assert st["failures"]["timeout"] == 1 and st["state"] == "CLOSED"
    assert [q["device"] for q in st["quarantined"]] == [1]
    assert snap["active_log"] == [(0, 2)]

    log = _script_unattributable_failure(PORT)
    assert log[0] == log[2] == [True, False]
    assert (log[1], log[3]) == ("CLOSED", "OPEN")
    frozen, after = log[4], log[8]
    assert frozen["mesh"]["active"] == 0
    assert [d["dispatches"] for d in after["status"]["devices"]] == \
        [d["dispatches"] for d in frozen["status"]["devices"]] == [2] * 4
    assert after["status"]["skips"] == frozen["status"]["skips"] + 3
    assert log[9]["state"] == "CLOSED" and \
        log[9]["mesh"]["active_indices"] == [0, 1, 2, 3]

    agg = _script_aggregate_closed_until_empty(PORT)
    assert [(s, m["active"], a) for s, m, a in agg[:4]] == [
        ("CLOSED", 2, (1, 2)), ("CLOSED", 1, (1,)), ("OPEN", 0, (1,)),
        ("CLOSED", 1, (1,))]

    before, (now, after) = _script_probe_timer_regrows(PORT)
    assert before["active_log"] == [(0, 1, 3)]
    assert before["status"]["devices"][2]["next_probe_in_s"] is not None
    assert now > 0 and after["probe_pins"] == [2]
    assert after["mesh"]["active_indices"] == [0, 1, 2, 3]
    assert [(t["device"], t["from"], t["to"])
            for t in after["status"]["transitions"]] == [
        (2, "CLOSED", "OPEN"), (2, "OPEN", "HALF_OPEN"),
        (2, "HALF_OPEN", "CLOSED")]

    rows = _script_status_rows_and_targeted_actions(PORT)
    assert rows[0] == rows[2] == [True, True, True, False]
    st = rows[1]["status"]
    assert st["state"] == "CLOSED" and st["mesh"]["active"] == 3
    assert [d["state"] for d in st["devices"]] == ["CLOSED"] * 3 + ["OPEN"]
    assert [d["skips"] for d in st["devices"]] == [0, 0, 0, 1]
    assert rows[1]["metrics"]["crypto.verify_backend.device3.skip"] == \
        {"type": "counter", "count": 1}
    assert rows[3:5] == ["IndexError", "IndexError"]
    assert rows[5]["mesh"]["active"] == 4


def test_sick_device_window_over_the_sharded_verifier():
    """The window over ShardedBatchVerifier on four CPU positions (the
    plain versions): the same verdict flags and transitions as over the
    host fake, and the sick position's per-device batch count frozen
    while it is OPEN. Three flushes, not ten: two trip it and one is
    served by the three siblings, each shard a plain-version run here."""
    from stellar_core_tpu_torch.ops.verifier import ShardedBatchVerifier
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        reg = tmetrics.MetricsRegistry()
        real = ShardedBatchVerifier(["cpu"] * 4, device_min_batch=1,
                                    device_sha=True, metrics=reg)
        counts = []
        real_probe = real.verify_tuples_async_on

        def probe(i, items):
            counts.append([reg.to_json()[
                "crypto.verify.dispatch.device%d.batch" % d]["count"]
                for d in range(4)])
            return real_probe(i, items)
        real.verify_tuples_async_on = probe
        got = sick_device_window(PORT, real, flushes=3)
    finally:
        torch.set_num_threads(prev)
    want = sick_device_window(PORT, _Mesh(PORT), flushes=3)
    assert got["ok"], got
    assert got == want
    # flushes 1-2 failed at the sick device's seam before any dispatch,
    # flush 3 went to positions 0, 1, 3; the first probe failed at the
    # seam; the second reached position 2 alone
    m = reg.to_json()
    assert counts == [[1, 1, 0, 1]]
    assert [m["crypto.verify.dispatch.device%d.batch" % d]["count"]
            for d in range(4)] == [1, 1, 1, 1]
    assert real.active_indices() == (0, 1, 2, 3)
