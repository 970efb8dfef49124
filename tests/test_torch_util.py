"""The port's util layer against the JAX package's: chaos, timer, cache,
metrics, perf and tracing, fed the same inputs (made from a seed with
numpy), must behave the same. The fault schedule is the state that
crosses between the two packages: one written by the JAX package's
FaultSpec.to_json loads through the port's schedule_from_json.
Every module here is free of JAX in both packages, so nothing compiles.
"""

import json

import numpy as np
import pytest

from stellar_core_tpu.crypto import keys as jkeys
from stellar_core_tpu.util import cache as jcache
from stellar_core_tpu.util import chaos as jchaos
from stellar_core_tpu.util import metrics as jmetrics
from stellar_core_tpu.util import perf as jperf
from stellar_core_tpu.util import timer as jtimer
from stellar_core_tpu.util import tracing as jtracing
from stellar_core_tpu_torch.crypto import keys as tkeys
from stellar_core_tpu_torch.util import cache as tcache
from stellar_core_tpu_torch.util import chaos as tchaos
from stellar_core_tpu_torch.util import metrics as tmetrics
from stellar_core_tpu_torch.util import perf as tperf
from stellar_core_tpu_torch.util import timer as ttimer
from stellar_core_tpu_torch.util import tracing as ttracing

# points and contexts the schedule below targets; payloads are bytes
# so corrupt / malformed_xdr act, and `_can_delay` lets delay fire
POINTS = ("ops.backend.dispatch", "ops.backend.dispatch.device",
          "ops.verifier.batch", "ops.verify_service.flush", "overlay.send")


def _schedule_docs():
    """A schedule covering the hit-window, probabilistic, matched and
    payload-mangling paths, as JSON documents."""
    return [
        {"point": "ops.backend.dispatch", "kind": "io_error", "start": 2,
         "count": 3},
        {"point": "ops.backend.dispatch.device", "kind": "hang",
         "start": 1, "count": 2, "match": {"device": 1}},
        {"point": "ops.verifier.batch", "kind": "io_error", "start": 0,
         "count": 1, "prob": 0.3},
        {"point": "ops.verify_service.flush", "kind": "fail", "start": 4,
         "count": 2},
        {"point": "overlay.send", "kind": "corrupt", "start": 0,
         "count": 100, "prob": 0.2},
        {"point": "overlay.send", "kind": "malformed_xdr", "start": 0,
         "count": 100, "prob": 0.25},
        {"point": "overlay.send", "kind": "delay", "start": 3,
         "count": 20, "delay_ms": 7.5},
        {"point": "overlay.send", "kind": "drop", "start": 10, "count": 4},
    ]


def _calls(n, seed):
    """n point calls: (point, payload, ctx), from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        point = POINTS[int(rng.integers(len(POINTS)))]
        payload = rng.integers(0, 256, int(rng.integers(1, 40)),
                               dtype=np.uint8).tobytes()
        ctx = {"device": int(rng.integers(3)), "n": int(rng.integers(64))}
        if point == "overlay.send":
            ctx["_can_delay"] = bool(rng.integers(2))
        out.append((point, payload, ctx))
    return out


def _outcome(mod, res):
    """A comparable description of what fire() returned."""
    for name in ("DROP", "REORDER", "FAIL", "HANG", "EQUIVOCATE"):
        if res is getattr(mod, name):
            return name
    if isinstance(res, mod.Delay):
        return ("delay", res.payload, res.seconds)
    return ("payload", res)


def _run(mod, engine, calls):
    outcomes = []
    for point, payload, ctx in calls:
        try:
            outcomes.append(_outcome(mod, engine.fire(point, payload,
                                                      dict(ctx))))
        except mod.ChaosError as e:
            outcomes.append(("raise", type(e).__name__, str(e)))
    return outcomes


@pytest.mark.parametrize("seed", [3, 11])
def test_chaos_same_schedule_fires_same_faults(seed):
    """The same seed and FaultSpec schedule fire at the same hit
    ordinals with the same kinds, the same corrupted bytes and the
    same counters."""
    docs = _schedule_docs()
    calls = _calls(400, seed)
    jeng = jchaos.ChaosEngine(seed, jchaos.schedule_from_json(docs))
    teng = tchaos.ChaosEngine(seed, tchaos.schedule_from_json(docs))
    assert _run(tchaos, teng, calls) == _run(jchaos, jeng, calls)
    assert teng.log == jeng.log
    assert len(teng.log) > 20
    assert {k for _, _, _, k in teng.log} >= {
        "io_error", "hang", "fail", "corrupt", "malformed_xdr", "delay",
        "drop"}
    assert teng.injected == jeng.injected
    assert teng.point_hits == jeng.point_hits
    assert teng.status() == jeng.status()


def test_chaos_schedule_written_by_reference_loads_in_port():
    """FaultSpec.to_json of the JAX package, through JSON text, into the
    port's schedule_from_json: the same specs back, and the same faults
    on the same calls."""
    jspecs = jchaos.schedule_from_json(_schedule_docs()) + [
        jchaos.FaultSpec("ops.backend.dispatch", "hang", start=2, count=3),
        jchaos.FaultSpec("overlay.send", "flap", window_s=2.0,
                         period_s=0.5, duty=0.4),
        jchaos.FaultSpec("overlay.send", "slow_link", delay_ms=3.0,
                         bps=1e6, window_s=1.0),
        jchaos.FaultSpec("overlay.send", "bad_sig_flood", burst=5,
                         start=1)]
    text = json.dumps([s.to_json() for s in jspecs])
    tspecs = tchaos.schedule_from_json(json.loads(text))
    assert [s.to_json() for s in tspecs] == [s.to_json() for s in jspecs]
    for t, j in zip(tspecs, jspecs):
        assert [getattr(t, k) for k in t.__slots__] == \
            [getattr(j, k) for k in j.__slots__]
    calls = _calls(200, 5)
    jeng, teng = jchaos.ChaosEngine(9, jspecs), tchaos.ChaosEngine(9, tspecs)
    assert _run(tchaos, teng, calls) == _run(jchaos, jeng, calls)
    assert teng.log == jeng.log


def test_chaos_module_guard_install_uninstall():
    """point() is a no-op until install(); install flips ENABLED and
    routes through the engine; uninstall restores both. The two
    packages' guards are separate module constants."""
    for mod in (jchaos, tchaos):
        assert mod.ENABLED is False and mod.engine() is None
        assert mod.point("ops.verifier.batch", b"x", n=1) == b"x"
    spec = tchaos.FaultSpec("ops.verifier.batch", "io_error", start=1)
    tchaos.install(tchaos.ChaosEngine(1, [spec]))
    try:
        assert tchaos.ENABLED and not jchaos.ENABLED
        assert tchaos.point("ops.verifier.batch", n=1) is None
        with pytest.raises(OSError):
            tchaos.point("ops.verifier.batch", n=1)
        assert tchaos.status()["injected"] == {"chaos.injected.io_error": 1}
    finally:
        tchaos.uninstall()
    assert tchaos.ENABLED is False and tchaos.status() == {"enabled": False}
    with pytest.raises(ValueError):
        tchaos.FaultSpec("p", "no_such_kind")


def _clock_script(mod, seed):
    """Timers armed, re-armed and cancelled from a numpy seed on a
    virtual clock; returns the firing order with virtual times."""
    rng = np.random.default_rng(seed)
    clock = mod.VirtualClock(mod.ClockMode.VIRTUAL_TIME)
    fired = []
    timers = []
    for i in range(40):
        t = mod.VirtualTimer(clock)
        t.expires_from_now(float(rng.integers(0, 50)) / 10.0)
        t.async_wait(lambda i=i: fired.append(("fire", i, clock.now())),
                     lambda i=i: fired.append(("cancel", i, clock.now())))
        timers.append(t)
        if i % 5 == 0:
            clock.post(lambda i=i: fired.append(("post", i, clock.now())))
    for j in rng.choice(40, 10, replace=False):
        timers[int(j)].cancel()
    clock.crank_for(1.0)
    timers[3].expires_from_now(0.25)    # re-arm after cancel or fire
    timers[3].async_wait(lambda: fired.append(("rearm", 3, clock.now())))
    while clock.crank(True):
        pass
    return fired, clock.now()


@pytest.mark.parametrize("seed", [1, 2])
def test_virtual_clock_fires_timers_in_same_order(seed):
    want = _clock_script(jtimer, seed)
    got = _clock_script(ttimer, seed)
    assert got == want
    assert len([e for e in got[0] if e[0] == "fire"]) >= 25


def test_random_eviction_cache_same_seed_same_evictions():
    rng = np.random.default_rng(4)
    keys = [bytes(rng.integers(0, 256, 8, dtype=np.uint8))
            for _ in range(300)]
    ops = rng.integers(0, 3, 2000)
    caches = [jcache.RandomEvictionCache(37, seed=5),
              tcache.RandomEvictionCache(37, seed=5)]
    trails = [[], []]
    for op, k in zip(ops, rng.integers(0, 300, 2000)):
        for c, trail in zip(caches, trails):
            if op == 0:
                trail.append(c.maybe_get(keys[k]))
            elif op == 1:
                c.put(keys[k], int(k))
            else:
                trail.append(c.exists(keys[k]))
    assert trails[0] == trails[1]
    j, t = caches
    assert t._slots == j._slots and t._map == j._map
    assert (t.hits, t.misses, t.inserts) == (j.hits, j.misses, j.inserts)


def test_verify_cache_key_and_counts_equal_reference():
    rng = np.random.default_rng(8)
    for n in (0, 1, 32, 200):
        p, s = rng.bytes(32), rng.bytes(64)
        m = rng.bytes(n)
        assert tkeys.verify_cache_key(p, s, m) == \
            jkeys.verify_cache_key(p, s, m)
    assert tkeys.VERIFY_CACHE_SIZE == jkeys.VERIFY_CACHE_SIZE
    sk = tkeys.SecretKey.pseudo_random_for_testing(77)
    m = b"cache-counts"
    tkeys.clear_verify_cache()
    tkeys.flush_verify_cache_counts()
    assert tkeys.probe_verify_cache(sk.public_key().raw, sk.sign(m), m) \
        is None
    tkeys.seed_verify_cache(sk.public_key().raw, sk.sign(m), m, True)
    assert tkeys.PubKeyUtils.verify_sig(sk.public_key(), sk.sign(m), m)
    assert tkeys.flush_verify_cache_counts() == (1, 1)
    assert tkeys.PubKeyUtils.verify_sig(b"\0" * 31, sk.sign(m), m) is False


def _metrics_script(mod, seed):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    c = reg.counter("crypto", "verify_backend", "dispatch")
    h = reg.histogram("crypto", "verify_service", "occupancy")
    nh = reg.new_histogram("crypto.verify.dispatch.batch")
    for v in rng.integers(1, 257, 3000):
        c.inc()
        h.update(int(v))
        nh.update(int(v) // 2)
    c.set_count(c.count - 5)
    out = {name: doc for name, doc in reg.to_json().items()}
    t = reg.timer("crypto", "verify_service", "queue-wait")
    for v in rng.random(500):
        t.update(float(v) / 100)
    tj = t.to_json()
    # a timer's rates read the wall clock; its distribution does not
    out["timer"] = {k: tj[k] for k in ("count", "min", "max", "mean",
                                        "median", "75%", "99%")}
    assert reg.counter("crypto", "verify_backend", "dispatch") is c
    return out


def test_metrics_registry_same_updates_same_json():
    assert _metrics_script(tmetrics, 12) == _metrics_script(jmetrics, 12)


@pytest.mark.parametrize("mods", [(jperf, jtracing), (tperf, ttracing)],
                         ids=["reference", "port"])
def test_perf_zones_and_flight_recorder(mods):
    """Zones aggregate count/total/max always and emit B/E spans only
    while a recorder records; ENABLED is refcounted. Both packages give
    the same report keys and the same event sequence."""
    perf, tracing = mods
    assert tracing.ENABLED is False
    reg = perf.ZoneRegistry()
    rec = tracing.FlightRecorder(capacity=64, label="node-a")
    reg.tracer = rec
    with reg.zone("crypto.batchVerify"):
        pass
    assert len(rec) == 0
    rec.start()
    other = tracing.FlightRecorder()
    other.start()
    try:
        assert tracing.ENABLED
        with reg.zone("crypto.batchVerify", targs={"batch": 16}):
            with reg.zone("crypto.batchVerify.native"):
                rec.instant("backend.breaker", {"from": "CLOSED",
                                                "to": "OPEN"})
        other.stop()
        assert tracing.ENABLED           # rec still records
    finally:
        rec.stop()
    assert tracing.ENABLED is False
    rep = reg.report()
    assert {k: v["count"] for k, v in rep.items()} == \
        {"crypto.batchVerify": 2, "crypto.batchVerify.native": 1}
    doc = rec.to_chrome_trace()
    seq = [(e["ph"], e["name"], e.get("args")) for e in doc["traceEvents"]
           if e["ph"] != "M"]
    assert seq == [
        ("B", "crypto.batchVerify", {"batch": 16}),
        ("B", "crypto.batchVerify.native", {}),
        ("i", "backend.breaker", {"from": "CLOSED", "to": "OPEN"}),
        ("E", "crypto.batchVerify.native", None),
        ("E", "crypto.batchVerify", None)]
    assert doc["otherData"]["label"] == "node-a"
