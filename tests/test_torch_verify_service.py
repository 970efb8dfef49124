"""The port's VerifyService against the JAX package's: the same scripts
run through both, and must give the same verdicts, flushes by reason,
occupancy, fallbacks, cache counts and future states. The scripts cover
flushes on batch_full, deadline (on a virtual clock) and demand, the
double buffer, the cache probe and write-through, the fallback at
ops.verify_service.flush and at ops.verifier.batch, malformed inputs,
and abandon with flushes pending and in flight.

The verifier under each service is a duck-typed fake that records its
dispatches, except at the ops.verifier.batch seam, where it is each
package's own batch verifier with a bypass cutoff above the batch size
(the seam fires before the bypass; nothing compiles).
"""

import types

import pytest

import stellar_core_tpu.crypto.keys as jkeys
import stellar_core_tpu.ops.verify_service as jvs
import stellar_core_tpu.util.chaos as jchaos
import stellar_core_tpu.util.metrics as jmetrics
import stellar_core_tpu.util.timer as jtimer
import stellar_core_tpu_torch.crypto.keys as tkeys
import stellar_core_tpu_torch.ops.verify_service as tvs
import stellar_core_tpu_torch.util.chaos as tchaos
import stellar_core_tpu_torch.util.metrics as tmetrics
import stellar_core_tpu_torch.util.timer as ttimer
from stellar_core_tpu_torch.crypto import ed25519_ref as tref


def _ref_verifier(**kw):
    from stellar_core_tpu.ops.verifier import TpuBatchVerifier
    return TpuBatchVerifier(**kw)


def _port_verifier(**kw):
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    return CudaBatchVerifier(device="cpu", **kw)


REF = types.SimpleNamespace(vs=jvs, chaos=jchaos, metrics=jmetrics,
                            timer=jtimer, keys=jkeys, batch=_ref_verifier)
PORT = types.SimpleNamespace(vs=tvs, chaos=tchaos, metrics=tmetrics,
                             timer=ttimer, keys=tkeys, batch=_port_verifier)


def _items(n, tag, bad=()):
    out = []
    for i in range(n):
        sk = tkeys.SecretKey.pseudo_random_for_testing(7100 + i % 5)
        m = (tag + b"-%d" % i).ljust(32, b".")
        s = sk.sign(m)
        if i in bad:
            s = s[:33] + bytes([s[33] ^ 0x01]) + s[34:]
        out.append((sk.public_key().raw, s, m))
    return out


class _Fake:
    """Records each dispatch's size; verdicts from the package's host
    verifier, handed back at collect."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.batches = []
        self.collected = 0

    def verify_tuples_async(self, items):
        self.batches.append(len(items))
        items = list(items)

        def collect():
            self.collected += 1
            return [self.pkg.keys.verify_sig_uncached(p, s, m)
                    for p, s, m in items]
        return collect


def _service(pkg, verifier=None, clock=None, **kw):
    pkg.keys.clear_verify_cache()
    pkg.keys.flush_verify_cache_counts()
    reg = pkg.metrics.MetricsRegistry()
    verifier = verifier or _Fake(pkg)
    return verifier, pkg.vs.VerifyService(verifier, clock=clock,
                                          metrics=reg, **kw)


def _stats(svc):
    """stats() without the queue-wait times (wall clock)."""
    st = svc.stats()
    del st["queue_wait_p50_ms"], st["queue_wait_p99_ms"]
    return st


def _script_triggers(pkg):
    """batch_full, demand and the double buffer: a burst of 10 over
    max_batch 4 has two flushes in flight before anyone awaits."""
    items = _items(10, b"trig", bad=(3, 8))
    fake, svc = _service(pkg, max_batch=4)
    futs = svc.submit_many(items)
    log = [_stats(svc), list(fake.batches), fake.collected,
           svc.queue_depth(), [f.done() for f in futs]]
    log.append(futs[9].result())                  # demand: last chunk
    log += [_stats(svc), fake.collected, [f.done() for f in futs]]
    log.append([f.result() for f in futs])
    log += [_stats(svc), list(fake.batches), svc.queue_depth()]
    return log


def _script_deadline(pkg):
    """Un-awaited submits resolve when the deadline timer fires on the
    virtual clock, and write through both caches."""
    clock = pkg.timer.VirtualClock(pkg.timer.ClockMode.VIRTUAL_TIME)
    items = _items(3, b"dl", bad=(1,))
    fake, svc = _service(pkg, clock=clock, max_batch=8, deadline_ms=2.0)
    futs = svc.submit_many(items)
    log = [[f.done() for f in futs], clock.next_event_time()]
    clock.crank(True)
    log += [clock.now(), [f.done() for f in futs],
            [f.result() for f in futs], _stats(svc), fake.collected]
    pkg.keys.flush_verify_cache_counts()
    log.append([pkg.keys.PubKeyUtils.verify_sig(*t) for t in items])
    log.append(pkg.keys.flush_verify_cache_counts())   # all hits
    svc.set_knobs(max_batch=2, deadline_ms=0.5)
    log.append(svc.knobs())
    return log


def _script_cache_and_malformed(pkg):
    items = _items(2, b"wc")
    fake, svc = _service(pkg, max_batch=8)
    log = [svc.verify(*items[0])]
    fut = svc.submit(*items[0])                   # local cache hit
    log += [fut.done(), fut.result(), _stats(svc), list(fake.batches)]
    pkg.keys.flush_verify_cache_counts()
    log.append(pkg.keys.PubKeyUtils.verify_sig(*items[0]))
    log.append(pkg.keys.flush_verify_cache_counts())
    miss = svc.submit(*items[1], use_cache=False)
    log.append(miss.result())
    for pub, sig in ((b"\0" * 31, b"\0" * 64), (b"\0" * 32, b"\0" * 63),
                     (b"", b"")):
        f = svc.submit(pub, sig, b"m")
        log += [f.done(), f.result()]
    log += [_stats(svc), list(fake.batches)]
    return log


def _script_fallback_service_seam(pkg):
    items = _items(6, b"fb", bad=(0, 4))
    fake, svc = _service(pkg, max_batch=4)
    pkg.chaos.install(pkg.chaos.ChaosEngine(11, [pkg.chaos.FaultSpec(
        "ops.verify_service.flush", "io_error", start=1, count=1)]))
    try:
        log = [[f.result() for f in svc.submit_many(items)], _stats(svc),
               list(fake.batches), pkg.chaos.engine().log]
    finally:
        pkg.chaos.uninstall()
    return log


def _script_fallback_verifier_seam(pkg):
    items = _items(5, b"vb", bad=(2,))
    verifier = pkg.batch(device_min_batch=64)
    _, svc = _service(pkg, verifier=verifier, max_batch=8)
    pkg.chaos.install(pkg.chaos.ChaosEngine(12, [pkg.chaos.FaultSpec(
        "ops.verifier.batch", "io_error", start=0, count=1)]))
    try:
        log = [[f.result() for f in svc.submit_many(items)], _stats(svc),
               pkg.chaos.engine().log]
        # the next flush passes the seam and takes the native bypass
        log.append([f.result() for f in svc.submit_many(
            _items(3, b"vb2", bad=(0,)))])
        log += [_stats(svc), pkg.chaos.engine().point_hits]
    finally:
        pkg.chaos.uninstall()
    return log


def _script_abandon(pkg):
    """abandon() resolves pending and in-flight futures to False, seeds
    no cache, cancels the deadline timer; later submits resolve False."""
    clock = pkg.timer.VirtualClock(pkg.timer.ClockMode.VIRTUAL_TIME)
    items = _items(6, b"ab")
    fake, svc = _service(pkg, clock=clock, max_batch=4, deadline_ms=1.0)
    futs = svc.submit_many(items)                 # 4 in flight, 2 pending
    log = [_stats(svc), svc.queue_depth()]
    svc.abandon()
    clock.crank(True)
    log += [[f.done() for f in futs], [f.result() for f in futs],
            _stats(svc), fake.collected, svc.queue_depth(),
            clock.next_event_time()]
    late = svc.submit(*items[0])
    log += [late.done(), late.result()]
    pkg.keys.flush_verify_cache_counts()
    log.append(pkg.keys.PubKeyUtils.verify_sig(*items[0]))
    log.append(pkg.keys.flush_verify_cache_counts())   # a miss
    return log


SCRIPTS = [_script_triggers, _script_deadline, _script_cache_and_malformed,
           _script_fallback_service_seam, _script_fallback_verifier_seam,
           _script_abandon]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__[8:])
def test_port_service_matches_reference(script):
    want = script(REF)
    got = script(PORT)
    assert got == want


def test_scripts_cover_each_trigger_and_fallback():
    """What the paired scripts hold equal, spelled out on the port."""
    trig = _script_triggers(PORT)
    assert trig[1] == [4, 4] and trig[2] == 0
    assert trig[3] == {"pending": 2, "inflight": 8}
    assert trig[-3]["flush_reasons"] == {"batch_full": 2, "deadline": 0,
                                         "demand": 1, "drain": 0}
    want = [tref.verify(*t) for t in _items(10, b"trig", bad=(3, 8))]
    assert trig[9] == want and want.count(False) == 2
    dl = _script_deadline(PORT)
    assert dl[0] == [False] * 3 and dl[1] == pytest.approx(0.002)
    assert dl[3] == [True] * 3 and dl[4] == [True, False, True]
    assert dl[5]["flush_reasons"]["deadline"] == 1
    assert dl[8] == (3, 0)
    fb = _script_fallback_service_seam(PORT)
    assert fb[1]["fallbacks"] == 1 and fb[2] == [4]
    vb = _script_fallback_verifier_seam(PORT)
    assert vb[1]["fallbacks"] == 1 and vb[4]["fallbacks"] == 1
    assert vb[5] == {"ops.verify_service.flush": 2, "ops.verifier.batch": 2}
    ab = _script_abandon(PORT)
    assert ab[3] == [False] * 6 and ab[5] == 0
    assert ab[-1] == (0, 1)


def test_service_over_supervisor_over_cuda_verifier_on_cpu():
    """The port's whole live stack on the CPU at n <= 16: verdicts equal
    the oracle, no fallback, no supervisor failure, the breaker CLOSED."""
    from stellar_core_tpu_torch.ops.backend_supervisor import \
        BackendSupervisor
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    items = _items(12, b"live", bad=(1, 6, 11))
    reg = tmetrics.MetricsRegistry()
    sup = BackendSupervisor(CudaBatchVerifier(device="cpu", metrics=reg),
                            metrics=reg)
    try:
        svc = tvs.VerifyService(sup, metrics=reg, max_batch=12)
        tkeys.clear_verify_cache()
        got = [f.result() for f in svc.submit_many(items)]
        assert got == [tref.verify(*t) for t in items]
        st = sup.status()
        assert st["state"] == "CLOSED" and st["dispatches"] == 1
        assert st["failures"] == {"transient": 0, "fatal": 0, "timeout": 0}
        assert svc.stats()["fallbacks"] == 0
        assert reg.to_json()["crypto.verify.dispatch.batch"]["count"] == 1
    finally:
        sup.shutdown()
