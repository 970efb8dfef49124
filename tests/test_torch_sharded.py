"""The port's ShardedBatchVerifier on a stand-in mesh of four CPU positions
(a list naming the CPU four times, as the JAX tests stand in for chips with
virtual CPU devices), against the oracle and against the JAX package's
ShardedBatchVerifier on the same tuples and active sets.

The reference runs over four of the conftest's virtual CPU devices with
its compiled program replaced, on that instance only, by a numpy stand-in
that runs the oracle on each laid-out row (pad rows decode as a
small-order A, so the oracle rejects them). Its own layout, unshard and
per-device metrics run; nothing is lowered or compiled by XLA. Each
dispatch of the port runs the plain versions once per non-empty shard
(about 3 s each here), so the sequence below is the few dispatches that
prove the layout, run once for the module.
"""

import hashlib

import jax
import numpy as np
import pytest
import torch

import stellar_core_tpu.ops.verifier as jver
import stellar_core_tpu.util.metrics as jmetrics
import stellar_core_tpu_torch.util.metrics as tmetrics
from stellar_core_tpu_torch.crypto import ed25519_ref as tref
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.ops import ed25519_kernel as EK
from stellar_core_tpu_torch.ops import verifier as V

NDEV = 4


def _mk(n, seed, long_at=(), bad_sig_at=(), tamper_at=()):
    """n signed tuples of 32-byte messages; a long message at `long_at`,
    a garbage signature at `bad_sig_at`, a message changed after signing
    (still 32 bytes) at `tamper_at`."""
    items = []
    for i in range(n):
        sk = SecretKey.pseudo_random_for_testing(seed * 1000 + i)
        msg = hashlib.sha256(b"shard%d-%d" % (seed, i)).digest()
        if i in long_at:
            msg = msg * 5
        sig = sk.sign(msg)
        if i in bad_sig_at:
            sig = bytes([1 + i]) * 64
        if i in tamper_at:
            msg = bytes([msg[0] ^ 0x40]) + msg[1:]
        items.append((sk.public_key().raw, sig, msg))
    return items


def _oracle(items):
    return [tref.verify(p, s, m) for p, s, m in items]


def _verify_with_k(a, r, s, k):
    """The oracle's strict checks and equation with k given."""
    S = int.from_bytes(s, "little")
    A = tref.pt_decompress(a, strict=True)
    R = tref.pt_decompress(r, strict=True)
    if S >= tref.L or A is None or R is None or \
            tref.pt_is_small_order(A) or tref.pt_is_small_order(R):
        return False
    k = int.from_bytes(k, "little")
    return tref.pt_equal(tref.pt_mul(S, tref.BASE),
                         tref.pt_add(R, tref.pt_mul(k, A)))


# (active set, batch, pinned probe position or None): the active sets
# 4 -> (0, 2, 3) -> (1,) -> 4, batches of 13, 7 and 1 in both modes, and
# a probe pinned to a position outside the active set
STEPS = [
    (tuple(range(NDEV)),
     _mk(13, 1, long_at=(5,), bad_sig_at=(2,), tamper_at=(9,)), None),
    ((0, 2, 3), _mk(7, 2, bad_sig_at=(4,)), None),
    ((1,), _mk(1, 3), None),
    ((1,), _mk(2, 4, tamper_at=(0,)), 3),
    (tuple(range(NDEV)), _mk(13, 5, bad_sig_at=(0,), tamper_at=(12,)), None),
]


def _run(verifier, spy_rows):
    """Drive one package's verifier through STEPS: verdicts, the active
    set after each step and the rows each position verified, in order."""
    log = []
    for active, items, probe in STEPS:
        verifier.set_active_devices(active)
        spy_rows.clear()
        if probe is None:
            got = verifier.verify_tuples(items)
            positions = active
        else:
            got = verifier.verify_tuples_async_on(probe, items)()
            positions = (probe,)
        by_r = {s[:32]: i for i, (_, s, _) in enumerate(items)}
        assert len(spy_rows) == len(positions)
        rows = {p: [by_r[r] for r in shard if r in by_r]
                for p, shard in zip(positions, spy_rows)}
        log.append(([bool(x) for x in got], verifier.active_indices(),
                    rows))
    return log


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("ED25519_DEVICE_SHA", raising=False)
        mp.delenv("VERIFY_DEVICE_MIN_BATCH", raising=False)
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            # the port: the real plain versions; a spy on the two
            # entries records which rows each shard received
            port_rows = []
            for name in ("verify_kernel_msg32", "verify_kernel_full"):
                real = getattr(EK, name)

                def spy(a, r, s, mk, _real=real):
                    port_rows.append([bytes(x) for x in r.numpy()])
                    return _real(a, r, s, mk)
                mp.setattr(EK, name, spy)
            treg = tmetrics.MetricsRegistry()
            port = V.ShardedBatchVerifier(["cpu"] * NDEV, metrics=treg,
                                          device_min_batch=1)
            port_log = _run(port, port_rows)
            # the reference: its layout and metrics, the oracle per row
            ref_rows = []
            jreg = jmetrics.MetricsRegistry()
            ref = jver.ShardedBatchVerifier(devices=jax.devices()[:NDEV],
                                            metrics=jreg,
                                            device_min_batch=1)

            def program(active, msg32):
                def fn(a, r, s, last):
                    rows = a.shape[0] // len(active)
                    for j in range(len(active)):
                        ref_rows.append(
                            [bytes(x) for x in r[j * rows:(j + 1) * rows]])
                    if msg32:
                        out = [tref.verify(bytes(a[i]), bytes(r[i])
                                           + bytes(s[i]), bytes(last[i]))
                               for i in range(a.shape[0])]
                    else:
                        out = [_verify_with_k(bytes(a[i]), bytes(r[i]),
                                              bytes(s[i]), bytes(last[i]))
                               for i in range(a.shape[0])]
                    return np.array(out, dtype=bool)
                return fn, None
            ref._program = program
            ref_log = _run(ref, ref_rows)
        finally:
            torch.set_num_threads(prev)
    return port, port_log, treg.to_json(), ref_log, jreg.to_json()


def test_verdicts_equal_oracle_across_active_sets(runs):
    port, port_log, _, _, _ = runs
    for (active, items, probe), (got, after, _) in zip(STEPS, port_log):
        assert got == _oracle(items)
        assert after == active              # a probe leaves the set alone
    assert [sum(g) for g, _, _ in port_log] == [11, 6, 1, 1, 11]
    assert port.active_indices() == tuple(range(NDEV))


def test_same_rows_to_same_positions_as_reference(runs):
    """Row for row, the port's shards are the reference's: both split
    with shard_shares over the active positions in order."""
    _, port_log, _, ref_log, _ = runs
    assert port_log == ref_log
    assert port_log[0][2] == {0: [0, 1, 2, 3], 1: [4, 5, 6],
                              2: [7, 8, 9], 3: [10, 11, 12]}
    assert port_log[1][2] == {0: [0, 1, 2], 2: [3, 4], 3: [5, 6]}
    assert port_log[3][2] == {3: [0, 1]}


def test_per_device_metrics_match_reference(runs):
    _, _, port_m, _, ref_m = runs
    names = ["crypto.verify.dispatch.batch"] + [
        "crypto.verify.dispatch.device%d.batch" % i for i in range(NDEV)]
    for name in names:
        assert (port_m[name]["count"], port_m[name]["sum"]) == \
            (ref_m[name]["count"], ref_m[name]["sum"]), name
    # per position: (dispatches, rows) over the five steps
    assert [(port_m[n]["count"], port_m[n]["sum"]) for n in names[1:]] == \
        [(3, 11), (3, 7), (3, 8), (4, 10)]
    assert port_m["crypto.verify.dispatch.batch"]["sum"] == 36
    # the port pads nothing; the reference pads to its buckets
    for name in ["crypto.verify.dispatch.padding"] + [
            "crypto.verify.dispatch.device%d.padding" % i
            for i in range(NDEV)]:
        assert port_m[name]["count"] == ref_m[name]["count"]
        assert port_m[name]["sum"] == 0
    assert ref_m["crypto.verify.dispatch.padding"]["sum"] > 0
    for i in range(NDEV):
        wall = port_m["crypto.verify.dispatch.device%d.wall" % i]
        assert wall["count"] == port_m[names[1 + i]]["count"]


def test_active_set_validation_and_empty_batches():
    v = V.ShardedBatchVerifier(["cpu"] * NDEV, device_min_batch=1)
    assert v.ndev == NDEV and v.active_indices() == (0, 1, 2, 3)
    with pytest.raises(ValueError):
        v.set_active_devices([])
    with pytest.raises(IndexError):
        v.set_active_devices([0, 99])
    with pytest.raises(IndexError):
        v.set_active_devices([-1])
    v.set_active_devices([3, 1, 1])                 # dedup and sort
    assert v.active_indices() == (1, 3)
    items = _mk(2, 6)
    for i in (NDEV, -1):
        with pytest.raises(IndexError):
            v.verify_tuples_async_on(i, items)
    assert v.verify_tuples([]) == []
    assert v.verify_tuples_async_on(0, [])() == []
    assert v.verify_batch(np.zeros((0, 32), np.uint8),
                          np.zeros((0, 64), np.uint8), []).shape == (0,)


def test_pinned_probe_takes_the_bypass_and_the_chaos_seam(monkeypatch):
    """verify_tuples_async_on keeps the reference's contract: the chaos
    seam fires before the bypass, and below the cutoff the host verifier
    answers with no dispatch."""
    from stellar_core_tpu_torch.util import chaos

    def boom(*a):
        raise AssertionError("device path taken below the cutoff")
    monkeypatch.setattr(EK, "verify_kernel_msg32", boom)
    reg = tmetrics.MetricsRegistry()
    v = V.ShardedBatchVerifier(["cpu"] * NDEV, device_min_batch=3,
                               metrics=reg)
    items = _mk(2, 7, tamper_at=(1,))
    assert v.verify_tuples_async_on(2, items)() == [True, False]
    assert reg.to_json()["crypto.verify.dispatch.device2.batch"]["count"] \
        == 0
    chaos.install(chaos.ChaosEngine(1, [chaos.FaultSpec(
        "ops.verifier.batch", "io_error", start=0, count=1)]))
    try:
        with pytest.raises(OSError):
            v.verify_tuples_async_on(2, items)
    finally:
        chaos.uninstall()


def test_default_devices_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        V.ShardedBatchVerifier()
    with pytest.raises(ValueError):
        V.ShardedBatchVerifier([])
