"""Batch Ed25519 verifiers on CUDA cards: `CudaBatchVerifier` (one card)
and `ShardedBatchVerifier` (a batch split over several).

`CudaBatchVerifier` is the counterpart of `TpuBatchVerifier` in
stellar_core_tpu/ops/verifier.py, with the same API: verify_batch(_async),
verify_tuples(_async), verify_tuples_async_on(0, ...),
set_device_min_batch, the ED25519_DEVICE_SHA and VERIFY_DEVICE_MIN_BATCH
overrides, the duck-typed crypto.verify.dispatch.{batch,padding,wall}
metrics, the `ops.verifier.batch` chaos seam (fired before the
small-batch bypass) and the `crypto.batchVerify` perf zone around
dispatch and again around collect (`crypto.batchVerify.native` around
the bypass, which runs the host C++ verifier of native/). Results are
one bool per signature, equal to the strict oracle
crypto/ed25519_ref.verify.

Per batch: when device SHA is on and every message is 32 bytes, the card
computes k (prep in msg32 mode); otherwise the host computes
k = SHA512(R‖A‖M) mod L with hashlib and prep runs in k mode. A, R, S and
M-or-k travel as one pinned (4,n,32) uint8 copy; prep -> ladder -> finish
run on the current stream, and the (n,) verdicts come back through a
pinned buffer and an event, so dispatch does not wait for the card.
Lanes launch exactly n wide: CUDA needs no power-of-two shapes, so the
padding metric records 0.

The default device is the current CUDA card; with no card it raises.
device="cpu" runs the plain versions (the tests do). A verifier on a
card builds and loads the kernels when it is constructed, so a failed
build raises to the caller and never reaches a dispatch, where a
supervisor would rate it fatal and serve every flush from the host.

`ShardedBatchVerifier` is the counterpart of the reference's class of
the same name: a batch shards over the ACTIVE positions of a device
list, and `set_active_devices` shrinks and regrows that set (the
per-device breakers of ops/backend_supervisor.py drive it). Shard s
verifies rows [off_s, off_s + counts[s]) with counts from
ops/shard_math.shard_shares, the split the supervisor reports to its
per-device chaos seam; every shard is a launch of the same kernels on
its position's device, its verdicts copied into its slice of one pinned
result buffer behind an event on that device's current stream. One
active position is the plain one-card path on that device. Positions
are list positions: a list that names one device k times is a k-position
mesh on one card (the CPU tests, and chip_smoke.py's stand-in), whose
shards share that card's stream and run one after another.

The reference's `make_sharded_verify`, its per-active-set LRU of
compiled programs (`_program`, `_compile`) and `_min_bucket_for` have
no counterpart: XLA needs static shapes and one compiled program per
mesh, while a CUDA launch takes any n on any card, so no row is padded
and nothing is compiled per active set. `_bucket_size` and
`prevalidate_coalesce` are the reference's all the same: catchup's
pipeline fuses checkpoints by the reference's padding arithmetic, so
that both packages dispatch the same checkpoints together.

`host_prepare` is the reference's v1 host prep (k, -A and the strict
flags on the host, for ed25519_kernel.verify_kernel).
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build, ed25519_kernel
from .shard_math import shard_shares
from ..crypto import ed25519_ref as _ref
from ..crypto.keys import _native_verify, verify_sig_uncached
from ..util import chaos, tracing
from ..util.perf import default_registry

# Same defaults and overrides as the JAX verifier: device SHA on, and a
# small-batch bypass cutoff of 1 (never bypass) unless the caller or the
# environment sets one.
DEVICE_MIN_BATCH = 1


def _device_sha_default(explicit):
    env = os.environ.get("ED25519_DEVICE_SHA")
    if env is not None:
        return env != "0"
    return True if explicit is None else explicit


def _device_min_batch_default(explicit):
    env = os.environ.get("VERIFY_DEVICE_MIN_BATCH")
    if env is not None:
        return int(env)
    return DEVICE_MIN_BATCH if explicit is None else int(explicit)


MIN_BUCKET = 8


def _bucket_size(n: int, minimum: int = MIN_BUCKET) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def prevalidate_coalesce(counts: Sequence[int], max_fuse: int,
                         minimum: int = MIN_BUCKET) -> int:
    """How many pending checkpoints' signature batches the catchup
    pipeline should fuse into ONE device dispatch (catchup/pipeline.py's
    prevalidation stage sizing its batch from the ahead-window).

    `counts[i]` is checkpoint i's signature-tuple count, in replay
    order. The reference's device batches pad to a power-of-two bucket
    (`_bucket_size`); this verifier pads nothing, but the rule keeps
    the reference's arithmetic unchanged, so both packages fuse the same
    checkpoints into the same dispatches. Fusing is accepted greedily
    while it wastes no padding slots versus separate dispatches: e.g.
    300+300 fused costs bucket(600)=1024 = 512+512 separate (equal
    slots, one launch saved - fuse), while 512+10 fused costs
    bucket(522)=1024 > 512+16 (reject). Zero-count checkpoints fuse for
    free. Deterministic and pure."""
    if not counts:
        return 0
    k = 1
    total = counts[0]
    while k < min(len(counts), max_fuse):
        nxt = counts[k]
        if nxt:
            fused = _bucket_size(total + nxt, minimum)
            separate = (_bucket_size(total, minimum) if total else 0) \
                + _bucket_size(nxt, minimum)
            if fused > separate:
                break
            total += nxt
        k += 1
    return k


def resolve_device(device=None) -> torch.device:
    """None -> the current CUDA card, raising when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def resolve_devices(devices=None) -> List[torch.device]:
    """None -> every visible card, raising when there is none."""
    if devices is None:
        if not torch.cuda.is_available() or not torch.cuda.device_count():
            raise RuntimeError("no CUDA device: pass devices=['cpu', ...] "
                               "to run the plain versions on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("empty device list")
    return devices


def host_k(pubs: np.ndarray, sigs: np.ndarray,
           msgs: Sequence[bytes]) -> np.ndarray:
    """k = SHA512(R‖A‖M) mod L on the host, (n,32) uint8."""
    k = np.empty((len(msgs), 32), dtype=np.uint8)
    for i, m in enumerate(msgs):
        h = hashlib.sha512(sigs[i, :32].tobytes() + pubs[i].tobytes() + m)
        kv = int.from_bytes(h.digest(), "little") % _ref.L
        k[i] = np.frombuffer(kv.to_bytes(32, "little"), dtype=np.uint8)
    return k


def _prep_python(pubs: np.ndarray, sigs: np.ndarray,
                 msgs: Sequence[bytes]):
    """Oracle-backed host prep (the fallback when the native library is
    absent)."""
    n = len(msgs)
    k_out = np.zeros((n, 32), dtype=np.uint8)
    neg_a = np.zeros((n, 64), dtype=np.uint8)
    ok = np.zeros(n, dtype=bool)
    for i in range(n):
        pub, sig, msg = bytes(pubs[i]), bytes(sigs[i]), msgs[i]
        s = int.from_bytes(sig[32:], "little")
        if s >= _ref.L:
            continue
        a_pt = _ref.pt_decompress(pub, strict=True)
        if a_pt is None or _ref.pt_is_small_order(a_pt):
            continue
        r_pt = _ref.pt_decompress(sig[:32], strict=True)
        if r_pt is None or _ref.pt_is_small_order(r_pt):
            continue
        k = _ref.compute_k(sig[:32], pub, msg)
        k_out[i] = np.frombuffer(k.to_bytes(32, "little"), dtype=np.uint8)
        nx = (_ref.P - a_pt[0]) % _ref.P
        neg_a[i, :32] = np.frombuffer(nx.to_bytes(32, "little"),
                                      dtype=np.uint8)
        neg_a[i, 32:] = np.frombuffer(a_pt[1].to_bytes(32, "little"),
                                      dtype=np.uint8)
        ok[i] = True
    return k_out, neg_a, ok


def host_prepare(pubs: np.ndarray, sigs: np.ndarray, msgs: Sequence[bytes]):
    """v1 host prep: (k (n,32) u8, -A as canonical x‖y (n,64) u8, ok (n,)
    bool), ok the strict checks of S, A and R. The native library when
    it loads, else the oracle."""
    lib = _native_verify()
    if lib is None:
        return _prep_python(pubs, sigs, msgs)
    offsets = np.zeros(len(msgs) + 1, dtype=np.uint64)
    np.cumsum([len(m) for m in msgs], out=offsets[1:])
    k, s_ok = lib.batch_prepare(pubs, sigs, b"".join(msgs), offsets)
    neg_a, pt_ok = lib.batch_host_precheck(pubs, sigs)
    return k, neg_a, s_ok & pt_ok


def _launch_shards(pubs, sigs, msgs: Sequence[bytes], device_sha: bool,
                   shards):
    """Verify a batch split into consecutive shards [(device, rows)]
    from row 0; a shard whose device is None is skipped (another process
    verifies it) and its rows stay False. Msg32 mode is decided once for
    the batch. Each shard's rows go in one pinned host block to its
    device, run prep -> ladder -> finish there, and come back into their
    slice of one pinned (n,) result buffer behind an event recorded on
    that device's current stream. Returns (results, events). PyTorch's
    pinned allocator holds the host block until the copies that read it
    are done."""
    n = len(msgs)
    pubs = np.asarray(pubs, dtype=np.uint8).reshape(n, 32)
    sigs = np.asarray(sigs, dtype=np.uint8).reshape(n, 64)
    if device_sha and all(len(m) == 32 for m in msgs):
        last = np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(n, 32)
        entry = ed25519_kernel.verify_kernel_msg32
    else:
        last = host_k(pubs, sigs, msgs)
        entry = ed25519_kernel.verify_kernel_full
    pin = any(d is not None and d.type == "cuda" for d, _ in shards)
    buf = torch.empty(4 * 32 * n, dtype=torch.uint8, pin_memory=pin)
    res = torch.zeros(n, dtype=torch.bool, pin_memory=pin)
    events = []
    off = 0
    for dev, c in shards:
        if dev is not None and c:
            # (4, c, 32): A, R, S, M-or-k, each a contiguous (c, 32) row
            # block 16-byte aligned, as the kernels take them
            blk = buf[128 * off:128 * (off + c)].view(4, c, 32)
            h = blk.numpy()
            h[0] = pubs[off:off + c]
            h[1] = sigs[off:off + c, :32]
            h[2] = sigs[off:off + c, 32:]
            h[3] = last[off:off + c]
            if dev.type == "cuda":
                d = blk.to(dev, non_blocking=True)
                res[off:off + c].copy_(entry(d[0], d[1], d[2], d[3]),
                                       non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                events.append(done)
            else:
                res[off:off + c] = entry(blk[0], blk[1], blk[2], blk[3])
        off += c
    return res, events


class CudaBatchVerifier:
    """Batch verifier on one CUDA card (or the CPU, for tests)."""

    def __init__(self, perf=None, device=None, device_sha=None,
                 device_min_batch=None, metrics=None):
        self._init([resolve_device(device)], perf, device_sha,
                   device_min_batch, metrics)

    def _init(self, devices, perf, device_sha, device_min_batch, metrics):
        self.devices = devices
        self.device = devices[0]
        if any(d.type == "cuda" for d in devices):
            _build.lib()
        self.perf = perf  # per-app zone registry (None = process default)
        self._device_sha = _device_sha_default(device_sha)
        self._device_min_batch = _device_min_batch_default(device_min_batch)
        self._m_dev = None
        if metrics is None:
            self._m_batch = self._m_padding = self._m_wall = None
        else:
            self._m_batch = metrics.new_histogram(
                "crypto.verify.dispatch.batch")
            self._m_padding = metrics.new_histogram(
                "crypto.verify.dispatch.padding")
            self._m_wall = metrics.new_timer("crypto.verify.dispatch.wall")

    def set_device_min_batch(self, n: int) -> None:
        """Live re-tune of the host-bypass cutoff."""
        self._device_min_batch = max(1, int(n))

    def verify_batch(self, pubs, sigs, msgs: Sequence[bytes]) -> np.ndarray:
        return self.verify_batch_async(pubs, sigs, msgs)()

    def verify_batch_async(self, pubs, sigs, msgs: Sequence[bytes]):
        """Dispatch without waiting for the card; returns a zero-argument
        callable that yields the (n,) bool results."""
        return self._dispatch(pubs, sigs, msgs, (0,))

    def _shard_device(self, position: int):
        """The device this process verifies a shard of `position` on
        (None: another process verifies it)."""
        return self.devices[position]

    def _gather(self, res, events, positions, counts, sigs):
        """Queue the exchange that fills in the rows of shards another
        process verified; returns the callable that completes it, or
        None in one process."""
        return None

    def _dispatch(self, pubs, sigs, msgs: Sequence[bytes], positions):
        n = len(msgs)
        if n == 0:
            return lambda: np.zeros(0, dtype=bool)
        counts = shard_shares(n, len(positions))
        t0 = time.perf_counter()
        res, events = _launch_shards(
            pubs, sigs, msgs, self._device_sha,
            [(self._shard_device(i), c) for i, c in zip(positions, counts)])
        if self._m_batch is not None:
            self._m_batch.update(n)
            self._m_padding.update(0)
        if self._m_dev is not None:
            for i, c in zip(positions, counts):
                self._m_dev[i]["batch"].update(c)
                self._m_dev[i]["padding"].update(0)
        gather = self._gather(res, events, positions, counts, sigs)
        state = {"done": False}

        def collect():
            for done in events:
                done.synchronize()
            if not state["done"]:
                if gather is not None:
                    gather()
                state["done"] = True
                dt = time.perf_counter() - t0
                if self._m_wall is not None:
                    self._m_wall.update(dt)
                if self._m_dev is not None:
                    # one wall for every shard, as the reference records
                    for i in positions:
                        self._m_dev[i]["wall"].update(dt)
            return res.numpy().copy()
        return collect

    def verify_tuples(
            self, items: Sequence[Tuple[bytes, bytes, bytes]]) -> List[bool]:
        return self.verify_tuples_async(items)()

    def verify_tuples_async(
            self, items: Sequence[Tuple[bytes, bytes, bytes]]):
        """Non-blocking verify_tuples: dispatches and returns a zero-arg
        callable yielding the List[bool]. Below the bypass cutoff the host
        verifier (native, else the oracle) runs instead: same strict
        accept/reject."""
        if not items:
            return lambda: []
        if chaos.ENABLED:
            # device-verifier fault seam: an injected io_error raises
            # before any dispatch, and callers fall back to the native
            # per-signature path. Fired before the bypass decision so
            # the seam does not depend on the batch size.
            chaos.point("ops.verifier.batch", n=len(items))
        registry = self.perf or default_registry
        targs = {"batch": len(items)} if tracing.ENABLED else None
        if len(items) < self._device_min_batch:
            with registry.zone("crypto.batchVerify.native", targs=targs):
                res = [verify_sig_uncached(p, s, m) for p, s, m in items]
            return lambda: res
        with registry.zone("crypto.batchVerify", targs=targs):
            pubs, sigs = _tuple_rows(items)
            handle = self.verify_batch_async(pubs, sigs,
                                             [m for _, _, m in items])

        def collect():
            with registry.zone("crypto.batchVerify", targs=targs):
                return handle().tolist()
        return collect

    def verify_tuples_async_on(self, device_index: int, items):
        """Pinned single-device dispatch; this verifier has device 0 only."""
        if int(device_index) != 0:
            raise IndexError(
                f"single-device verifier has no device {device_index}")
        return self.verify_tuples_async(items)


def _tuple_rows(items):
    pubs = np.frombuffer(b"".join(p for p, _, _ in items),
                         dtype=np.uint8).reshape(-1, 32)
    sigs = np.frombuffer(b"".join(s for _, s, _ in items),
                         dtype=np.uint8).reshape(-1, 64)
    return pubs, sigs


class ShardedBatchVerifier(CudaBatchVerifier):
    """Data-parallel verifier over the ACTIVE positions of a device list
    (see the module docstring). devices=None is every visible card; the
    kernels are built when a card is among the devices."""

    def __init__(self, devices: Optional[list] = None, perf=None,
                 device_sha=None, device_min_batch=None, metrics=None):
        self._init(resolve_devices(devices), perf, device_sha,
                   device_min_batch, metrics)
        self.ndev = len(self.devices)
        self._active: Tuple[int, ...] = tuple(range(self.ndev))
        if metrics is not None:
            # per-position accounting, under the reference's names: the
            # per-device breakers judge a sick card against its siblings
            self._m_dev = [
                {"batch": metrics.new_histogram(
                    "crypto.verify.dispatch.device%d.batch" % i),
                 "padding": metrics.new_histogram(
                     "crypto.verify.dispatch.device%d.padding" % i),
                 "wall": metrics.new_timer(
                     "crypto.verify.dispatch.device%d.wall" % i)}
                for i in range(self.ndev)]

    def set_active_devices(self, indices) -> None:
        """Live mesh shrink/regrow: from the next dispatch on, a batch
        shards over exactly `indices` (positions in ``self.devices``); a
        position left out receives no dispatch. A plain tuple swap: a
        concurrent dispatch sees the old or the new set, never a torn
        one."""
        idx = tuple(sorted({int(i) for i in indices}))
        if not idx:
            raise ValueError("active device set must not be empty "
                             "(mesh-empty falls back to native in the "
                             "backend supervisor)")
        if idx[0] < 0 or idx[-1] >= self.ndev:
            raise IndexError(f"device index out of range: {idx}")
        self._active = idx

    def active_indices(self) -> Tuple[int, ...]:
        return self._active

    def verify_batch_async(self, pubs, sigs, msgs: Sequence[bytes]):
        """Shard the batch over the active positions."""
        return self._dispatch(pubs, sigs, msgs, self._active)

    def verify_tuples_async_on(self, device_index: int, items):
        """Dispatch one batch to a SINGLE position whatever the active
        set: the per-device canary probe, which must not ride (or
        disturb) the survivors. Same chaos seam, bypass and accept/reject
        as verify_tuples_async."""
        device_index = int(device_index)
        if not 0 <= device_index < self.ndev:
            raise IndexError(f"no device {device_index} in this mesh")
        n = len(items)
        if n == 0:
            return lambda: []
        if chaos.ENABLED:
            chaos.point("ops.verifier.batch", n=n)
        if n < self._device_min_batch:
            res = [verify_sig_uncached(p, s, m) for p, s, m in items]
            return lambda: res
        pubs, sigs = _tuple_rows(items)
        handle = self._dispatch(pubs, sigs, [m for _, _, m in items],
                                (device_index,))
        return lambda: handle().tolist()
