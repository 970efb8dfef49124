"""Batch Ed25519 verifier on one CUDA card: `CudaBatchVerifier`.

Counterpart of the single-device part of stellar_core_tpu/ops/verifier.py
(`TpuBatchVerifier`), with the same API: verify_batch(_async),
verify_tuples(_async), verify_tuples_async_on(0, ...),
set_device_min_batch, the ED25519_DEVICE_SHA and VERIFY_DEVICE_MIN_BATCH
overrides, and the duck-typed crypto.verify.dispatch.{batch,padding,wall}
metrics. Results are one bool per signature, equal to the strict oracle
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
device="cpu" runs the plain versions (the tests do).
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from . import ed25519_kernel
from ..crypto import ed25519_ref as _ref
from ..crypto.keys import verify_sig_uncached

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


def resolve_device(device=None) -> torch.device:
    """None -> the current CUDA card, raising when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the plain versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def host_k(pubs: np.ndarray, sigs: np.ndarray,
           msgs: Sequence[bytes]) -> np.ndarray:
    """k = SHA512(R‖A‖M) mod L on the host, (n,32) uint8."""
    k = np.empty((len(msgs), 32), dtype=np.uint8)
    for i, m in enumerate(msgs):
        h = hashlib.sha512(sigs[i, :32].tobytes() + pubs[i].tobytes() + m)
        kv = int.from_bytes(h.digest(), "little") % _ref.L
        k[i] = np.frombuffer(kv.to_bytes(32, "little"), dtype=np.uint8)
    return k


class CudaBatchVerifier:
    """Batch verifier on one CUDA card (or the CPU, for tests)."""

    def __init__(self, device=None, device_sha=None, device_min_batch=None,
                 metrics=None):
        self.device = resolve_device(device)
        self._device_sha = _device_sha_default(device_sha)
        self._device_min_batch = _device_min_batch_default(device_min_batch)
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
        n = len(msgs)
        if n == 0:
            return lambda: np.zeros(0, dtype=bool)
        pubs = np.asarray(pubs, dtype=np.uint8).reshape(n, 32)
        sigs = np.asarray(sigs, dtype=np.uint8).reshape(n, 64)
        host = np.empty((4, n, 32), dtype=np.uint8)
        host[0] = pubs
        host[1] = sigs[:, :32]
        host[2] = sigs[:, 32:]
        if self._device_sha and all(len(m) == 32 for m in msgs):
            host[3] = np.frombuffer(b"".join(msgs),
                                    dtype=np.uint8).reshape(n, 32)
            entry = ed25519_kernel.verify_kernel_msg32
        else:
            host[3] = host_k(pubs, sigs, msgs)
            entry = ed25519_kernel.verify_kernel_full
        t0 = time.perf_counter()
        t = torch.from_numpy(host)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
            out = entry(t[0], t[1], t[2], t[3])
            res = torch.empty(n, dtype=torch.bool, pin_memory=True)
            res.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            wait = done.synchronize
        else:
            res = entry(t[0], t[1], t[2], t[3])
            wait = None
        if self._m_batch is not None:
            self._m_batch.update(n)
            self._m_padding.update(0)
        state = {"done": False}

        def collect():
            if wait is not None:
                wait()
            if not state["done"]:
                state["done"] = True
                if self._m_wall is not None:
                    self._m_wall.update(time.perf_counter() - t0)
            return res.numpy().copy()
        return collect

    def verify_tuples(
            self, items: Sequence[Tuple[bytes, bytes, bytes]]) -> List[bool]:
        return self.verify_tuples_async(items)()

    def verify_tuples_async(
            self, items: Sequence[Tuple[bytes, bytes, bytes]]):
        """Non-blocking verify_tuples; below the bypass cutoff the oracle
        verifies on the host (same strict accept/reject)."""
        if not items:
            return lambda: []
        if len(items) < self._device_min_batch:
            res = [verify_sig_uncached(p, s, m) for p, s, m in items]
            return lambda: res
        pubs = np.frombuffer(b"".join(p for p, _, _ in items),
                             dtype=np.uint8).reshape(-1, 32)
        sigs = np.frombuffer(b"".join(s for _, s, _ in items),
                             dtype=np.uint8).reshape(-1, 64)
        handle = self.verify_batch_async(pubs, sigs, [m for _, _, m in items])
        return lambda: handle().tolist()

    def verify_tuples_async_on(self, device_index: int, items):
        """Pinned single-device dispatch; this verifier has device 0 only."""
        if int(device_index) != 0:
            raise IndexError(
                f"single-device verifier has no device {device_index}")
        return self.verify_tuples_async(items)
