"""The verify seam every device caller shares, built as the node builds it.

`main/application.py` of the port, for SIGNATURE_VERIFY_BACKEND "cuda"
and the one-card mesh: the process's GC policy (`gcpolicy.install`),
then `BackendSupervisor(CudaBatchVerifier(...))` with the node's default
settings from `Config`, one metrics registry and one zone registry. A
dispatch is `verify_tuples_async(items)`, the call catchup's
prevalidation and txset validation make; its collect returns the
verdicts.

`health()` reads the supervisor's failure and skip counters: every
dispatch that fails, times out or is skipped is served by the host's
verifier instead of the card.
"""

from __future__ import annotations


class Seam:
    def __init__(self, device):
        from stellar_core_tpu_torch.main.config import Config
        from stellar_core_tpu_torch.ops.backend_supervisor import (
            FAILURE_CLASSES, BackendSupervisor)
        from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
        from stellar_core_tpu_torch.util import gcpolicy
        from stellar_core_tpu_torch.util.metrics import MetricsRegistry
        from stellar_core_tpu_torch.util.perf import ZoneRegistry

        gcpolicy.install()
        cfg = Config()
        self.metrics = MetricsRegistry(
            window_minutes=cfg.HISTOGRAM_WINDOW_SIZE or None)
        perf = ZoneRegistry()
        self.verifier = CudaBatchVerifier(
            perf=perf, device=device,
            device_min_batch=cfg.VERIFY_DEVICE_MIN_BATCH,
            metrics=self.metrics)
        self.supervisor = BackendSupervisor(
            self.verifier, metrics=self.metrics, perf=perf,
            failure_threshold=cfg.VERIFY_BREAKER_FAILURE_THRESHOLD,
            dispatch_deadline_ms=cfg.VERIFY_DISPATCH_DEADLINE_MS,
            probe_base_ms=cfg.VERIFY_BREAKER_PROBE_BASE_MS,
            probe_max_ms=cfg.VERIFY_BREAKER_PROBE_MAX_MS,
            canary_batch=cfg.VERIFY_BREAKER_CANARY_BATCH)
        self.dispatch = self.supervisor.verify_tuples_async
        self._counters = [
            self.metrics.counter("crypto", "verify_backend", "failure", c)
            for c in FAILURE_CLASSES]
        self._counters.append(
            self.metrics.counter("crypto", "verify_backend", "skip"))

    def health(self) -> int:
        """Failures and skips of the supervisor so far."""
        return sum(c.count for c in self._counters)

    def close(self):
        self.supervisor.shutdown()


def build(device):
    return Seam(device)
