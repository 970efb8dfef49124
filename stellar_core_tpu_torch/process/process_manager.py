"""Bounded-concurrency subprocess execution.

Reference: src/process/ProcessManagerImpl.{h,cpp} — posix_spawn'd shell
commands (history archive get/put) with a MAX_CONCURRENT_SUBPROCESSES
gate, exit reaping integrated with the event loop, and kill-on-shutdown.
Here: subprocess.Popen polled from a clock io-poller.
"""

from __future__ import annotations

import shlex
import subprocess
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..util.logging import get_logger

log = get_logger("Process")

# reference: ProcessManagerImpl MAX_CONCURRENT_SUBPROCESSES (config)
DEFAULT_MAX_CONCURRENT = 16


class ProcessExitEvent:
    """Handle for one queued/running command; `on_exit(code)` fires when
    the process exits (reference: ProcessExitEvent + its asio timer)."""

    def __init__(self, cmd: str):
        self.cmd = cmd
        self.proc: Optional[subprocess.Popen] = None
        self.exit_code: Optional[int] = None
        self.on_exit: Optional[Callable[[int], None]] = None

    @property
    def running(self) -> bool:
        return self.proc is not None and self.exit_code is None


class ProcessManager:
    def __init__(self, app, max_concurrent: int = DEFAULT_MAX_CONCURRENT):
        self.app = app
        self.max_concurrent = max_concurrent
        self._pending: Deque[ProcessExitEvent] = deque()
        self._running: List[ProcessExitEvent] = []
        self._shutdown = False
        app.clock.add_io_poller(self._poll)

    def run_process(self, cmd: str,
                    on_exit: Optional[Callable[[int], None]] = None
                    ) -> ProcessExitEvent:
        """Queue a shell command (reference: runProcess)."""
        ev = ProcessExitEvent(cmd)
        ev.on_exit = on_exit
        self._pending.append(ev)
        self._maybe_start()
        return ev

    def _maybe_start(self) -> None:
        while self._pending and len(self._running) < self.max_concurrent \
                and not self._shutdown:
            ev = self._pending.popleft()
            try:
                ev.proc = subprocess.Popen(
                    ev.cmd, shell=True,
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            except OSError as e:
                log.error("spawn failed for %r: %s", ev.cmd, e)
                ev.exit_code = 127
                if ev.on_exit is not None:
                    ev.on_exit(127)
                continue
            self._running.append(ev)

    def _poll(self) -> int:
        n = 0
        for ev in list(self._running):
            code = ev.proc.poll()
            if code is not None:
                ev.exit_code = code
                self._running.remove(ev)
                n += 1
                if ev.on_exit is not None:
                    ev.on_exit(code)
        if n:
            self._maybe_start()
        return n

    def num_running(self) -> int:
        return len(self._running)

    def num_pending(self) -> int:
        return len(self._pending)

    def shutdown(self) -> None:
        self._shutdown = True
        self._pending.clear()
        for ev in self._running:
            try:
                ev.proc.kill()
            except OSError:
                pass
        for ev in self._running:
            try:
                ev.proc.wait(timeout=5)
            except Exception:
                pass
        self._running = []
        self.app.clock.remove_io_poller(self._poll)
