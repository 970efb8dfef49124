"""Coverage-guided fuzzing loop.

Reference: the AFL harness + build targets (docs/fuzzing.md:1-40,
Makefile.am:144) — instrumented edge coverage steering an input-mutation
loop.  The reference gets its instrumentation from afl-clang at compile
time; this build gets it from CPython's sys.monitoring (PEP 669): LINE
and BRANCH events over the package's own code, with per-location
DISABLE after first hit, so steady-state overhead is near zero and "any
callback fired" == "this input reached code no previous input reached".

The loop is AFL-shaped: seed corpus from the existing generators, pick
a corpus entry, mutate (bit/byte flips, arithmetic, block ops, splice),
run it through the same TransactionFuzzer/OverlayFuzzer targets the
one-shot `fuzz` command uses, keep inputs that light up new coverage,
record crashing inputs (any escape that is not a clean reject).
"""

from __future__ import annotations

import os
import random
import sys
import time
from typing import List, Optional

from ..util.logging import get_logger

log = get_logger("default")

_PKG_PREFIX = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class CoverageMonitor:
    """sys.monitoring-backed global-novelty coverage map."""

    TOOL_ID = 4     # a free slot (0-2 are claimed by debugger/coverage/
    # profiler conventions; 4 is ours)

    def __init__(self, prefix: str = _PKG_PREFIX):
        self.prefix = prefix
        self.total_locations = 0
        self._new_this_input = 0
        self._mon = sys.monitoring

    def start(self) -> None:
        m = self._mon
        m.use_tool_id(self.TOOL_ID, "stellar-fuzz-cov")
        m.register_callback(self.TOOL_ID, m.events.LINE, self._on_line)
        m.register_callback(self.TOOL_ID, m.events.BRANCH,
                            self._on_branch)
        m.set_events(self.TOOL_ID, m.events.LINE | m.events.BRANCH)

    def stop(self) -> None:
        m = self._mon
        m.set_events(self.TOOL_ID, 0)
        m.free_tool_id(self.TOOL_ID)

    # callbacks return DISABLE so each location reports exactly once —
    # the coverage map "fills up" and later hits cost nothing
    def _on_line(self, code, line):
        if code.co_filename.startswith(self.prefix):
            self.total_locations += 1
            self._new_this_input += 1
        return self._mon.DISABLE

    def _on_branch(self, code, offset, dest):
        if code.co_filename.startswith(self.prefix):
            self.total_locations += 1
            self._new_this_input += 1
        return self._mon.DISABLE

    def begin_input(self) -> None:
        self._new_this_input = 0

    def new_coverage(self) -> int:
        return self._new_this_input


class Mutator:
    """AFL-style havoc mutations on raw bytes."""

    def __init__(self, rng: random.Random):
        self.rng = rng

    def mutate(self, data: bytes, other: Optional[bytes] = None) -> bytes:
        buf = bytearray(data)
        rng = self.rng
        for _ in range(rng.randint(1, 8)):
            if not buf:
                buf = bytearray(rng.randbytes(rng.randint(1, 64)))
                continue
            k = rng.randint(0, 7)
            i = rng.randrange(len(buf))
            if k == 0:                         # bit flip
                buf[i] ^= 1 << rng.randint(0, 7)
            elif k == 1:                       # byte set
                buf[i] = rng.randint(0, 255)
            elif k == 2:                       # arithmetic +-
                buf[i] = (buf[i] + rng.choice((1, -1, 16, -16))) & 0xFF
            elif k == 3:                       # interesting 32-bit value
                v = rng.choice((0, 1, 0x7FFFFFFF, 0x80000000,
                                0xFFFFFFFF, 100, 255))
                chunk = v.to_bytes(4, rng.choice(("big", "little")))
                buf[i:i + 4] = chunk
            elif k == 4:                       # delete block
                j = min(len(buf), i + rng.randint(1, 16))
                del buf[i:j]
            elif k == 5:                       # duplicate block
                j = min(len(buf), i + rng.randint(1, 16))
                buf[i:i] = buf[i:j]
            elif k == 6:                       # insert random block
                buf[i:i] = rng.randbytes(rng.randint(1, 16))
            elif k == 7 and other:             # splice with another input
                j = rng.randrange(len(other))
                buf = bytearray(buf[:i] + other[j:])
        return bytes(buf)


class FuzzStats:
    def __init__(self):
        self.runs = 0
        self.interesting = 0
        self.crashes: List[bytes] = []
        self.corpus_size = 0
        self.total_locations = 0


def run_coverage_fuzz(mode: str, runs: int = 200, seed: int = 1,
                      corpus_dir: Optional[str] = None,
                      time_budget: Optional[float] = None) -> FuzzStats:
    """The loop.  `runs` bounds iterations (deterministic tests);
    `time_budget` (seconds) bounds wall clock (ops usage, e.g. the
    10-minute soak from the reference's fuzzing docs)."""
    import tempfile

    from .fuzzer import OverlayFuzzer, TransactionFuzzer

    rng = random.Random(seed)
    mut = Mutator(rng)
    stats = FuzzStats()
    cls = TransactionFuzzer if mode == "tx" else OverlayFuzzer

    # seed corpus from the generative fuzzer (reference: gen-fuzz seeds)
    tmp = tempfile.mkdtemp(prefix="fuzz-cov-")
    corpus: List[bytes] = []
    for i in range(8):
        p = os.path.join(tmp, f"seed{i}")
        cls.gen_fuzz(p, seed * 100 + i)
        with open(p, "rb") as f:
            corpus.append(f.read())

    target = cls()
    cov = CoverageMonitor()
    cov.start()
    inject_path = os.path.join(tmp, "cur")
    t0 = time.monotonic()
    try:
        # first pass: replay seeds so their coverage is in the map
        for data in list(corpus):
            with open(inject_path, "wb") as f:
                f.write(data)
            cov.begin_input()
            try:
                target.inject(inject_path)
            except Exception:
                stats.crashes.append(data)

        while stats.runs < runs:
            if time_budget is not None and \
                    time.monotonic() - t0 > time_budget:
                break
            stats.runs += 1
            base = rng.choice(corpus)
            other = rng.choice(corpus)
            data = mut.mutate(base, other)
            with open(inject_path, "wb") as f:
                f.write(data)
            cov.begin_input()
            try:
                target.inject(inject_path)
            except Exception as e:          # noqa: BLE001 — crash record
                stats.crashes.append(data)
                log.warning("fuzz crash (%s): %r", mode, e)
                # crashing targets may be wedged: rebuild
                try:
                    target.shutdown()
                except Exception:
                    pass
                target = cls()
                continue
            if cov.new_coverage():
                stats.interesting += 1
                corpus.append(data)
                if corpus_dir:
                    os.makedirs(corpus_dir, exist_ok=True)
                    name = f"{mode}-{len(corpus):05d}"
                    with open(os.path.join(corpus_dir, name), "wb") as f:
                        f.write(data)
    finally:
        cov.stop()
        try:
            target.shutdown()
        except Exception:
            pass
    stats.corpus_size = len(corpus)
    stats.total_locations = cov.total_locations
    if corpus_dir and stats.crashes:
        crash_dir = os.path.join(corpus_dir, "crashes")
        os.makedirs(crash_dir, exist_ok=True)
        for i, c in enumerate(stats.crashes):
            with open(os.path.join(crash_dir, f"{mode}-{i:03d}"),
                      "wb") as f:
                f.write(c)
    log.info("fuzz[%s]: %d runs, %d interesting, corpus %d, "
             "%d locations, %d crashes", mode, stats.runs,
             stats.interesting, stats.corpus_size,
             stats.total_locations, len(stats.crashes))
    return stats
