"""Deterministic RNG wrappers (reference: src/util/Math.h, util/RandHasher.h).

The reference bans std::rand / std::uniform_int_distribution / std::shuffle
(platform-varying) via the check-nondet lint and routes all randomness through
a seeded global engine so tests replay identically. We mirror that: all node
randomness must come from this module, never the bare `random` module.
"""

from __future__ import annotations

import random as _random

_engine = _random.Random(0)


def seed(n: int) -> None:
    global _engine
    _engine = _random.Random(n)


def rand_int(upper_exclusive: int) -> int:
    """Uniform in [0, upper) — stable across platforms (util/Math.h)."""
    return _engine.randrange(upper_exclusive)


def rand_range(lo: int, hi_exclusive: int) -> int:
    return _engine.randrange(lo, hi_exclusive)


def rand_fraction() -> float:
    return _engine.random()


def rand_flip() -> bool:
    return _engine.random() < 0.5


def shuffle(xs: list) -> None:
    _engine.shuffle(xs)


def sample(xs, k: int):
    return _engine.sample(list(xs), k)


def rand_bytes(n: int) -> bytes:
    return _engine.randbytes(n)
