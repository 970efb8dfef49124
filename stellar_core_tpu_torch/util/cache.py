"""RandomEvictionCache — bounded map with random eviction.

Reference: src/util/RandomEvictionCache.h. Used most prominently as the
global signature-verification cache (crypto/SecretKey.cpp:37-60): 0xffff
entries keyed by BLAKE2(key‖sig‖msg) with hit/miss counters. Random (rather
than LRU) eviction keeps the hot path O(1) without bookkeeping writes.
"""

from __future__ import annotations

import random
from typing import Dict, Generic, Hashable, List, Optional, TypeVar

from .checks import releaseAssert

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class RandomEvictionCache(Generic[K, V]):
    def __init__(self, max_size: int, seed: int = 0):
        releaseAssert(max_size > 0, "cache max_size must be positive")
        self.max_size = max_size
        self._map: Dict[K, int] = {}       # key -> index into _slots
        self._slots: List[tuple] = []      # (key, value)
        self._rng = random.Random(seed)
        self.hits = 0
        self.misses = 0
        self.inserts = 0

    def __len__(self) -> int:
        return len(self._slots)

    def maybe_get(self, key: K) -> Optional[V]:
        idx = self._map.get(key)
        if idx is None:
            self.misses += 1
            return None
        self.hits += 1
        return self._slots[idx][1]

    def exists(self, key: K) -> bool:
        # Non-counting probe (reference exposes both exists() and get()).
        return key in self._map

    def put(self, key: K, value: V) -> None:
        self.inserts += 1
        idx = self._map.get(key)
        if idx is not None:
            self._slots[idx] = (key, value)
            return
        if len(self._slots) >= self.max_size:
            # evict a uniformly random victim: swap-with-last + pop, O(1)
            victim = self._rng.randrange(len(self._slots))
            vkey, _ = self._slots[victim]
            last_key, last_val = self._slots[-1]
            self._slots[victim] = (last_key, last_val)
            self._map[last_key] = victim
            self._slots.pop()
            del self._map[vkey]
        self._map[key] = len(self._slots)
        self._slots.append((key, value))

    def clear(self) -> None:
        self._map.clear()
        self._slots.clear()

    def reset_counters(self) -> None:
        self.hits = self.misses = self.inserts = 0
