"""Shard-share arithmetic shared by the mesh dispatch path and the
backend supervisor (jax-free on purpose: the supervisor must stay
importable without the device stack for fake-verifier harnesses).

One definition, two consumers: `ShardedBatchVerifier.verify_batch_async`
splits a batch into per-shard row counts with it, and
`BackendSupervisor._dispatch` reports the same split to the per-device
chaos seam (`ops.backend.dispatch.device`, `n=<share>`). They MUST stay
in lockstep — a fault spec targeting one shard describes exactly the
rows that shard actually owns.
"""

from typing import List


def shard_shares(n: int, k: int) -> List[int]:
    """Row counts per shard for `n` items over `k` shards: the first
    ``n % k`` shards take one extra row. Sums to exactly `n`."""
    base, extra = divmod(n, k)
    return [base + (1 if s < extra else 0) for s in range(k)]
