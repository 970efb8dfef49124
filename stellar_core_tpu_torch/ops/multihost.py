"""Multi-process device meshes for the batch verifier.

Counterpart of stellar_core_tpu/ops/multihost.py. Within a host,
signatures shard over the cards (the ICI axis of the reference's mesh);
across hosts, over processes (the DCN axis). Each host verifies its own
shards, so the network carries only the verdicts, never the tuples: the
workload is data-parallel and signatures share no state.

- `initialize_distributed` joins the process group (one process per
  host). It uses the gloo backend: the only thing that crosses
  processes is the host-side bool verdicts, which gloo moves between
  CPU tensors on a machine with cards as on one without.
- `make_hybrid_mesh` builds the (dcn, ici) grid. A torch process cannot
  name another host's device, so a position of the grid is
  `Position(rank, device)`: the rank that verifies its shards and the
  device on that rank's host.
- `HybridShardedVerifier` shards a batch over the flattened grid. Every
  rank is handed the same batch (the reference's SPMD contract), runs
  the shards its own positions own and, in collect(), receives the other
  ranks' verdicts. gloo's all_gather takes equal sizes only, so the
  gather is one broadcast per rank that owns rows, in rank order: each
  rank sends its shards' verdicts, one byte per row, and a 16-byte tag.

The reference's `make_hybrid_verify` (a shard_map program over both
axes) has no counterpart: per-device launches replace compiled meshes
(ops/verifier.py).

Gathers run in dispatch order. Under jax.distributed the collective is
inside the dispatched program, so the order of dispatch pairs the ranks'
collectives; here the broadcasts are made in collect(), which callers
may run in any order and on several threads (VerifyService collects
outside its lock, the supervisor's watchdog on a worker per collect).
So every dispatch takes a sequence number and queues its gather, and a
collect runs every queued gather up to and including its own, in
order, under one lock. A rank that collects batch B before batch A
still gathers A first, as every other rank does. The tag of a
broadcast is the batch's sequence number and a digest of its
signatures, active positions and row split: a receiver that finds
another batch's tag raises, and the verifier stays broken (every later
collect raises), so a group out of step fails loudly, the supervisor
rates it fatal and the native verifier serves, and no signature ever
takes another tuple's verdict.

SPMD constraint, as under jax.distributed: every rank must dispatch the
same batches in the same order with the same active set. The breakers
of ops/backend_supervisor.py are rank-local, so a card that trips on
one rank only makes the ranks' gathers differ. Where the broadcasts
still pair up, the tags differ and the collect raises; where they do
not (another count of broadcasts or of rows), the gather blocks. The
supervisor's dispatch deadline bounds the caller's wait and the native
verifier serves that flush, but the blocked gather holds the lock, so
every later collect of this verifier waits behind it and times out too
until the process group's timeout ends it with an error that
breaks the verifier.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .verifier import ShardedBatchVerifier, resolve_devices


class Position(NamedTuple):
    """One position of a hybrid grid: the rank that owns it and the
    device on that rank's host."""
    rank: int
    device: torch.device


class Mesh:
    """A device grid with named axes, as jax.sharding.Mesh is used by
    the reference: `.devices` (a numpy object array) and `.axis_names`."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d grid for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)


def _world() -> tuple:
    """(rank, world size) of the process group, (0, 1) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Join the process group, one process per host (a no-op for a
    single process). `coordinator` is "host:port" of rank 0, as the
    node's config carries it."""
    if num_processes is None or num_processes <= 1:
        return
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id)


def make_hybrid_mesh(devices: Optional[Sequence] = None,
                     n_hosts: Optional[int] = None) -> Mesh:
    """(dcn, ici) grid of `Position`s. `devices` is the flat list of the
    whole grid, folded into n_hosts rows (default: this process's visible
    cards, the same on every host). `n_hosts` defaults to the process
    group's world size. In a process group, row r belongs to rank r, and
    n_hosts must equal the world size; in a single process every row
    belongs to it (tests: a list standing in for N hosts x M cards)."""
    world = _world()[1]
    if n_hosts is None:
        n_hosts = world
    if n_hosts < 1:
        raise ValueError(f"{n_hosts} hosts")
    if devices is None:
        devices = resolve_devices() * n_hosts
    devices = resolve_devices(devices)
    per_host = len(devices) // n_hosts
    if per_host * n_hosts != len(devices):
        raise ValueError(f"{len(devices)} devices do not fold into "
                         f"{n_hosts} hosts")
    if world > 1 and n_hosts != world:
        raise ValueError(f"{n_hosts} hosts in a process group of {world}")
    grid = np.empty((n_hosts, per_host), dtype=object)
    for r in range(n_hosts):
        for j in range(per_host):
            grid[r, j] = Position(r if world > 1 else 0,
                                  devices[r * per_host + j])
    return Mesh(grid, ("dcn", "ici"))


TAG_BYTES = 16   # sequence number (8 bytes) and batch digest (8 bytes)


class GatherMismatch(RuntimeError):
    """The ranks' gathers are out of step: verdicts of another batch."""


class _Exchange:
    """One dispatch's pending gather."""
    __slots__ = ("seq", "res", "events", "positions", "counts", "tag",
                 "done")

    def __init__(self, seq, res, events, positions, counts, digest):
        self.seq = seq
        self.res = res
        self.events = events
        self.positions = positions
        self.counts = counts
        self.tag = seq.to_bytes(8, "little") + digest
        self.done = False


class HybridShardedVerifier(ShardedBatchVerifier):
    """Data-parallel batch verifier over a (dcn, ici) grid: the sharded
    verifier over the flattened grid, where each rank launches only the
    shards of its own positions. The per-device health machinery is
    the sharded verifier's over the flattened list, so a sick card
    shrinks the grid as it does a 1-D mesh: a degraded active set is the
    1-D path over the survivors, each still verified by its owner."""

    def __init__(self, mesh: Optional[Mesh] = None, perf=None,
                 device_sha=None, device_min_batch=None, metrics=None):
        mesh = mesh if mesh is not None else make_hybrid_mesh()
        self.positions = list(mesh.devices.flat)
        self.rank, self.world = _world()
        owners = [p.rank for p in self.positions]
        if owners != sorted(owners) or not set(owners) <= set(
                range(self.world)):
            raise ValueError(f"grid ranks {owners}: rows must belong to "
                             f"ranks 0..{self.world - 1} in order")
        # positions of other ranks name devices on their hosts: this
        # rank never launches on them (_shard_device)
        super().__init__(devices=[p.device for p in self.positions],
                         perf=perf, device_sha=device_sha,
                         device_min_batch=device_min_batch,
                         metrics=metrics)
        self.mesh = mesh
        # gathers in dispatch order (see the module docstring)
        self._queue_lock = threading.Lock()
        self._gather_lock = threading.Lock()
        self._queue = collections.deque()
        self._next_seq = 0
        self._broken: Optional[BaseException] = None

    def _shard_device(self, position: int):
        p = self.positions[position]
        return p.device if p.rank == self.rank else None

    def _gather(self, res, events, positions, counts, sigs):
        if self.world == 1:
            return None
        h = hashlib.blake2b(digest_size=8)
        h.update(repr((len(res), tuple(positions), tuple(counts))).encode())
        h.update(np.ascontiguousarray(sigs, dtype=np.uint8).tobytes())
        with self._queue_lock:
            x = _Exchange(self._next_seq, res, events, positions, counts,
                          h.digest())
            self._next_seq += 1
            self._queue.append(x)
        return lambda: self._gather_through(x)

    def _gather_through(self, x: "_Exchange") -> None:
        """Run the queued gathers in dispatch order up to and including
        `x` (another thread may have run it already)."""
        with self._gather_lock:
            while not x.done:
                if self._broken is not None:
                    raise GatherMismatch(
                        "hybrid verifier broken by an earlier gather: "
                        f"{self._broken!r}") from self._broken
                with self._queue_lock:
                    head = self._queue[0]
                try:
                    self._exchange(head)
                except BaseException as e:
                    self._broken = e
                    raise
                with self._queue_lock:
                    self._queue.popleft()
                head.done = True

    def _exchange(self, x: "_Exchange") -> None:
        """One batch's gather: each rank that owns rows broadcasts its
        verdicts and the batch's tag, in rank order. Every broadcast is
        made before a tag is judged, so the ranks leave the gather
        together."""
        for done in x.events:
            done.synchronize()
        rows = [0] * self.world
        for i, c in zip(x.positions, x.counts):
            rows[self.positions[i].rank] += c
        # active positions are sorted and ranks own rows in order,
        # so each rank's rows are one run of the batch
        tag = torch.frombuffer(bytearray(x.tag), dtype=torch.uint8)
        off, wrong = 0, []
        for r, c in enumerate(rows):
            if c:
                msg = torch.empty(c + TAG_BYTES, dtype=torch.uint8)
                if r == self.rank:
                    msg[:c].copy_(x.res[off:off + c])
                    msg[c:] = tag
                torch.distributed.broadcast(msg, src=r)
                if r != self.rank:
                    if torch.equal(msg[c:], tag):
                        x.res[off:off + c].copy_(msg[:c])
                    else:
                        wrong.append(r)
            off += c
        if wrong:
            raise GatherMismatch(
                f"batch {x.seq}: ranks {wrong} sent the verdicts of "
                "another batch: the ranks' gathers are out of step")

