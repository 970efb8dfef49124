"""Standard quorum/connection topologies for simulations.

Reference: src/simulation/Topologies.{h,cpp} — pair, cycle, core
(complete graph), and hierarchical arrangements used across the herder,
overlay, and history test suites. The `tiered` generator
scales to 50–100 in-process nodes: orgs × validators with an org-level
quorum structure (the pubnet shape), an optional watcher tier, and a
deterministic per-link latency/bandwidth model riding the loopback
delay machinery on the VirtualClock (docs/SIMULATION.md).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ..crypto.keys import SecretKey
from ..crypto.sha import sha256
from ..main.config import QuorumSetConfig
from .simulation import Simulation


def _seeds(n: int, tag: bytes) -> List[SecretKey]:
    return [SecretKey.from_seed(sha256(b"topo-%s-%d" % (tag, i)))
            for i in range(n)]


def pair(passphrase: str = "(V) (;,,;) (V)") -> Simulation:
    """Two validators, each requiring both (reference: Topologies::pair)."""
    sim = Simulation(network_passphrase=passphrase)
    seeds = _seeds(2, b"pair")
    ids = [s.public_key().raw for s in seeds]
    qset = QuorumSetConfig(threshold=2, validators=ids)
    for s in seeds:
        sim.add_node(s, qset)
    sim.add_pending_connection(ids[0], ids[1])
    return sim


def core(n: int, threshold: Optional[int] = None,
         passphrase: str = "(V) (;,,;) (V)",
         configure=None) -> Simulation:
    """n validators, complete connection graph, one flat qset
    (reference: Topologies::core; `configure` mirrors the reference's
    per-node confGen callback)."""
    sim = Simulation(network_passphrase=passphrase)
    seeds = _seeds(n, b"core")
    ids = [s.public_key().raw for s in seeds]
    qset = QuorumSetConfig(threshold=threshold or (2 * n + 2) // 3,
                           validators=ids)
    for s in seeds:
        sim.add_node(s, qset, configure=configure)
    for i in range(n):
        for j in range(i + 1, n):
            sim.add_pending_connection(ids[i], ids[j])
    return sim


def cycle(n: int, passphrase: str = "(V) (;,,;) (V)") -> Simulation:
    """n validators in a ring: each trusts itself + both neighbours
    (threshold 2 of 3), connected in a cycle (reference:
    Topologies::cycle4 generalized)."""
    sim = Simulation(network_passphrase=passphrase)
    seeds = _seeds(n, b"cycle")
    ids = [s.public_key().raw for s in seeds]
    for i, s in enumerate(seeds):
        neighbours = [ids[i], ids[(i - 1) % n], ids[(i + 1) % n]]
        sim.add_node(s, QuorumSetConfig(threshold=2,
                                        validators=neighbours))
    for i in range(n):
        sim.add_pending_connection(ids[i], ids[(i + 1) % n])
    return sim


# ------------------------------------------------------------ tiered -----
class LinkLatency:
    """Deterministic per-link latency/bandwidth assignment: intra-org
    links are LAN-fast, cross-org links draw WAN latencies from a
    seeded RNG (the Tail-at-Scale shape — a few links are much slower
    than the median), watcher links sit in between. All figures are
    VIRTUAL seconds; delivery rides the VirtualClock."""

    def __init__(self, seed: int = 7,
                 intra_org_ms: float = 2.0,
                 cross_org_ms: tuple = (30.0, 150.0),
                 watcher_ms: float = 20.0,
                 bandwidth_bps: Optional[float] = None):
        self._rng = random.Random(seed)
        self.intra_org_ms = intra_org_ms
        self.cross_org_ms = cross_org_ms
        self.watcher_ms = watcher_ms
        self.bandwidth_bps = bandwidth_bps

    def for_link(self, kind: str) -> tuple:
        if kind == "intra":
            ms = self.intra_org_ms
        elif kind == "watcher":
            ms = self.watcher_ms
        else:
            lo, hi = self.cross_org_ms
            ms = lo + (hi - lo) * self._rng.random()
        return ms / 1000.0, self.bandwidth_bps


def tiered_org_seeds(n_orgs: int, validators_per_org: int
                     ) -> List[List[SecretKey]]:
    return [_seeds(validators_per_org, b"tier-org-%d" % o)
            for o in range(n_orgs)]


def tiered_qset(org_ids: List[List[bytes]],
                org_threshold: Optional[int] = None,
                top_threshold: Optional[int] = None,
                unsafe: bool = False) -> QuorumSetConfig:
    """The pubnet-shaped quorum set every tiered node runs: inner set
    per org (`org_threshold`-of-members, default simple majority + 1
    rounding = byzantine-safe 2f+1 for 3) and `top_threshold` of the
    orgs (default 2f+1). Deliberately under-thresholded configs are
    REJECTED unless `unsafe=True` — an org threshold at or below half,
    or a top threshold at or below 2/3 of orgs, forfeits quorum
    intersection (test_quorum_intersection.py feeds the weak shapes
    through the checker and watches it find the split)."""
    n_orgs = len(org_ids)
    per_org = len(org_ids[0]) if org_ids else 0
    org_thr = org_threshold if org_threshold is not None else \
        (2 * per_org + 2) // 3
    top_thr = top_threshold if top_threshold is not None else \
        (2 * n_orgs + 2) // 3
    if not unsafe:
        # quorum intersection needs a strict majority at BOTH levels:
        # two disjoint threshold-subsets exist the moment thr*2 <= n
        # (the checker in test_quorum_intersection.py finds the split
        # for exactly these shapes)
        if org_thr * 2 <= per_org:
            raise ValueError(
                "org threshold %d of %d validators cannot guarantee "
                "quorum intersection (need a strict majority); pass "
                "unsafe=True to build it anyway" % (org_thr, per_org))
        if top_thr * 2 <= n_orgs:
            raise ValueError(
                "top-level threshold %d of %d orgs cannot guarantee "
                "quorum intersection (need a strict majority); pass "
                "unsafe=True to build it anyway" % (top_thr, n_orgs))
    inner = [QuorumSetConfig(threshold=org_thr, validators=list(org))
             for org in org_ids]
    return QuorumSetConfig(threshold=top_thr, validators=[],
                           inner_sets=inner)


def tiered_qmap(n_orgs: int = 3, validators_per_org: int = 3,
                org_threshold: Optional[int] = None,
                top_threshold: Optional[int] = None,
                unsafe: bool = False) -> Dict[bytes, object]:
    """node id -> SCPQuorumSet for the tiered topology WITHOUT building
    any Application — feeds the quorum intersection checker directly
    (tests/test_quorum_intersection.py)."""
    org_seeds = tiered_org_seeds(n_orgs, validators_per_org)
    org_ids = [[s.public_key().raw for s in org] for org in org_seeds]
    qset = tiered_qset(org_ids, org_threshold, top_threshold,
                       unsafe=unsafe).to_scp_quorum_set()
    return {nid: qset for org in org_ids for nid in org}


def tiered_links(org_ids: List[List[bytes]],
                 watcher_ids: Optional[List[bytes]] = None
                 ) -> List[tuple]:
    """The tiered topology's link list as ``(a, b, kind)`` tuples —
    complete graph inside each org, each validator braided to its
    positional peer in the next org, two validator uplinks per
    watcher. Shared by the in-process ``tiered()`` Simulation builder
    and the multi-process cluster harness (simulation/cluster.py),
    which wires the same mesh over real TCP sockets."""
    links: List[tuple] = []
    seen: set = set()

    def _add(a: bytes, b: bytes, kind: str) -> None:
        # undirected dedupe: with 2 orgs the braid's wrap-around emits
        # each cross pair from both sides, and a doubled link would
        # overstate every harness node's expected mesh degree
        if a == b or frozenset((a, b)) in seen:
            return
        seen.add(frozenset((a, b)))
        links.append((a, b, kind))

    for org in org_ids:
        for i in range(len(org)):
            for j in range(i + 1, len(org)):
                _add(org[i], org[j], "intra")
    n_orgs = len(org_ids)
    for o in range(n_orgs):
        nxt = org_ids[(o + 1) % n_orgs]
        for i, nid in enumerate(org_ids[o]):
            _add(nid, nxt[i % len(nxt)], "cross")
    flat_ids = [nid for org in org_ids for nid in org]
    for w, wid in enumerate(watcher_ids or []):
        for k in range(2):
            _add(wid, flat_ids[(w + k * 7) % len(flat_ids)], "watcher")
    return links


def tiered(n_orgs: int = 3, validators_per_org: int = 3,
           watchers: int = 0,
           org_threshold: Optional[int] = None,
           top_threshold: Optional[int] = None,
           passphrase: str = "(V) (;,,;) (V)",
           configure=None, data_dir: Optional[str] = None,
           latency: Optional[LinkLatency] = None,
           unsafe: bool = False) -> Simulation:
    """Tiered-quorum network: `n_orgs` orgs ×
    `validators_per_org` validators plus a non-validating watcher tier,
    scaling to 50–100 in-process nodes. Connections: complete graph
    inside each org, each validator linked to its positional peer in
    the next org (a braided inter-org ring — O(n) links, no O(n²)
    blowup at 100 nodes), watchers fanned across the validators. With
    `latency`, every link gets a deterministic virtual-time
    latency/bandwidth assignment."""
    sim = Simulation(network_passphrase=passphrase, data_dir=data_dir)
    org_seeds = tiered_org_seeds(n_orgs, validators_per_org)
    org_ids = [[s.public_key().raw for s in org] for org in org_seeds]
    qset = tiered_qset(org_ids, org_threshold, top_threshold,
                       unsafe=unsafe)
    for org in org_seeds:
        for s in org:
            sim.add_node(s, qset, configure=configure)

    def watcher_configure(cfg):
        if configure is not None:
            configure(cfg)
        cfg.NODE_IS_VALIDATOR = False
        cfg.FORCE_SCP = False

    watcher_seeds = _seeds(watchers, b"tier-watcher")
    for s in watcher_seeds:
        sim.add_node(s, qset, configure=watcher_configure)
    # the shared edge list (also the cluster harness's mesh): intra-org
    # complete graphs, braided inter-org ring, two validator uplinks
    # per watcher spread across orgs
    for a, b, kind in tiered_links(
            org_ids, [s.public_key().raw for s in watcher_seeds]):
        lat, bw = latency.for_link(kind) if latency else (0.0, None)
        sim.add_pending_connection(a, b, latency_s=lat,
                                   bandwidth_bps=bw)
    return sim


def hierarchical_quorum(n_core: int, n_outer: int,
                        passphrase: str = "(V) (;,,;) (V)") -> Simulation:
    """A core clique plus outer validators that trust the core
    (reference: Topologies::hierarchicalQuorum, simplified)."""
    sim = Simulation(network_passphrase=passphrase)
    core_seeds = _seeds(n_core, b"hcore")
    core_ids = [s.public_key().raw for s in core_seeds]
    core_qset = QuorumSetConfig(threshold=(2 * n_core + 2) // 3,
                                validators=core_ids)
    for s in core_seeds:
        sim.add_node(s, core_qset)
    outer_seeds = _seeds(n_outer, b"houter")
    for s in outer_seeds:
        # outer nodes: require a core majority
        sim.add_node(s, QuorumSetConfig(
            threshold=(n_core // 2) + 1, validators=list(core_ids)))
    for i in range(n_core):
        for j in range(i + 1, n_core):
            sim.add_pending_connection(core_ids[i], core_ids[j])
    for i, s in enumerate(outer_seeds):
        sim.add_pending_connection(s.public_key().raw,
                                   core_ids[i % n_core])
    return sim
