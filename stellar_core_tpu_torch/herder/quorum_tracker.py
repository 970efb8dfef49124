"""Transitive-quorum tracker.

Maintains, for every node reachable through quorum-set references from the
local node, how far away it is (in qset hops) and through which immediate
validators it is reached. Reference: src/herder/QuorumTracker.{h,cpp} —
`QuorumTracker::expand` (incremental) and `rebuild` (full BFS), consumed by
`HerderImpl::isNodeDefinitelyInQuorum` and the `quorum` HTTP endpoint's
"transitive" section.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

from ..xdr.scp import SCPQuorumSet


def _qset_nodes(qset: SCPQuorumSet) -> Set[bytes]:
    """All node ids referenced (recursively) by a quorum set."""
    out: Set[bytes] = set()
    for v in qset.validators:
        out.add(bytes(v.value))
    for inner in qset.innerSets:
        out |= _qset_nodes(inner)
    return out


@dataclass
class NodeInfo:
    """What we know about one node in the transitive quorum."""
    qset: Optional[SCPQuorumSet] = None
    distance: int = 0
    # local-qset validators through which this node is reachable
    closest_validators: Set[bytes] = field(default_factory=set)


class QuorumTracker:
    """Tracks the transitive closure of quorum-set references starting at
    the local node's quorum set."""

    def __init__(self, local_node_id: bytes, local_qset: SCPQuorumSet):
        self._local_id = local_node_id
        self._local_qset = local_qset
        self._quorum: Dict[bytes, NodeInfo] = {}
        self.rebuild(lambda _: None)

    # ------------------------------------------------------------ queries --
    def is_node_definitely_in_quorum(self, node_id: bytes) -> bool:
        return node_id in self._quorum

    @property
    def quorum_map(self) -> Dict[bytes, NodeInfo]:
        return self._quorum

    def set_local_qset(self, qset: SCPQuorumSet,
                       lookup: Callable[[bytes], Optional[SCPQuorumSet]]
                       ) -> None:
        self._local_qset = qset
        self.rebuild(lookup)

    # ------------------------------------------------------------ updates --
    def expand(self, node_id: bytes, qset: SCPQuorumSet) -> bool:
        """Incrementally record `node_id`'s quorum set. Returns False when
        the update cannot be applied incrementally (unknown node, or a
        conflicting qset already recorded) — caller should `rebuild`."""
        info = self._quorum.get(node_id)
        if info is None:
            return False  # not reachable as far as we know: needs rebuild
        if info.qset is not None:
            return info.qset is qset or info.qset == qset
        new_nodes = _qset_nodes(qset)
        # refuse to shorten an existing node's distance incrementally —
        # descendants computed from the longer path would go stale
        # (reference handles inconsistencies by forcing a rebuild)
        for nid in new_nodes:
            sub = self._quorum.get(nid)
            if sub is not None and info.distance + 1 < sub.distance:
                return False
        info.qset = qset
        for nid in new_nodes:
            sub = self._quorum.get(nid)
            if sub is None:
                self._quorum[nid] = NodeInfo(
                    qset=None, distance=info.distance + 1,
                    closest_validators=set(info.closest_validators))
            else:
                # union of reach paths ("reachable through" semantics)
                sub.closest_validators |= info.closest_validators
        return True

    def rebuild(self, lookup: Callable[[bytes], Optional[SCPQuorumSet]]
                ) -> None:
        """Full BFS from the local qset, resolving qsets via `lookup`."""
        self._quorum = {self._local_id: NodeInfo(qset=self._local_qset,
                                                 distance=0)}
        frontier = deque()
        for nid in _qset_nodes(self._local_qset):
            info = self._quorum.get(nid)
            if info is None:
                self._quorum[nid] = NodeInfo(distance=1,
                                             closest_validators={nid})
                frontier.append(nid)
            else:
                info.closest_validators.add(nid)
        while frontier:
            nid = frontier.popleft()
            info = self._quorum[nid]
            qset = info.qset if info.qset is not None else lookup(nid)
            if qset is None:
                continue
            info.qset = qset
            for sub in _qset_nodes(qset):
                known = self._quorum.get(sub)
                if known is None:
                    self._quorum[sub] = NodeInfo(
                        distance=info.distance + 1,
                        closest_validators=set(info.closest_validators))
                    frontier.append(sub)
                else:
                    known.closest_validators |= info.closest_validators
                    if info.distance + 1 < known.distance:
                        known.distance = info.distance + 1

    # --------------------------------------------------------- inspection --
    def transitive_json(self) -> dict:
        from ..crypto.strkey import StrKey
        nodes = []
        for nid, info in sorted(self._quorum.items()):
            nodes.append({
                "node": StrKey.encode_ed25519_public(nid),
                "distance": info.distance,
                "heard_qset": info.qset is not None,
            })
        return {"node_count": len(self._quorum), "nodes": nodes}
