"""Quorum-set sanity + normalization.

Reference: src/scp/QuorumSetUtils.cpp — sanity enforces threshold bounds,
nesting depth <= 4, 1..1000 total validators, no duplicate nodes;
normalization removes a given node, collapses singleton inner sets, and
sorts for canonical hashing.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from ..xdr.scp import SCPQuorumSet
from .local_node import node_key

MAXIMUM_QUORUM_NESTING_LEVEL = 4


def is_quorum_set_sane(qset: SCPQuorumSet, extra_checks: bool
                       ) -> Tuple[bool, Optional[str]]:
    known: Set[bytes] = set()
    count = [0]

    def check(qs: SCPQuorumSet, depth: int) -> Optional[str]:
        if depth > MAXIMUM_QUORUM_NESTING_LEVEL:
            return "Maximum quorum nesting level exceeded"
        if qs.threshold < 1:
            return "Threshold must be greater than 0"
        tot_entries = len(qs.validators) + len(qs.innerSets)
        v_blocking_size = tot_entries - qs.threshold + 1
        count[0] += len(qs.validators)
        if qs.threshold > tot_entries:
            return "Threshold exceeds total number of entries"
        if extra_checks and qs.threshold < v_blocking_size:
            return "Threshold is lower than the v-blocking size (< 51%)."
        for v in qs.validators:
            vk = node_key(v)
            if vk in known:
                return "Duplicate node found in quorum configuration"
            known.add(vk)
        for inner in qs.innerSets:
            err = check(inner, depth + 1)
            if err:
                return err
        return None

    err = check(qset, 0)
    if err is None and not (1 <= count[0] <= 1000):
        err = "Total number of nodes in a quorum must be within 1 and 1000"
    return err is None, err


def normalize_qset(qset: SCPQuorumSet,
                   id_to_remove: Optional[bytes] = None) -> None:
    """In-place: remove `id_to_remove` (lowering thresholds), collapse
    singleton inner sets, sort everything for canonical form (reference:
    normalizeQSet = normalizeQSetSimplify + reorder)."""
    _simplify(qset, id_to_remove)
    _reorder(qset)


def _simplify(qs: SCPQuorumSet, id_to_remove: Optional[bytes]) -> None:
    if id_to_remove is not None:
        kept = [v for v in qs.validators if node_key(v) != id_to_remove]
        qs.threshold -= len(qs.validators) - len(kept)
        qs.validators = kept
    new_inner: List[SCPQuorumSet] = []
    for inner in qs.innerSets:
        _simplify(inner, id_to_remove)
        if inner.threshold == 1 and len(inner.validators) == 1 \
                and len(inner.innerSets) == 0:
            qs.validators = list(qs.validators) + [inner.validators[0]]
        else:
            new_inner.append(inner)
    qs.innerSets = new_inner


def _reorder(qs: SCPQuorumSet) -> None:
    for inner in qs.innerSets:
        _reorder(inner)
    qs.validators = sorted(qs.validators, key=node_key)
    qs.innerSets = sorted(qs.innerSets, key=lambda s: s.to_bytes())
