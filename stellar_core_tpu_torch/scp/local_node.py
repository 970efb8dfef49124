"""Quorum-set logic: slices, v-blocking sets, transitive quorums.

Reference: src/scp/LocalNode.{h,cpp}. The three core predicates:
- is_quorum_slice: nodeSet satisfies qset's threshold recursively.
- is_v_blocking: nodeSet intersects every slice of qset.
- is_quorum: largest subset of the statement map whose members' own qsets
  are satisfied within the subset (transitive closure), checked against
  the local qset.
All node identifiers here are raw 32-byte NodeID key bytes.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Set

from ..crypto.sha import sha256
from ..xdr.scp import SCPQuorumSet, SCPStatement
from ..xdr.types import PublicKey


def node_key(node_id) -> bytes:
    """NodeID (PublicKey union) → raw 32-byte dict key."""
    if isinstance(node_id, bytes):
        return node_id
    return bytes(node_id.value)


def qset_hash(qset: SCPQuorumSet) -> bytes:
    return sha256(qset.to_bytes())


def singleton_qset(node_id_raw: bytes) -> SCPQuorumSet:
    """reference: LocalNode::getSingletonQSet — EXTERNALIZE statements
    act as their own quorum of one."""
    return SCPQuorumSet(threshold=1,
                        validators=[PublicKey.ed25519(node_id_raw)],
                        innerSets=[])


def for_all_nodes(qset: SCPQuorumSet, proc: Callable[[bytes], bool]) -> bool:
    for v in qset.validators:
        if not proc(node_key(v)):
            return False
    for inner in qset.innerSets:
        if not for_all_nodes(inner, proc):
            return False
    return True


def get_node_weight(node_raw: bytes, qset: SCPQuorumSet) -> int:
    """Probability weight of a node: product along its qset path of
    threshold/total, scaled to 2^64-1 with round-up big-division
    (reference: LocalNode::getNodeWeight + computeWeight)."""
    n = qset.threshold
    d = len(qset.innerSets) + len(qset.validators)
    for v in qset.validators:
        if node_key(v) == node_raw:
            return _compute_weight(2**64 - 1, d, n)
    for inner in qset.innerSets:
        leaf_w = get_node_weight(node_raw, inner)
        if leaf_w:
            return _compute_weight(leaf_w, d, n)
    return 0


def _compute_weight(m: int, total: int, threshold: int) -> int:
    # bigDivide(m, threshold, total, ROUND_UP), saturating at 2^64-1
    return min((m * threshold + total - 1) // total, 2**64 - 1)


def is_quorum_slice(qset: SCPQuorumSet, node_set: Set[bytes]) -> bool:
    threshold_left = qset.threshold
    for v in qset.validators:
        if node_key(v) in node_set:
            threshold_left -= 1
            if threshold_left <= 0:
                return True
    for inner in qset.innerSets:
        if is_quorum_slice(inner, node_set):
            threshold_left -= 1
            if threshold_left <= 0:
                return True
    return False


def is_v_blocking(qset: SCPQuorumSet, node_set: Set[bytes]) -> bool:
    if qset.threshold == 0:
        return False  # no v-blocking set for the empty requirement
    left_till_block = (1 + len(qset.validators) + len(qset.innerSets)
                       ) - qset.threshold
    for v in qset.validators:
        if node_key(v) in node_set:
            left_till_block -= 1
            if left_till_block <= 0:
                return True
    for inner in qset.innerSets:
        if is_v_blocking(inner, node_set):
            left_till_block -= 1
            if left_till_block <= 0:
                return True
    return False


def is_v_blocking_filter(qset: SCPQuorumSet, envs: Dict[bytes, object],
                         stmt_filter: Callable[[SCPStatement], bool]) -> bool:
    nodes = {nid for nid, env in envs.items()
             if stmt_filter(env.statement)}
    return is_v_blocking(qset, nodes)


def is_quorum(qset: SCPQuorumSet, envs: Dict[bytes, object],
              qfun: Callable[[SCPStatement], Optional[SCPQuorumSet]],
              stmt_filter: Callable[[SCPStatement], bool]) -> bool:
    """Transitive quorum check (reference: LocalNode::isQuorum)."""
    p_nodes = {nid for nid, env in envs.items()
               if stmt_filter(env.statement)}
    while True:
        count = len(p_nodes)

        def quorum_filter(nid: bytes) -> bool:
            node_qset = qfun(envs[nid].statement)
            if node_qset is None:
                return False
            return is_quorum_slice(node_qset, p_nodes)

        p_nodes = {nid for nid in p_nodes if quorum_filter(nid)}
        if count == len(p_nodes):
            break
    return is_quorum_slice(qset, p_nodes)


def find_closest_v_blocking(qset: SCPQuorumSet, nodes: Set[bytes],
                            excluded: Optional[bytes] = None) -> Set[bytes]:
    """Smallest subset of `nodes` that is v-blocking for qset; empty set
    if impossible (reference: LocalNode::findClosestVBlocking). Used by
    the herder to decide who to nag for fresh statements."""
    threshold_left = qset.threshold
    leaf_candidates: list = []   # individual validators present
    inner_results: list = []     # per-inner-set candidate subsets
    for v in qset.validators:
        vk = node_key(v)
        if excluded is None or vk != excluded:
            if vk in nodes:
                leaf_candidates.append({vk})
            else:
                threshold_left -= 1
    for inner in qset.innerSets:
        sub = find_closest_v_blocking(inner, nodes, excluded)
        if sub:
            inner_results.append(sub)
        else:
            threshold_left -= 1
    if threshold_left <= 0:
        return set()  # already blocked without taking anyone
    # need to pick (entries - threshold + 1) hits; take the cheapest
    candidates = sorted(leaf_candidates + inner_results, key=len)
    need = (len(leaf_candidates) + len(inner_results)) - threshold_left + 1
    out: Set[bytes] = set()
    if need < 0 or need > len(candidates):
        # cannot block: union everything we have (reference returns all)
        for c in candidates:
            out |= c
        return out
    for c in candidates[:need]:
        out |= c
    return out


class LocalNode:
    """This node's identity + quorum set (reference: scp/LocalNode.h)."""

    def __init__(self, node_id_raw: bytes, is_validator: bool,
                 qset: SCPQuorumSet):
        self.node_id = node_id_raw
        self.is_validator = is_validator
        self.set_quorum_set(qset)

    def set_quorum_set(self, qset: SCPQuorumSet) -> None:
        self.qset = qset
        self.qset_hash = qset_hash(qset)

    def get_quorum_set(self) -> SCPQuorumSet:
        return self.qset
