"""Quorum intersection analysis.

Reference: src/herder/QuorumIntersectionChecker.{h,cpp} — decides
whether every pair of quorums of the known network overlaps, and if not
produces a disjoint quorum pair as the counterexample.

Same algorithm family as the reference's MinQuorumEnumerator
(QuorumIntersectionCheckerImpl.cpp:60-260): a branch-and-bound search
over (committed, remaining) node splits restricted to one strongly
connected component of the dependency graph, with the reference's early
exits —

  1. |committed| > |SCC|/2: other branches will find the min-quorum
     inside the complement instead;
  2. the perimeter holds no quorum extending `committed`;
  3. `committed` contracts to a quorum: terminal — if minimal, check
     its SCC-complement for a disjoint quorum.

Differences from the reference (deliberate): node sets are Python int
bitmasks (arbitrary-width, popcount via int.bit_count) instead of a
custom BitSet, and the split-node heuristic (max in-degree within the
remaining perimeter) breaks ties deterministically instead of by
coin-flip, so analyses are reproducible across runs.

Interruptibility matches the reference: set `interrupt_flag` from any
thread (or pass max_calls) and the search raises QICInterrupted.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..scp import local_node as ln
from ..xdr.scp import SCPQuorumSet
from ..xdr.types import PublicKey


class QICInterrupted(Exception):
    """Search interrupted (reference: InterruptedException)."""


class _QBitSet:
    """One quorum set compiled to index space: threshold over a
    validator mask + inner sets."""

    __slots__ = ("threshold", "vmask", "inner")

    def __init__(self, threshold: int, vmask: int,
                 inner: List["_QBitSet"]):
        self.threshold = threshold
        self.vmask = vmask
        self.inner = inner

    def satisfied_by(self, mask: int) -> bool:
        need = self.threshold - (self.vmask & mask).bit_count()
        if need <= 0:
            return True
        for q in self.inner:
            if q.satisfied_by(mask):
                need -= 1
                if need <= 0:
                    return True
        return False

    def successors(self) -> int:
        m = self.vmask
        for q in self.inner:
            m |= q.successors()
        return m


def _collapse_organizations(qmap: Dict[bytes, SCPQuorumSet]):
    """Organization-level reduction (the fbas-analysis 'merge by org'
    preprocessing; the reference reaches the same scale through C++
    constants — BitSet + a ~10^9-call budget — which a Python checker
    replaces with this exact reduction):

    a group M of k validators is collapsible to one org-node when
      - all members publish the same quorum set, and
      - every appearance of any member, in every distinct qset, is a
        leaf subtree whose validators are exactly M (same threshold t
        everywhere, no inner sets), and
      - 2t > k (two disjoint sets can never both activate the org).

    Then disjoint quorums exist in the full graph iff they exist in the
    collapsed graph (org active in a quorum ⟺ ≥t members present; 2t>k
    forces each org onto one side).  Crucially the collapsed quorums are
    SMALL relative to the collapsed SCC, so the half-SCC bound prunes.
    Returns (new_qmap, expansion) where expansion maps synthetic org ids
    to (members_tuple, t); empty expansion = nothing collapsed."""
    from ..crypto.sha import sha256

    uniq: Dict[bytes, SCPQuorumSet] = {}
    for qs in qmap.values():
        uniq.setdefault(qs.to_bytes(), qs)

    # every appearance context of each node: "leaf:<members,thr>" or a
    # disqualifying marker
    appearances: Dict[bytes, set] = {}

    def walk(qs: SCPQuorumSet):
        vkeys = tuple(sorted(ln.node_key(v) for v in qs.validators))
        is_leaf = not qs.innerSets
        for vk in vkeys:
            if is_leaf:
                appearances.setdefault(vk, set()).add(
                    ("leaf", vkeys, qs.threshold))
            else:
                appearances.setdefault(vk, set()).add(("mixed",))
        for s in qs.innerSets:
            walk(s)

    for qs in uniq.values():
        walk(qs)

    # candidate classes: group by own-qset bytes + the single leaf shape
    groups: Dict[tuple, list] = {}
    for nid, qs in qmap.items():
        ctx = appearances.get(nid, set())
        if len(ctx) != 1:
            continue
        (tag, *rest) = next(iter(ctx))
        if tag != "leaf":
            continue
        members, thr = rest
        if set(members) - set(qmap):
            continue                 # leaf mixes in unknown nodes
        groups.setdefault((members, thr, qs.to_bytes()), []).append(nid)

    collapses: Dict[tuple, tuple] = {}   # members -> (org_id, thr)
    expansion: Dict[bytes, tuple] = {}
    for (members, thr, _qb), nids in groups.items():
        k = len(members)
        if k < 2 or sorted(nids) != list(members):
            continue                 # not the whole leaf, or singleton
        if 2 * thr <= k:
            continue                 # an org two sides could share
        org_id = sha256(b"org:" + b"".join(members))
        collapses[members] = (org_id, thr)
        expansion[org_id] = (members, thr)
    if not collapses:
        return qmap, {}

    def rewrite(qs: SCPQuorumSet) -> SCPQuorumSet:
        vkeys = tuple(sorted(ln.node_key(v) for v in qs.validators))
        if not qs.innerSets and vkeys in collapses:
            org_id, _thr = collapses[vkeys]
            return SCPQuorumSet(
                threshold=1,
                validators=[PublicKey.ed25519(org_id)], innerSets=[])
        return SCPQuorumSet(
            threshold=qs.threshold,
            validators=list(qs.validators),
            innerSets=[rewrite(s) for s in qs.innerSets])

    collapsed_members = {m for ms in collapses for m in ms}
    new_qmap: Dict[bytes, SCPQuorumSet] = {}
    for nid, qs in qmap.items():
        if nid in collapsed_members:
            continue
        new_qmap[nid] = rewrite(qs)
    for members, (org_id, _thr) in collapses.items():
        new_qmap[org_id] = rewrite(qmap[members[0]])
    return new_qmap, expansion


class QuorumIntersectionChecker:
    """Drop-in API: construct with {node id bytes: SCPQuorumSet}, call
    network_enjoys_quorum_intersection(); potential_split holds the
    counterexample pair when it returns False."""

    def __init__(self, qmap: Dict[bytes, SCPQuorumSet],
                 interrupt_flag: Optional[list] = None,
                 max_calls: int = 0, max_seconds: float = 0.0,
                 _collapse: bool = True):
        self._expansion: Dict[bytes, tuple] = {}
        if _collapse and qmap:
            qmap2, expansion = _collapse_organizations(qmap)
            if expansion:
                qmap = qmap2
                self._expansion = expansion
        self.qmap = qmap
        self.nodes = sorted(qmap)
        self._idx = {n: i for i, n in enumerate(self.nodes)}
        # nodes sharing a quorum set (the pubnet norm: org members and
        # often whole tiers publish identical qsets) share ONE compiled
        # _QBitSet, letting contraction evaluate it once per pass
        self._compile_cache: Dict[bytes, _QBitSet] = {}
        self._qsets: List[Optional[_QBitSet]] = []
        for n in self.nodes:
            qs = qmap[n]
            key = qs.to_bytes()
            q = self._compile_cache.get(key)
            if q is None:
                q = self._compile_cache[key] = self._compile(qs)
            self._qsets.append(q)
        self._succ: List[int] = [
            (q.successors() if q is not None else 0) | (1 << i)
            for i, q in enumerate(self._qsets)]
        self._siblings: List[int] = self._sibling_classes()
        self.potential_split: Optional[Tuple[set, set]] = None
        # cooperative interruption: a one-element list so callers can
        # flip it from another thread; max_calls bounds the search size
        self.interrupt_flag = interrupt_flag if interrupt_flag is not None \
            else [False]
        self.max_calls = max_calls
        self.max_seconds = max_seconds
        self._deadline = 0.0
        self.calls = 0

    # ------------------------------------------------------------ compile --
    def _compile(self, qset: SCPQuorumSet) -> _QBitSet:
        vmask = 0
        for v in qset.validators:
            i = self._idx.get(ln.node_key(v))
            if i is not None:
                vmask |= 1 << i
        inner = [self._compile(q) for q in qset.innerSets]
        return _QBitSet(qset.threshold, vmask, inner)

    def _sibling_classes(self) -> List[int]:
        """For each node, the bitmask of nodes interchangeable with it:
        the transposition swapping the two nodes is verified to be an
        automorphism of the whole configuration (every distinct quorum
        set maps to itself as a structural multiset, and both nodes
        publish the same qset — transpositions compose, so the relation
        is an equivalence).  Used for sound symmetry pruning: in the
        branch that EXCLUDES a node, its unexplored siblings may be
        excluded too, since any solution using a sibling maps to one
        using the node itself, which the include-branch explores.
        (Orbit symmetry; after org collapse this typically groups the
        whole symmetric top tier.)"""
        n = len(self.nodes)
        uniq = list({id(q): q for q in self._qsets if q is not None
                     }.values())

        def canon(q: _QBitSet, bi: int, bj: int):
            """Structural key of σ(q) where σ swaps bits bi/bj
            (bi == bj == 0 → identity)."""
            vm = q.vmask
            if bi:
                t = (bj if vm & bi else 0) | (bi if vm & bj else 0)
                vm = (vm & ~(bi | bj)) | t
            return (q.threshold, vm,
                    tuple(sorted(canon(s, bi, bj) for s in q.inner)))

        ident = {id(q): canon(q, 0, 0) for q in uniq}

        def swappable(i: int, j: int) -> bool:
            if self._qsets[i] is not self._qsets[j]:
                return False
            bi, bj = 1 << i, 1 << j
            return all(canon(q, bi, bj) == ident[id(q)] for q in uniq)

        # group candidates by shared qset object, then verify pairwise
        # against a class representative (transpositions compose, so one
        # representative check suffices per class)
        by_qset: Dict[int, List[int]] = {}
        for i, q in enumerate(self._qsets):
            by_qset.setdefault(id(q), []).append(i)
        masks = [1 << i for i in range(n)]
        for members in by_qset.values():
            classes: List[List[int]] = []
            for i in members:
                for cls in classes:
                    if swappable(cls[0], i):
                        cls.append(i)
                        break
                else:
                    classes.append([i])
            for cls in classes:
                m = 0
                for i in cls:
                    m |= 1 << i
                for i in cls:
                    masks[i] = m
        return masks

    # ----------------------------------------------------------- quorum ops --
    def _is_slice_sat(self, i: int, mask: int) -> bool:
        q = self._qsets[i]
        return q is not None and q.satisfied_by(mask)

    def _contract(self, mask: int) -> int:
        """Maximal quorum inside mask (reference:
        contractToMaximalQuorum): fixpoint-drop members whose slice
        requirement fails within the set.  Nodes sharing a compiled
        qset are evaluated once per pass."""
        qsets = self._qsets
        while mask:
            keep = 0
            cache: Dict[int, bool] = {}
            m = mask
            while m:
                low = m & -m
                q = qsets[low.bit_length() - 1]
                if q is not None:
                    qid = id(q)
                    s = cache.get(qid)
                    if s is None:
                        s = cache[qid] = q.satisfied_by(mask)
                    if s:
                        keep |= low
                m ^= low
            if keep == mask:
                return mask
            mask = keep
        return 0

    def _is_minimal_quorum(self, mask: int) -> bool:
        """mask is a quorum none of whose single-node removals still
        contains a quorum (reference: isMinimalQuorum)."""
        m = mask
        while m:
            low = m & -m
            if self._contract(mask ^ low):
                return False
            m ^= low
        return True

    def _mask_to_set(self, mask: int) -> set:
        """Counterexample sets expand collapsed org-nodes back to t
        concrete members (any t suffice to activate the org)."""
        out = set()
        for i in range(len(self.nodes)):
            if not mask >> i & 1:
                continue
            nid = self.nodes[i]
            exp = self._expansion.get(nid)
            if exp is None:
                out.add(nid)
            else:
                members, t = exp
                out.update(members[:t])
        return out

    # -------------------------------------------------------------- search --
    def network_enjoys_quorum_intersection(self) -> bool:
        """True iff all quorums pairwise intersect (reference:
        networkEnjoysQuorumIntersection): split the graph into SCCs, fail
        fast if two SCCs each hold a quorum, then run the enumerator on
        the (single) quorum-bearing SCC."""
        n = len(self.nodes)
        if n == 0:
            return True
        if self.max_seconds:
            import time
            self._deadline = time.monotonic() + self.max_seconds
        sccs = self._tarjan_sccs()
        quorum_sccs = []
        for scc in sccs:
            q = self._contract(scc)
            if q:
                quorum_sccs.append((scc, q))
        if not quorum_sccs:
            return True
        if len(quorum_sccs) > 1:
            # two node-disjoint SCCs each containing a quorum: split
            self.potential_split = (
                self._mask_to_set(quorum_sccs[0][1]),
                self._mask_to_set(quorum_sccs[1][1]))
            return False
        scan_scc = quorum_sccs[0][0]
        return not self._any_min_quorum_has_disjoint_quorum(
            0, scan_scc, scan_scc)

    def _any_min_quorum_has_disjoint_quorum(self, committed: int,
                                            remaining: int,
                                            scan_scc: int) -> bool:
        """reference: MinQuorumEnumerator::anyMinQuorumHasDisjointQuorum
        (iterative deepening done by explicit recursion; the branch
        excluding the split node runs first, exactly as the reference)."""
        self.calls += 1
        if self.interrupt_flag[0] or \
                (self.max_calls and self.calls > self.max_calls):
            raise QICInterrupted(
                f"quorum intersection search interrupted after "
                f"{self.calls} calls")
        if self._deadline and not self.calls & 0x3FF:
            import time
            if time.monotonic() > self._deadline:
                raise QICInterrupted(
                    f"quorum intersection search hit the "
                    f"{self.max_seconds}s time budget "
                    f"({self.calls} calls)")

        # early exit 1: committed beyond half the SCC
        if committed.bit_count() > scan_scc.bit_count() // 2:
            return False

        # early exit 3: committed contracts to a quorum — terminal
        committed_quorum = self._contract(committed)
        if committed_quorum:
            if self._is_minimal_quorum(committed_quorum):
                disj = self._contract(scan_scc & ~committed_quorum)
                if disj:
                    self.potential_split = (
                        self._mask_to_set(committed_quorum),
                        self._mask_to_set(disj))
                    return True
            return False

        # early exit 2: no quorum in the perimeter extends committed
        perimeter = committed | remaining
        extension = self._contract(perimeter)
        if not extension or (committed & ~extension):
            return False

        if not remaining:
            return False

        split = self._pick_split_node(remaining)
        # symmetry pruning: excluding `split` also excludes its
        # interchangeable siblings (see _sibling_classes) — any solution
        # using a sibling is the automorphic image of one using `split`,
        # which the include-branch covers
        sibs = self._siblings[split] & remaining
        if self._any_min_quorum_has_disjoint_quorum(
                committed, remaining & ~sibs, scan_scc):
            return True
        return self._any_min_quorum_has_disjoint_quorum(
            committed | (1 << split), remaining ^ (1 << split), scan_scc)

    def _pick_split_node(self, remaining: int) -> int:
        """Max in-degree within the remaining set (reference:
        pickSplitNode), deterministic first-max tie-break."""
        indeg: Dict[int, int] = {}
        m = remaining
        while m:
            low = m & -m
            i = low.bit_length() - 1
            avail = self._succ[i] & remaining
            a = avail
            while a:
                al = a & -a
                j = al.bit_length() - 1
                indeg[j] = indeg.get(j, 0) + 1
                a ^= al
            m ^= low
        best = remaining.bit_length() - 1
        best_deg = -1
        for j in sorted(indeg):
            if indeg[j] > best_deg:
                best, best_deg = j, indeg[j]
        return best

    # ---------------------------------------------------------------- SCCs --
    def _tarjan_sccs(self) -> List[int]:
        """Tarjan's SCCs over the successor graph, as bitmasks
        (reference: TarjanSCCCalculator.cpp); iterative to survive
        pubnet-sized graphs without hitting the recursion limit."""
        n = len(self.nodes)
        index = [-1] * n
        lowlink = [0] * n
        on_stack = [False] * n
        stack: List[int] = []
        sccs: List[int] = []
        counter = [0]

        for root in range(n):
            if index[root] != -1:
                continue
            work = [(root, 0)]
            while work:
                v, pi = work[-1]
                if pi == 0:
                    index[v] = lowlink[v] = counter[0]
                    counter[0] += 1
                    stack.append(v)
                    on_stack[v] = True
                recurse = False
                succ = self._succ[v]
                # iterate successor indices starting at pi
                m = succ >> pi
                w = pi
                while m:
                    if m & 1:
                        if index[w] == -1:
                            work[-1] = (v, w + 1)
                            work.append((w, 0))
                            recurse = True
                            break
                        if on_stack[w]:
                            lowlink[v] = min(lowlink[v], index[w])
                    m >>= 1
                    w += 1
                if recurse:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    lowlink[parent] = min(lowlink[parent], lowlink[v])
                if lowlink[v] == index[v]:
                    mask = 0
                    while True:
                        u = stack.pop()
                        on_stack[u] = False
                        mask |= 1 << u
                        if u == v:
                            break
                    sccs.append(mask)
        return sccs
