"""Pending-transaction queue.

Reference: src/herder/TransactionQueue.{h,cpp} — the pool of candidate txs
between submission and inclusion. Lifecycle (TransactionQueue.h:35-59):
`try_add` admits after full validation; `shift` runs at every ledger close,
ageing every queued tx and banning sources whose txs sat for `pending_depth`
ledgers; banned hashes stay banned for `ban_depth` ledgers; `remove_applied`
drops included txs.

Capacity is op-counted: `pool_ledger_multiplier × maxTxSetSize`; when full,
the lowest-fee-rate tx is evicted (and banned) to make room for a
better-paying one (reference: TxQueueLimiter).
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, List, Optional

from ..util.logging import get_logger
from .surge_pricing import fee_rate_cmp

log = get_logger("Herder")

# reference: TransactionQueue ctor args in HerderImpl.cpp
DEFAULT_PENDING_DEPTH = 4
DEFAULT_BAN_DEPTH = 10
DEFAULT_POOL_LEDGER_MULTIPLIER = 2
# fee-bump replacement must pay >= 10x the fee rate of what it replaces
# (reference: FEE_MULTIPLIER in TransactionQueue.cpp)
FEE_MULTIPLIER = 10


class AddResult(Enum):
    ADD_STATUS_PENDING = 0
    ADD_STATUS_DUPLICATE = 1
    ADD_STATUS_ERROR = 2
    ADD_STATUS_TRY_AGAIN_LATER = 3
    ADD_STATUS_FILTERED = 4


class _QueuedTx:
    __slots__ = ("tx", "age", "ops", "fee")

    def __init__(self, tx):
        self.tx = tx
        self.age = 0
        # cached for the eviction scan (avoids re-deriving per compare)
        self.ops = max(1, tx.num_operations())
        self.fee = tx.inclusion_fee()


class TransactionQueue:
    def __init__(self, pending_depth: int = DEFAULT_PENDING_DEPTH,
                 ban_depth: int = DEFAULT_BAN_DEPTH,
                 pool_ledger_multiplier: int = DEFAULT_POOL_LEDGER_MULTIPLIER,
                 metrics=None, limit_source_account: bool = False):
        self.pending_depth = pending_depth
        self.ban_depth = ban_depth
        self.pool_ledger_multiplier = pool_ledger_multiplier
        # at most one queued tx per source account (reference:
        # LIMIT_TX_QUEUE_SOURCE_ACCOUNT) — replace-by-fee still allowed
        self.limit_source_account = limit_source_account
        self._by_account: Dict[bytes, List[_QueuedTx]] = {}
        self._by_hash: Dict[bytes, _QueuedTx] = {}
        # ban generations: index 0 = banned this ledger
        self._banned: List[set] = [set() for _ in range(ban_depth)]
        self._total_ops = 0     # incremental size_ops (O(1) admission)
        self._metrics = metrics
        if metrics is not None:
            self._size_gauge = metrics.counter("herder", "pending-txs", "sum")
        else:
            self._size_gauge = None

    # ------------------------------------------------------------- queries --
    def size_ops(self) -> int:
        return self._total_ops

    def size_txs(self) -> int:
        return len(self._by_hash)

    def is_banned(self, tx_hash: bytes) -> bool:
        return any(tx_hash in gen for gen in self._banned)

    def is_pending(self, tx_hash: bytes) -> bool:
        """Already queued? (what try_add reports as DUPLICATE — the
        flood-admission path asks first to skip signature work for
        redundant deliveries)"""
        return tx_hash in self._by_hash

    def get_tx(self, tx_hash: bytes):
        """Queued tx by hash, or None (reference: getTx)."""
        q = self._by_hash.get(tx_hash)
        return q.tx if q is not None else None

    def get_transactions(self) -> List[object]:
        """All queued txs, candidates for the next tx set (reference:
        getTransactions)."""
        return [q.tx for q in self._by_hash.values()]

    # ----------------------------------------------------------- admission --
    def try_add(self, tx, ltx_root, max_queue_ops: int,
                verify=None) -> AddResult:
        """Admit a tx after validation (reference: TransactionQueue::tryAdd
        → canAdd → TransactionFrame::checkValid)."""
        h = tx.full_hash()
        if self.is_banned(h):
            return AddResult.ADD_STATUS_TRY_AGAIN_LATER
        if h in self._by_hash:
            return AddResult.ADD_STATUS_DUPLICATE
        acct = tx.source_id.to_bytes()
        chain = self._by_account.get(acct, [])
        replacing: Optional[_QueuedTx] = None
        for q in chain:
            if q.tx.seq_num == tx.seq_num:
                # replace-by-fee: must bid >= FEE_MULTIPLIER x the old rate
                old = q.tx
                if fee_rate_cmp(tx.inclusion_fee(),
                                max(1, tx.num_operations()),
                                FEE_MULTIPLIER * old.inclusion_fee(),
                                max(1, old.num_operations())) < 0:
                    return AddResult.ADD_STATUS_ERROR
                replacing = q
                break
        if self.limit_source_account and chain and replacing is None:
            return AddResult.ADD_STATUS_TRY_AGAIN_LATER
        # full validation against current ledger state; chained txs from
        # the same account validate with predecessors' seqnums consumed
        from ..ledger.ledger_txn import LedgerTxn
        from ..tx.signature_checker import default_verify
        verify = verify or default_verify
        with LedgerTxn(ltx_root) as ltx:
            for q in chain:
                if q.tx.seq_num < tx.seq_num and q is not replacing:
                    q.tx._process_seq_num(ltx)
            ok = tx.check_valid(ltx, verify=verify)
            ltx.rollback()
        if not ok:
            return AddResult.ADD_STATUS_ERROR
        # capacity: the replaced tx's ops are already freed (it can't be
        # picked for eviction and doesn't count against the limit), but it
        # is only dropped once admission is certain
        new_ops = max(1, tx.num_operations())
        freed = replacing.ops if replacing else 0
        need = self.size_ops() - freed + new_ops - max_queue_ops
        if need > 0:
            # two-phase eviction (reference: TxQueueLimiter::canAddTx
            # evaluates the whole eviction set before dropping anything):
            # nothing is evicted or banned unless the newcomer actually
            # gets admitted
            import functools
            candidates = sorted(
                (q for q in self._by_hash.values() if q is not replacing),
                key=functools.cmp_to_key(
                    lambda a, b: fee_rate_cmp(a.fee, a.ops, b.fee, b.ops)))
            evict = []
            for q in candidates:
                if need <= 0:
                    break
                if fee_rate_cmp(tx.inclusion_fee(), new_ops,
                                q.fee, q.ops) <= 0:
                    return AddResult.ADD_STATUS_TRY_AGAIN_LATER
                evict.append(q)
                need -= q.ops
            if need > 0:
                return AddResult.ADD_STATUS_TRY_AGAIN_LATER
            for q in evict:
                self._drop(q, ban=True)
        if replacing is not None:
            self._drop(replacing, ban=True)
        q = _QueuedTx(tx)
        self._by_hash[h] = q
        self._total_ops += q.ops
        self._by_account.setdefault(acct, []).append(q)
        self._by_account[acct].sort(key=lambda e: e.tx.seq_num)
        self._update_size_gauge()
        return AddResult.ADD_STATUS_PENDING

    def _drop(self, q: _QueuedTx, ban: bool) -> None:
        h = q.tx.full_hash()
        if self._by_hash.pop(h, None) is not None:
            self._total_ops -= q.ops
        acct = q.tx.source_id.to_bytes()
        chain = self._by_account.get(acct)
        if chain is not None:
            self._by_account[acct] = [e for e in chain if e is not q]
            if not self._by_account[acct]:
                del self._by_account[acct]
        if ban:
            self._banned[0].add(h)
        self._update_size_gauge()

    def _update_size_gauge(self) -> None:
        if self._size_gauge is not None:
            self._size_gauge.set_count(len(self._by_hash))

    # ------------------------------------------------------------ lifecycle --
    def remove_applied(self, txs) -> None:
        """Drop txs included in a closed ledger; also drop queued txs made
        invalid by consumed seqnums (reference: removeApplied)."""
        applied_hashes = {t.full_hash() for t in txs}
        max_seq_by_acct: Dict[bytes, int] = {}
        for t in txs:
            a = t.source_id.to_bytes()
            max_seq_by_acct[a] = max(max_seq_by_acct.get(a, 0), t.seq_num)
        for h in list(self._by_hash):
            q = self._by_hash.get(h)
            if q is None:
                continue
            if h in applied_hashes:
                self._drop(q, ban=False)
                continue
            a = q.tx.source_id.to_bytes()
            if a in max_seq_by_acct and q.tx.seq_num <= max_seq_by_acct[a]:
                self._drop(q, ban=False)

    def ban(self, txs) -> None:
        for t in txs:
            h = t.full_hash()
            self._banned[0].add(h)
            q = self._by_hash.get(h)
            if q is not None:
                self._drop(q, ban=False)

    def shift(self) -> None:
        """Per-ledger-close ageing (reference: TransactionQueue::shift):
        rotate ban generations, age queued txs, ban the too-old."""
        self._banned.pop()
        self._banned.insert(0, set())
        to_ban = []
        for q in self._by_hash.values():
            q.age += 1
            if q.age >= self.pending_depth:
                to_ban.append(q)
        for q in to_ban:
            self._drop(q, ban=True)
            log.debug("banned aged-out tx %s", q.tx.full_hash().hex()[:16])
