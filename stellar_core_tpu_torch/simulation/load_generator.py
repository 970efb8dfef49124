"""Synthetic transaction load.

Reference: src/simulation/LoadGenerator.{h,cpp} — modes CREATE / PAY /
PRETEND / MIXED_CLASSIC (payments + DEX offers) / SOROBAN upload
(LoadGenerator.h:28-35): synthesize accounts from the network root, then
rate-controlled transactions among them, submitted through the herder like
any external transaction; completion is tracked against ledger closes.
SOROBAN mode synthesizes random upload-wasm transactions sized against the
live SorobanNetworkConfig limits (LoadGenerator.cpp:469-494).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ..crypto.keys import SecretKey
from ..crypto.sha import sha256
from ..herder.tx_queue import AddResult
from ..ledger.ledger_txn import LedgerTxn
from ..tx.frame import make_frame
from ..tx.tx_utils import starting_sequence_number
from ..util.checks import releaseAssert
from ..util.logging import get_logger
from ..xdr.ledger_entries import LedgerKey
from ..xdr.transaction import (Memo, MemoType, MuxedAccount, Operation,
                               Preconditions, PreconditionType, Transaction,
                               TransactionEnvelope, TransactionV1Envelope,
                               _TxExt, DecoratedSignature, _OperationBody,
                               CreateAccountOp, PaymentOp)
from ..xdr.types import EnvelopeType, PublicKey
from ..xdr.transaction import OperationType
from ..xdr.ledger_entries import Asset, AssetType

log = get_logger("LoadGen")


class GeneratedAccount:
    def __init__(self, key: SecretKey, seq: int):
        self.key = key
        self.seq = seq

    @property
    def account_id(self) -> PublicKey:
        return PublicKey.ed25519(self.key.public_key().raw)

    @property
    def muxed(self) -> MuxedAccount:
        return MuxedAccount.from_ed25519(self.key.public_key().raw)


class LoadGenerator:
    def __init__(self, app, seed: Optional[int] = None):
        self.app = app
        self.network_id = app.config.network_id()
        self.accounts: List[GeneratedAccount] = []
        self.submitted = 0
        self.failed = 0
        root_key = SecretKey.from_seed(self.network_id)
        self.root = GeneratedAccount(root_key, self._live_seq(root_key))
        # per-node-id seeded RNG (the decorrelated-jitter pattern:
        # config.jitter_seed() is stable for one node and decorrelated
        # across nodes), so multi-node load is reproducible under a
        # fixed scenario seed yet no two nodes pick the same pattern;
        # an explicit `seed` pins the traffic shape regardless of node
        # identity (cross-app differential tests)
        self._rng = random.Random(app.config.jitter_seed()
                                  if seed is None else seed)
        self._perm: List[int] = []

    def _account_order(self) -> List[int]:
        """Seeded permutation of account indices, rebuilt when the
        account set grows: random-LOOKING traffic shape that is a
        deterministic function of the node id (never a per-tx random
        draw — that would skew the per-source spread and overflow the
        queue's pending depth)."""
        if len(self._perm) != len(self.accounts):
            self._perm = list(range(len(self.accounts)))
            self._rng.shuffle(self._perm)
        return self._perm

    def _live_seq(self, key: SecretKey) -> int:
        with LedgerTxn(self.app.ledger_manager.root) as ltx:
            le = ltx.load_without_record(LedgerKey.account(
                PublicKey.ed25519(key.public_key().raw)))
            return le.data.value.seqNum if le else 0

    # ------------------------------------------------------------ building --
    def _sign_and_submit(self, source: GeneratedAccount,
                         ops: List[Operation], fee: Optional[int] = None,
                         ext=None) -> AddResult:
        source.seq += 1
        tx = Transaction(
            sourceAccount=source.muxed,
            fee=fee if fee is not None else 100 * max(1, len(ops)),
            seqNum=source.seq,
            cond=Preconditions(PreconditionType.PRECOND_NONE),
            memo=Memo(MemoType.MEMO_NONE), operations=ops,
            ext=ext if ext is not None else _TxExt(0))
        env = TransactionEnvelope(
            EnvelopeType.ENVELOPE_TYPE_TX,
            TransactionV1Envelope(tx=tx, signatures=[]))
        frame = make_frame(env, self.network_id)
        sig = source.key.sign(frame.contents_hash())
        frame.signatures.append(DecoratedSignature(
            hint=source.key.public_key().hint(), signature=sig))
        env.value.signatures = frame.signatures
        res = self.app.herder.recv_transaction(frame)
        self.submitted += 1
        if res != AddResult.ADD_STATUS_PENDING:
            self.failed += 1
            source.seq -= 1
        return res

    # --------------------------------------------------------------- modes --
    def generate_accounts(self, n: int,
                          balance: int = 10_000_0000000) -> int:
        """CREATE mode: fan accounts out of the root (reference:
        LoadGenerator::createAccounts)."""
        created = 0
        batch: List[Operation] = []
        new_accounts: List[GeneratedAccount] = []
        # snapshot the numbering base: self.accounts grows batch-by-batch
        # inside this loop, so indexing off its live length would hand out
        # the same derivation index twice across calls
        base = len(self.accounts)
        for i in range(n):
            key = SecretKey.from_seed(sha256(
                b"loadgen-%d-%d" % (base + i,
                                    self.app.config.PEER_PORT)))
            new_accounts.append(GeneratedAccount(key, 0))
            batch.append(Operation(
                sourceAccount=None,
                body=_OperationBody(
                    OperationType.CREATE_ACCOUNT,
                    CreateAccountOp(
                        destination=PublicKey.ed25519(
                            key.public_key().raw),
                        startingBalance=balance))))
            if len(batch) == 100 or i == n - 1:
                if self._sign_and_submit(self.root, batch) == \
                        AddResult.ADD_STATUS_PENDING:
                    created += len(batch)
                    self.accounts.extend(new_accounts)
                batch, new_accounts = [], []
        return created

    def sync_account_seqs(self) -> None:
        """After a close, learn created accounts' live seqnums."""
        for acct in self.accounts:
            if acct.seq == 0:
                acct.seq = self._live_seq(acct.key)

    def generate_payments(self, n: int, amount: int = 10000) -> int:
        """PAY mode: random-ish payments among generated accounts —
        source order follows the node-seeded permutation, so every node
        of a multi-node scenario drives a different (but reproducible)
        traffic shape."""
        assert len(self.accounts) >= 2, "run generate_accounts first"
        order = self._account_order()
        ok = 0
        for i in range(n):
            src = self.accounts[order[i % len(order)]]
            dst = self.accounts[order[(i + 1) % len(order)]]
            if self._sign_and_submit(src, [self._payment_op(dst, amount)]) \
                    == AddResult.ADD_STATUS_PENDING:
                ok += 1
        return ok

    def generate_payments_zipf(self, n: int, amount: int = 10000,
                               exponent: float = 1.0) -> int:
        """PAY mode with Zipfian hot accounts: source and destination
        are drawn rank-weighted (rank r gets weight 1/r^exponent) over
        the node-seeded permutation, so a handful of accounts carry
        most of the traffic — the adversarial cell for conflict-staged
        apply, where clustering must degrade gracefully toward
        sequential. Draws come from the same seeded RNG as every other
        mode (config.jitter_seed() discipline): reproducible per node,
        decorrelated across nodes."""
        import bisect
        assert len(self.accounts) >= 2, "run generate_accounts first"
        order = self._account_order()
        cum: List[float] = []
        tot = 0.0
        for r in range(1, len(order) + 1):
            tot += 1.0 / (r ** exponent)
            cum.append(tot)
        ok = 0
        for _ in range(n):
            si = bisect.bisect_left(cum, self._rng.random() * tot)
            di = si
            while di == si:
                di = bisect.bisect_left(cum, self._rng.random() * tot)
            src = self.accounts[order[min(si, len(order) - 1)]]
            dst = self.accounts[order[min(di, len(order) - 1)]]
            if self._sign_and_submit(src, [self._payment_op(dst, amount)]) \
                    == AddResult.ADD_STATUS_PENDING:
                ok += 1
        return ok

    def _payment_op(self, dst: GeneratedAccount, amount: int) -> Operation:
        return Operation(
            sourceAccount=None,
            body=_OperationBody(
                OperationType.PAYMENT,
                PaymentOp(destination=dst.muxed,
                          asset=Asset(AssetType.ASSET_TYPE_NATIVE),
                          amount=amount)))

    def generate_pretend(self, n: int, ops_per_tx: int = 3) -> int:
        """PRETEND mode: transactions that carry realistic weight but leave
        balances alone — SetOptions home-domain + ManageData padding ops
        (reference: LoadGenerator::pretendTransaction)."""
        from ..xdr.transaction import (ManageDataOp, SetOptionsOp,
                                       _OperationBody as OB)
        assert self.accounts, "run generate_accounts first"
        ok = 0
        for i in range(n):
            src = self.accounts[i % len(self.accounts)]
            ops: List[Operation] = []
            for j in range(max(1, ops_per_tx)):
                if j % 2 == 0:
                    body = OB(OperationType.SET_OPTIONS, SetOptionsOp(
                        inflationDest=None, clearFlags=None, setFlags=None,
                        masterWeight=None, lowThreshold=None,
                        medThreshold=None, highThreshold=None,
                        homeDomain=b"pretend-%02d.example.com" % (j % 100),
                        signer=None))
                else:
                    pad = sha256(b"pretend-%d-%d" % (i, j))
                    body = OB(OperationType.MANAGE_DATA, ManageDataOp(
                        dataName=b"load%02d" % j, dataValue=pad))
                ops.append(Operation(sourceAccount=None, body=body))
            if self._sign_and_submit(src, ops) == \
                    AddResult.ADD_STATUS_PENDING:
                ok += 1
        return ok

    # ------------------------------------------------------------- mixed --
    LOAD_ASSET_CODE = b"LOAD"

    def setup_dex(self) -> int:
        """Create the trustlines MIXED mode's offers trade against (each
        generated account trusts LOAD issued by the root)."""
        from ..xdr.transaction import ChangeTrustAsset, ChangeTrustOp
        from ..xdr.ledger_entries import AlphaNum4
        ok = 0
        line = ChangeTrustAsset(
            AssetType.ASSET_TYPE_CREDIT_ALPHANUM4,
            AlphaNum4(assetCode=self.LOAD_ASSET_CODE,
                      issuer=self.root.account_id))
        for acct in self.accounts:
            op = Operation(sourceAccount=None, body=_OperationBody(
                OperationType.CHANGE_TRUST,
                ChangeTrustOp(line=line, limit=2**62)))
            if self._sign_and_submit(acct, [op]) == \
                    AddResult.ADD_STATUS_PENDING:
                ok += 1
        return ok

    def generate_mixed(self, n: int, dex_percent: int = 50,
                       amount: int = 10000) -> int:
        """MIXED_CLASSIC mode: a blend of payments and DEX manage-offer
        transactions (reference: GENERATE_LOAD_MIXED_CLASSIC with
        DEX_TX_PERCENT). Offers all sell native for LOAD on the same book
        side, so they rest without crossing."""
        from ..xdr.transaction import ManageSellOfferOp
        from ..xdr.ledger_entries import Price
        assert len(self.accounts) >= 2, "run generate_accounts first"
        order = self._account_order()
        ok = 0
        buying = Asset.credit(self.LOAD_ASSET_CODE, self.root.account_id)
        for i in range(n):
            src = self.accounts[order[i % len(order)]]
            # Bresenham-style interleave so any n gets the requested blend
            if (i * dex_percent) % 100 < dex_percent:
                op = Operation(sourceAccount=None, body=_OperationBody(
                    OperationType.MANAGE_SELL_OFFER,
                    ManageSellOfferOp(
                        selling=Asset(AssetType.ASSET_TYPE_NATIVE),
                        buying=buying, amount=amount,
                        price=Price(n=100 + (i % 32), d=100),
                        offerID=0)))
            else:
                dst = self.accounts[order[(i + 1) % len(order)]]
                op = self._payment_op(dst, amount)
            if self._sign_and_submit(src, [op]) == \
                    AddResult.ADD_STATUS_PENDING:
                ok += 1
        return ok

    # ----------------------------------------------------------- soroban --
    def _soroban_ext(self, ro, rw, instructions=4_000_000,
                     read=50_000, write=50_000,
                     resource_fee=10_000_000):
        from ..xdr import contract as cx
        return _TxExt(1, cx.SorobanTransactionData(
            resources=cx.SorobanResources(
                footprint=cx.LedgerFootprint(readOnly=list(ro),
                                             readWrite=list(rw)),
                instructions=instructions, readBytes=read,
                writeBytes=write),
            resourceFee=resource_fee))

    def setup_sac(self) -> bytes:
        """Deploy the native-asset Stellar Asset Contract; returns its
        contract id (reference: the SOROBAN loadgen family invokes real
        host functions, LoadGenerator.cpp:469-494)."""
        from ..xdr import contract as cx
        from ..soroban.host import contract_id_from_preimage, instance_key
        preimage = cx.ContractIDPreimage(
            cx.ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ASSET,
            Asset(AssetType.ASSET_TYPE_NATIVE))
        cid = contract_id_from_preimage(self.network_id, preimage)
        addr = cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_CONTRACT,
                            cid)
        with LedgerTxn(self.app.ledger_manager.root) as ltx:
            if ltx.load_without_record(instance_key(addr)) is not None:
                return cid          # already deployed
        body = _OperationBody(
            OperationType.INVOKE_HOST_FUNCTION,
            cx.InvokeHostFunctionOp(hostFunction=cx.HostFunction(
                cx.HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT,
                cx.CreateContractArgs(
                    contractIDPreimage=preimage,
                    executable=cx.ContractExecutable(
                        cx.ContractExecutableType
                        .CONTRACT_EXECUTABLE_STELLAR_ASSET))), auth=[]))
        self._sign_and_submit(
            self.root, [Operation(sourceAccount=None, body=body)],
            fee=100 + 10_000_000,
            ext=self._soroban_ext([], [instance_key(addr)]))
        return cid

    def generate_sac_transfers(self, cid: bytes, n: int,
                               amount: int = 1000) -> int:
        """n native-SAC `transfer` invocations between generated
        accounts — the wasm-VM/SAC analogue of PAY mode."""
        from ..soroban import sac as sac_mod
        from ..soroban.host import instance_key
        from ..xdr import contract as cx
        assert self.accounts, "run generate_accounts first"
        addr = cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_CONTRACT,
                            cid)
        ok = 0
        for i in range(n):
            src = self.accounts[(self.submitted + i) % len(self.accounts)]
            dst = self.accounts[(self.submitted + i + 1)
                                % len(self.accounts)]
            src_addr = cx.SCAddress(
                cx.SCAddressType.SC_ADDRESS_TYPE_ACCOUNT, src.account_id)
            dst_addr = cx.SCAddress(
                cx.SCAddressType.SC_ADDRESS_TYPE_ACCOUNT, dst.account_id)
            args = [sac_mod._addr_scval(src_addr),
                    sac_mod._addr_scval(dst_addr),
                    sac_mod.sc_i128(amount)]
            invoke = cx.InvokeContractArgs(
                contractAddress=addr, functionName=b"transfer",
                args=list(args))
            auth = cx.SorobanAuthorizationEntry(
                credentials=cx.SorobanCredentials(
                    cx.SorobanCredentialsType
                    .SOROBAN_CREDENTIALS_SOURCE_ACCOUNT),
                rootInvocation=cx.SorobanAuthorizedInvocation(
                    function=cx.SorobanAuthorizedFunction(
                        cx.SorobanAuthorizedFunctionType
                        .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN,
                        invoke),
                    subInvocations=[]))
            body = _OperationBody(
                OperationType.INVOKE_HOST_FUNCTION,
                cx.InvokeHostFunctionOp(hostFunction=cx.HostFunction(
                    cx.HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT,
                    invoke), auth=[auth]))
            ro = [instance_key(addr)]
            rw = [LedgerKey.account(src.account_id),
                  LedgerKey.account(dst.account_id)]
            if self._sign_and_submit(
                    src, [Operation(sourceAccount=None, body=body)],
                    fee=100 + 10_000_000,
                    ext=self._soroban_ext(ro, rw)) == \
                    AddResult.ADD_STATUS_PENDING:
                ok += 1
        return ok

    def setup_counter_contract(self) -> bytes:
        """Upload + create the in-repo counter contract (wasm build);
        returns the contract id for generate_counter_invokes."""
        from ..soroban import scvm
        from ..soroban.scvm_wasm import make_wasm_code
        from ..soroban.host import contract_id_from_preimage, instance_key
        from ..xdr import contract as cx

        functions = {"increment": scvm.op(
            scvm.sym("put"), scvm.op(scvm.sym("lit"), scvm.sym("count")),
            scvm.op(scvm.sym("add"),
                    scvm.op(scvm.sym("if"),
                            scvm.op(scvm.sym("eq"),
                                    scvm.op(scvm.sym("get"),
                                            scvm.op(scvm.sym("lit"),
                                                    scvm.sym("count"))),
                                    cx.SCVal(cx.SCValType.SCV_VOID)),
                            scvm.u64(0),
                            scvm.op(scvm.sym("get"),
                                    scvm.op(scvm.sym("lit"),
                                            scvm.sym("count")))),
                    scvm.u64(1)))}
        code = make_wasm_code(functions)
        code_hash = sha256(code)
        code_key = LedgerKey.contract_code(code_hash)
        with LedgerTxn(self.app.ledger_manager.root) as ltx:
            have_code = ltx.load_without_record(code_key) is not None
        if not have_code:
            self._sign_and_submit(
                self.root, [Operation(sourceAccount=None,
                                      body=_OperationBody(
                    OperationType.INVOKE_HOST_FUNCTION,
                    cx.InvokeHostFunctionOp(
                        hostFunction=cx.HostFunction(
                            cx.HostFunctionType
                            .HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM,
                            code), auth=[])))],
                fee=100 + 10_000_000,
                ext=self._soroban_ext([], [code_key], write=100_000))
        preimage = cx.ContractIDPreimage(
            cx.ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ADDRESS,
            cx._ContractIDPreimageFromAddress(
                address=cx.SCAddress(
                    cx.SCAddressType.SC_ADDRESS_TYPE_ACCOUNT,
                    self.root.account_id),
                salt=sha256(b"loadgen-counter")))
        cid = contract_id_from_preimage(self.network_id, preimage)
        addr = cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_CONTRACT,
                            cid)
        create_args = cx.CreateContractArgs(
            contractIDPreimage=preimage,
            executable=cx.ContractExecutable(
                cx.ContractExecutableType.CONTRACT_EXECUTABLE_WASM,
                code_hash))
        with LedgerTxn(self.app.ledger_manager.root) as ltx:
            have_inst = ltx.load_without_record(
                instance_key(addr)) is not None
        if not have_inst:
            self._sign_and_submit(
                self.root, [Operation(sourceAccount=None,
                                      body=_OperationBody(
                    OperationType.INVOKE_HOST_FUNCTION,
                    cx.InvokeHostFunctionOp(
                        hostFunction=cx.HostFunction(
                            cx.HostFunctionType
                            .HOST_FUNCTION_TYPE_CREATE_CONTRACT,
                            create_args),
                        auth=[cx.SorobanAuthorizationEntry(
                            credentials=cx.SorobanCredentials(
                                cx.SorobanCredentialsType
                                .SOROBAN_CREDENTIALS_SOURCE_ACCOUNT),
                            rootInvocation=cx.SorobanAuthorizedInvocation(
                                function=cx.SorobanAuthorizedFunction(
                                    cx.SorobanAuthorizedFunctionType
                                    .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_HOST_FN,
                                    create_args),
                                subInvocations=[]))])))],
                fee=100 + 10_000_000,
                ext=self._soroban_ext([code_key], [instance_key(addr)]))
        self._counter_code_key = code_key
        return cid

    def generate_counter_invokes(self, cid: bytes, n: int) -> int:
        """n `increment` invocations through the wasm VM — the
        InvokeHostFunction analogue of a contract-call workload."""
        from ..soroban.host import instance_key
        from ..xdr import contract as cx
        assert self.accounts, "run generate_accounts first"
        addr = cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_CONTRACT,
                            cid)
        ckey = LedgerKey.contract_data(
            addr, cx.SCVal(cx.SCValType.SCV_SYMBOL, b"count"),
            cx.ContractDataDurability.PERSISTENT)
        ro = [self._counter_code_key, instance_key(addr)]
        ok = 0
        for i in range(n):
            src = self.accounts[(self.submitted + i) % len(self.accounts)]
            body = _OperationBody(
                OperationType.INVOKE_HOST_FUNCTION,
                cx.InvokeHostFunctionOp(hostFunction=cx.HostFunction(
                    cx.HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT,
                    cx.InvokeContractArgs(contractAddress=addr,
                                          functionName=b"increment",
                                          args=[])), auth=[]))
            if self._sign_and_submit(
                    src, [Operation(sourceAccount=None, body=body)],
                    fee=100 + 10_000_000,
                    ext=self._soroban_ext(ro, [ckey])) == \
                    AddResult.ADD_STATUS_PENDING:
                ok += 1
        return ok

    def generate_soroban_uploads(self, n: int,
                                 resource_fee: int = 10_000_000) -> int:
        """SOROBAN mode: random upload-wasm transactions sized against the
        live SorobanNetworkConfig limits (reference:
        LoadGenerator::createUploadWasmTransaction,
        LoadGenerator.cpp:469-494)."""
        from ..soroban.network_config import SorobanNetworkConfig
        from ..xdr import contract as cx
        assert self.accounts, "run generate_accounts first"
        with LedgerTxn(self.app.ledger_manager.root) as ltx:
            ncfg = SorobanNetworkConfig(ltx)
            max_code = min(ncfg.max_contract_size,
                           ncfg.ledger_cost.txMaxWriteBytes // 2)
        ok = 0
        for i in range(n):
            src = self.accounts[i % len(self.accounts)]
            # unique random-ish body per tx, sized within the live limits
            size = max(64, (max_code // 8) + (i % 7) * 16)
            seed = sha256(b"loadgen-wasm-%d-%d" % (i, self.submitted))
            code = (seed * (size // 32 + 1))[:size]
            code_hash = sha256(code)
            op_body = _OperationBody(
                OperationType.INVOKE_HOST_FUNCTION,
                cx.InvokeHostFunctionOp(hostFunction=cx.HostFunction(
                    cx.HostFunctionType.HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM,
                    code), auth=[]))
            from ..xdr.ledger_entries import LedgerKey
            sd = cx.SorobanTransactionData(
                resources=cx.SorobanResources(
                    footprint=cx.LedgerFootprint(
                        readOnly=[],
                        readWrite=[LedgerKey.contract_code(code_hash)]),
                    instructions=4_000_000,
                    readBytes=0, writeBytes=size + 1024),
                resourceFee=resource_fee)
            op = Operation(sourceAccount=None, body=op_body)
            if self._sign_and_submit(src, [op], fee=100 + resource_fee,
                                     ext=_TxExt(1, sd)) == \
                    AddResult.ADD_STATUS_PENDING:
                ok += 1
        return ok


# ------------------------------------------------------- bulk state seeding --
# Million-account ledgers for the read-serving and big-state benches:
# materialize accounts DIRECTLY into deep bucket-list levels
# as pre-built buckets — no per-tx close loop, no ed25519 keygen (the
# synthetic account ids are sha256 digests used as raw key bytes; these
# accounts only ever get READ, never signed for).
#
# Placement is the load-bearing subtlety: a level's `snap` slot is
# REPLACED by snap_curr() when the level below spills, so seeded data in
# a snap slot would silently vanish. Deep-level `curr` slots are always
# a merge INPUT (level i's curr merges with the spilled snap from i-1)
# and are never dropped, so seeding only ever installs into curr of
# levels deep enough not to spill during a bench window.

BIGSTATE_LEVELS = (7, 8, 9, 10)


def bulk_account_id(i: int, tag: bytes = b"bigstate") -> bytes:
    """Deterministic raw 32-byte account id of seeded account #i —
    benches re-derive read targets from the same function."""
    return sha256(b"%s-%d" % (tag, i))


def build_bigstate_buckets(n: int, protocol: int, ledger_seq: int,
                           tag: bytes = b"bigstate",
                           balance: int = 1_000_0000000):
    """Build the seed buckets for `n` synthetic accounts, split across
    the deep seeding levels. Returns [(level, Bucket), ...]. Building
    once and installing into EVERY node of a simulation keeps the
    immutable Bucket objects (and their lazy indexes) shared — a
    million-account topology pays the entry memory once, and identical
    buckets on every node keep the consensus bucketListHash agreeing."""
    from ..bucket.bucket import Bucket
    from ..tx.tx_utils import make_account_ledger_entry
    levels = list(BIGSTATE_LEVELS)
    per = (n + len(levels) - 1) // len(levels)
    out = []
    start = 0
    seq = starting_sequence_number(max(1, ledger_seq))
    for lvl in levels:
        stop = min(n, start + per)
        if stop <= start:
            break
        entries = []
        for i in range(start, stop):
            le = make_account_ledger_entry(
                PublicKey.ed25519(bulk_account_id(i, tag)),
                balance, seq)
            le.lastModifiedLedgerSeq = ledger_seq
            entries.append(le)
        out.append((lvl, Bucket.fresh(protocol, entries, [], [])))
        start = stop
    return out


def install_bigstate_buckets(app, buckets) -> None:
    """Install pre-built seed buckets into one app's bucket list (deep-
    level curr slots, which must be empty — seeding composes with a
    freshly-booted ledger, not an aged one). The next close recomputes
    bucketListHash over the seeded levels, so every node of a consensus
    group must install the SAME buckets before its next close."""
    bl = app.bucket_manager.bucket_list
    for lvl_idx, bucket in buckets:
        lvl = bl.levels[lvl_idx]
        lvl.commit()
        releaseAssert(lvl.curr.is_empty(),
                      f"bigstate seeding needs empty level {lvl_idx}")
        lvl.curr = bucket
    # the boot snapshot predates the seeded state; recapture so reads
    # see the seeded accounts before the first post-seed close lands
    snaps = getattr(app, "snapshots", None)
    if snaps is not None:
        snaps.on_ledger_closed(
            app.ledger_manager.get_last_closed_ledger_header(),
            app.ledger_manager.get_last_closed_ledger_hash())


def seed_accounts_bulk(app, n: int, tag: bytes = b"bigstate",
                       balance: int = 1_000_0000000) -> int:
    """Convenience one-app path: build + install `n` synthetic accounts
    into this app's bucket list. Returns n."""
    lcl = app.ledger_manager.get_last_closed_ledger_num()
    protocol = app.ledger_manager.get_last_closed_ledger_header().ledgerVersion
    install_bigstate_buckets(
        app, build_bigstate_buckets(n, protocol, lcl, tag=tag,
                                    balance=balance))
    return n
