"""The port's Soroban host, its op frames, fees, network config and
footprints, its wasm VM and its auth-entry tuples against the JAX
package's, on the CPU.

The JAX package's Soroban tests run through its `Application`, which the
port does not have yet, so the ledger is built with the JAX package: an
in-memory root with `create_initial_settings` (whose entries must be the
same bytes in both packages) is carried into the port as bytes, and the
same envelopes are applied in both. After every transaction the result
bytes, the contract events, the return value and the whole ledger must
be equal. The scenarios follow tests/test_soroban.py (its SCVM and wasm
builds of the counter), tests/test_env_abi.py (the three env-ABI
contracts) and tests/test_sac.py; the budget a wasm call needs is
bisected in the JAX package and held exactly in both. The phase-11 and
phase-12 mixes of chip_smoke.py run at 40 transactions through both
packages' txset path with every default invariant on, the port's on the
plain kernels."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from stellar_core_tpu.crypto.sha import sha256
from stellar_core_tpu.xdr import contract as cx
from stellar_core_tpu.xdr.ledger_entries import (AccountFlags, Asset,
                                                 AssetType, LedgerKey,
                                                 TrustLineAsset)
from stellar_core_tpu.xdr.transaction import (Memo, MemoType, Operation,
                                              OperationType, Preconditions,
                                              PreconditionType, Transaction,
                                              TransactionEnvelope,
                                              TransactionV1Envelope,
                                              _OperationBody, _TxExt)
from stellar_core_tpu.xdr.types import EnvelopeType, PublicKey

import chip_smoke
from test_soroban import COUNTER_FUNCTIONS
from torch_tx_parity import (J, P, NETWORK_ID, OracleVerifier, clear_caches,
                             contract_meta, frame_of, jax_root_from_xdr,
                             port_root, run_set, state_of)
from txtest_utils import (TestAccount, TestLedger, make_asset,
                          op_change_trust, op_create_account, op_payment,
                          op_set_options, sign_frame)

ROOT = Path(__file__).resolve().parents[1]
XLM = 10_000_000
RESOURCE_FEE = 10_000_000
SUCCESS = "INVOKE_HOST_FUNCTION_SUCCESS"
TRAPPED = "INVOKE_HOST_FUNCTION_TRAPPED"


@pytest.fixture(autouse=True)
def _fresh_verify_caches():
    clear_caches()
    yield
    clear_caches()


# ------------------------------------------------------------- settings --

@pytest.mark.parametrize("kw", [{}, {"high_limits": True},
                                {"archival_overrides": {
                                    "minPersistentTTL": 16,
                                    "minTemporaryTTL": 8}}],
                         ids=["default", "high_limits", "archival"])
def test_initial_settings_write_the_same_bytes(kw):
    """create_initial_settings writes the protocol-20 CONFIG_SETTING
    entries, the same bytes in both packages, and each package's
    SorobanNetworkConfig reads the same limits back."""
    roots = []
    for pkg in (J, P):
        root = pkg.ledger_txn.InMemoryLedgerTxnRoot(
            pkg.ledger.LedgerHeader.from_bytes(
                TestLedger().header().to_bytes()))
        with pkg.ledger_txn.LedgerTxn(root) as ltx:
            pkg.network_config.create_initial_settings(ltx, **kw)
            ltx.commit()
        roots.append(root)
    assert state_of(roots[0]) == state_of(roots[1])
    assert len(roots[1]._entries) == len(J.network_config.initial_settings())
    reads = []
    for pkg, root in zip((J, P), roots):
        with pkg.ledger_txn.LedgerTxn(root) as ltx:
            c = pkg.network_config.SorobanNetworkConfig(ltx)
            reads.append((c.tx_max_instructions,
                          c.fee_rate_per_instructions_increment,
                          c.ledger_cost.to_bytes(), c.bandwidth.to_bytes(),
                          c.events_cfg.to_bytes(), c.historical.to_bytes(),
                          c.state_archival.to_bytes(), c.max_contract_size,
                          c.max_data_key_size, c.max_data_entry_size))
    assert reads[0] == reads[1]


# ------------------------------------------------------- mirrored ledger --

class Pair:
    """A JAX test ledger with the initial Soroban settings and the port's
    copy of it from bytes, stepped together: every transaction is
    applied in both, and the outcome (verdict, result bytes, events,
    return value) and the whole ledger must be equal."""

    def __init__(self, version: int = 21):
        self.led = TestLedger(ledger_version=version)
        with J.ledger_txn.LedgerTxn(self.led.root) as ltx:
            J.network_config.create_initial_settings(ltx)
            ltx.commit()
        self.master = self.led.root_account
        self.sync()

    def sync(self):
        """Carry the JAX ledger into the port again (after a hand edit)."""
        self.proot = port_root(self.led.root)

    def step(self, frame):
        """Apply `frame` in both packages and compare; the port's
        outcome (ok, result, events, return value) is kept in `last`."""
        env = frame.envelope.to_bytes()
        outs, jframe = [], None
        for pkg, root in ((J, self.led.root), (P, self.proot)):
            f = frame_of(pkg, env)
            meta = {}
            with pkg.ledger_txn.LedgerTxn(root) as ltx:
                bf = root.get_header().baseFee
                f.process_fee_seq_num(ltx, bf)
                ok = f.apply(ltx, bf, meta=meta)
                ltx.commit()
            outs.append((ok, f.result.to_bytes(), *contract_meta(meta),
                         state_of(root)))
            jframe = jframe or f
        assert outs[0][:4] == outs[1][:4]
        assert outs[0][4] == outs[1][4]
        self.last = outs[1][:4]
        return jframe

    def classic(self, acct, ops):
        f = self.step(acct.tx(ops))
        assert f.result.result.disc.name == "txSUCCESS", f.result
        return f

    def frame(self, acct, body, ro=(), rw=(), instructions=2_000_000,
              read=10_000, write=10_000, seq=None):
        """A signed JAX frame of one InvokeHostFunction / TTL op of
        `acct` (at `seq`, by default its next sequence number)."""
        sd = cx.SorobanTransactionData(
            resources=cx.SorobanResources(
                footprint=cx.LedgerFootprint(readOnly=list(ro),
                                             readWrite=list(rw)),
                instructions=instructions, readBytes=read, writeBytes=write),
            resourceFee=RESOURCE_FEE)
        tx = Transaction(
            sourceAccount=acct.muxed, fee=100 + RESOURCE_FEE,
            seqNum=acct.next_seq() if seq is None else seq,
            cond=Preconditions(PreconditionType.PRECOND_NONE),
            memo=Memo(MemoType.MEMO_NONE),
            operations=[Operation(sourceAccount=None, body=body)],
            ext=_TxExt(1, sd))
        env = TransactionEnvelope(EnvelopeType.ENVELOPE_TYPE_TX,
                                  TransactionV1Envelope(tx=tx, signatures=[]))
        frame = J.frame.make_frame(env, NETWORK_ID)
        sign_frame(frame, acct.key)
        return frame

    def soroban(self, acct, body, ro=(), rw=(), instructions=2_000_000,
                read=10_000, write=10_000):
        """Apply one InvokeHostFunction / TTL op of `acct`; returns the
        result code of the op (or of the transaction)."""
        f = self.step(self.frame(acct, body, ro, rw, instructions, read,
                                 write))
        ops = f.result.result.value
        if isinstance(ops, list) and ops and ops[0].disc.name == "opINNER":
            return ops[0].value.value.disc.name
        return f.result.result.disc.name

    def fresh(self, balance=10_000 * XLM):
        acct = TestAccount.fresh(self.led)
        self.classic(self.master, [op_create_account(acct.account_id,
                                                     balance)])
        acct.sync_seq()
        return acct


def _account_addr(acct) -> cx.SCAddress:
    return cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_ACCOUNT,
                        acct.account_id)


def _contract_addr(cid: bytes) -> cx.SCAddress:
    return cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_CONTRACT, cid)


def _host_fn(kind, value, auth=()):
    return _OperationBody(OperationType.INVOKE_HOST_FUNCTION,
                          cx.InvokeHostFunctionOp(
                              hostFunction=cx.HostFunction(kind, value),
                              auth=list(auth)))


def _root_inv(function_type, value):
    return cx.SorobanAuthorizedInvocation(
        function=cx.SorobanAuthorizedFunction(function_type, value),
        subInvocations=[])


def _source_auth(inv):
    return cx.SorobanAuthorizationEntry(
        credentials=cx.SorobanCredentials(
            cx.SorobanCredentialsType.SOROBAN_CREDENTIALS_SOURCE_ACCOUNT),
        rootInvocation=inv)


def _invoke(cid, fn, args=(), auth="source"):
    call = cx.InvokeContractArgs(contractAddress=_contract_addr(cid),
                                 functionName=fn.encode(), args=list(args))
    if auth == "source":
        auth = [_source_auth(_root_inv(
            cx.SorobanAuthorizedFunctionType
            .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN, call))]
    return _host_fn(cx.HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT,
                    call, auth)


def _deploy(pair, code):
    """Upload `code` and create a contract of it from the master's
    address; returns (contract id, code key)."""
    code_hash = sha256(code)
    code_key = LedgerKey.contract_code(code_hash)
    HF = cx.HostFunctionType
    assert pair.soroban(pair.master, _host_fn(
        HF.HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM, code),
        [], [code_key]) == SUCCESS
    preimage = cx.ContractIDPreimage(
        cx.ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ADDRESS,
        cx._ContractIDPreimageFromAddress(
            address=_account_addr(pair.master), salt=b"\x01" * 32))
    args = cx.CreateContractArgs(
        contractIDPreimage=preimage, executable=cx.ContractExecutable(
            cx.ContractExecutableType.CONTRACT_EXECUTABLE_WASM, code_hash))
    cid = J.host.contract_id_from_preimage(NETWORK_ID, preimage)
    assert pair.soroban(pair.master, _host_fn(
        HF.HOST_FUNCTION_TYPE_CREATE_CONTRACT, args, [_source_auth(_root_inv(
            cx.SorobanAuthorizedFunctionType
            .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_HOST_FN,
            args))]), [code_key],
        [J.host.instance_key(_contract_addr(cid))]) == SUCCESS
    return cid, code_key


def _counter_key(cid):
    return LedgerKey.contract_data(
        _contract_addr(cid), cx.SCVal(cx.SCValType.SCV_SYMBOL, b"count"),
        cx.ContractDataDurability.PERSISTENT)


def deploy_counter(code, version: int = 21):
    """A Pair with a build of tests/test_soroban.py's counter contract
    deployed: (pair, contract id, read-only and read-write footprints of
    its storage)."""
    pair = Pair(version)
    cid, code_key = _deploy(pair, code)
    ro = [code_key, J.host.instance_key(_contract_addr(cid))]
    return pair, cid, ro, [_counter_key(cid)]


@pytest.fixture(params=["scvm", "wasm"])
def counter(request):
    """The counter, deployed (`deploy_counter`): its SCVM build and its
    wasm build, as tests/test_soroban.py's `app` parameter has them."""
    make = J.scvm.make_code if request.param == "scvm" \
        else J.scvm_wasm.make_wasm_code
    return deploy_counter(make(COUNTER_FUNCTIONS))


def _address_auth(signer, cid, fn, args, nonce, expiration, sign=True):
    addr = cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_ACCOUNT,
                        PublicKey.ed25519(signer.public_key().raw))
    inv = _root_inv(cx.SorobanAuthorizedFunctionType
                    .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN,
                    cx.InvokeContractArgs(contractAddress=_contract_addr(cid),
                                          functionName=fn.encode(),
                                          args=list(args)))
    payload = J.host.soroban_auth_payload(NETWORK_ID, nonce, expiration, inv)
    sig = signer.sign(payload) if sign else bytes(64)
    sig_val = cx.SCVal(cx.SCValType.SCV_VEC, [cx.SCVal(
        cx.SCValType.SCV_MAP, [
            cx.SCMapEntry(key=cx.SCVal(cx.SCValType.SCV_SYMBOL,
                                       b"public_key"),
                          val=cx.SCVal(cx.SCValType.SCV_BYTES,
                                       signer.public_key().raw)),
            cx.SCMapEntry(key=cx.SCVal(cx.SCValType.SCV_SYMBOL,
                                       b"signature"),
                          val=cx.SCVal(cx.SCValType.SCV_BYTES, sig))])])
    return cx.SorobanAuthorizationEntry(
        credentials=cx.SorobanCredentials(
            cx.SorobanCredentialsType.SOROBAN_CREDENTIALS_ADDRESS,
            cx.SorobanAddressCredentials(
                address=addr, nonce=nonce,
                signatureExpirationLedger=expiration, signature=sig_val)),
        rootInvocation=inv)


# ------------------------------------------------------------ scenarios --

def test_counter_upload_create_invoke(counter):
    pair, cid, ro, rw = counter
    for _ in range(3):
        assert pair.soroban(pair.master, _invoke(cid, "increment"),
                            ro, rw) == SUCCESS
    assert pair.soroban(pair.master, _invoke(cid, "get_count"), ro,
                        rw) == SUCCESS
    le = pair.proot._lookup(_counter_key(cid).to_bytes())
    assert le.data.value.val.value == 3


def test_trap_write_outside_footprint_and_budget(counter):
    pair, cid, ro, rw = counter
    assert pair.soroban(pair.master, _invoke(cid, "boom"), ro, rw) == TRAPPED
    assert pair.soroban(pair.master, _invoke(cid, "increment"), ro,
                        []) == TRAPPED
    assert pair.soroban(pair.master, _invoke(cid, "increment"), ro, rw,
                        instructions=200) == \
        "INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED"


def test_source_account_auth_and_event(counter):
    pair, cid, ro, rw = counter
    arg = cx.SCVal(cx.SCValType.SCV_ADDRESS, _account_addr(pair.master))
    assert pair.soroban(pair.master, _invoke(cid, "auth_bump", [arg]),
                        ro, rw) == SUCCESS


def test_address_auth_missing_auth_and_reused_nonce(counter):
    """A holder's signed address credentials authorize the relayer's
    call and consume their nonce; the same nonce again, a missing entry,
    an expired entry and an all-zero signature all fail as TRAPPED."""
    pair, cid, ro, rw = counter
    holder = pair.fresh()
    arg = cx.SCVal(cx.SCValType.SCV_ADDRESS, _account_addr(holder))
    seq = pair.led.header().ledgerSeq

    def call(nonce, expiration=seq + 100, sign=True):
        return _invoke(cid, "auth_bump", [arg], auth=[_address_auth(
            holder.key, cid, "auth_bump", [arg], nonce, expiration, sign)])

    assert pair.soroban(pair.master, call(7), ro, rw) == SUCCESS
    assert pair.soroban(pair.master, call(7), ro, rw) == TRAPPED
    assert pair.soroban(pair.master, call(8, expiration=seq - 1), ro,
                        rw) == TRAPPED
    assert pair.soroban(pair.master, call(9, sign=False), ro, rw) == TRAPPED
    assert pair.soroban(pair.master, _invoke(cid, "auth_bump", [arg], []),
                        ro, rw) == TRAPPED
    assert pair.soroban(pair.master, call(10), ro, rw) == SUCCESS


def test_extend_and_restore_ttl(counter):
    pair, cid, ro, rw = counter
    assert pair.soroban(pair.master, _invoke(cid, "increment"), ro,
                        rw) == SUCCESS
    key = _counter_key(cid)
    assert pair.soroban(pair.master, _OperationBody(
        OperationType.EXTEND_FOOTPRINT_TTL,
        cx.ExtendFootprintTTLOp(extendTo=50_000)), [key], []) == \
        "EXTEND_FOOTPRINT_TTL_SUCCESS"
    with J.ledger_txn.LedgerTxn(pair.led.root) as ltx:
        ltx.load(J.host.ttl_key_for(key)).data.value.liveUntilLedgerSeq = 1
        ltx.commit()
    pair.sync()
    assert pair.soroban(pair.master, _invoke(cid, "increment"), ro, rw) == \
        "INVOKE_HOST_FUNCTION_ENTRY_ARCHIVED"
    assert pair.soroban(pair.master, _OperationBody(
        OperationType.RESTORE_FOOTPRINT, cx.RestoreFootprintOp()), [],
        [key]) == "RESTORE_FOOTPRINT_SUCCESS"
    assert pair.soroban(pair.master, _invoke(cid, "increment"), ro,
                        rw) == SUCCESS


def test_protocol_20_costs_twice_21():
    """One instruction budget the protocol-21 host (SorobanHost) fits
    and the protocol-20 host (SorobanHostPrev, twice the storage, byte
    and call costs) exhausts, in both packages."""
    codes = {}
    for version in (20, 21):
        pair = Pair(version)
        cid, code_key = _deploy(pair, J.scvm.make_code(COUNTER_FUNCTIONS))
        ro = [code_key, J.host.instance_key(_contract_addr(cid))]
        codes[version] = [pair.soroban(pair.master, _invoke(cid, "increment"),
                                       ro, [_counter_key(cid)],
                                       instructions=budget)
                          for budget in (60_000, 2_000_000)]
    assert P.host.host_for_protocol(20).__name__ == "SorobanHostPrev"
    assert codes[21] == [SUCCESS, SUCCESS]
    assert codes[20] == ["INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED",
                         SUCCESS]


@pytest.fixture
def usd_sac():
    """A Pair with an issuer of USD (revocable, clawback enabled), alice
    with 1,000 USD and bob, both with trustlines, and the USD SAC."""
    pair = Pair()
    issuer, alice, bob = pair.fresh(), pair.fresh(), pair.fresh()
    pair.classic(issuer, [op_set_options(
        inflationDest=None, clearFlags=None,
        setFlags=(AccountFlags.AUTH_REVOCABLE_FLAG
                  | AccountFlags.AUTH_CLAWBACK_ENABLED_FLAG),
        masterWeight=None, lowThreshold=None, medThreshold=None,
        highThreshold=None, homeDomain=None, signer=None)])
    usd = make_asset(b"USD", issuer.account_id)
    for acct in (alice, bob):
        pair.classic(acct, [op_change_trust(usd, 10 ** 15)])
    pair.classic(issuer, [op_payment(alice.muxed, 1000 * XLM, usd)])
    preimage = cx.ContractIDPreimage(
        cx.ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ASSET, usd)
    cid = J.host.contract_id_from_preimage(NETWORK_ID, preimage)
    assert pair.soroban(pair.master, _host_fn(
        cx.HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT,
        cx.CreateContractArgs(
            contractIDPreimage=preimage, executable=cx.ContractExecutable(
                cx.ContractExecutableType.CONTRACT_EXECUTABLE_STELLAR_ASSET))),
        [], [J.host.instance_key(_contract_addr(cid))]) == SUCCESS
    return pair, issuer, alice, bob, usd, cid


def _tl(acct, asset):
    return LedgerKey.trust_line(acct.account_id,
                                TrustLineAsset.from_asset(asset))


def test_sac_transfer_mint_burn_allowance_clawback(usd_sac):
    """The USD SAC over classic trustlines: transfer, mint by the admin
    (and refused to a non-admin), burn, approve then transfer_from (and
    past the allowance), clawback from a trustline, and the function a
    SAC does not have; every step the same in both packages."""
    pair, issuer, alice, bob, usd, cid = usd_sac
    sac = J.sac
    ro = [J.host.instance_key(_contract_addr(cid)),
          LedgerKey.account(issuer.account_id)]
    both = [_tl(alice, usd), _tl(bob, usd)]

    def addr(acct):
        return sac._addr_scval(_account_addr(acct))

    assert pair.soroban(alice, _invoke(cid, "transfer", [
        addr(alice), addr(bob), sac.sc_i128(250 * XLM)]), ro,
        both) == SUCCESS
    assert pair.soroban(alice, _invoke(cid, "mint", [
        addr(bob), sac.sc_i128(5)]), ro, [_tl(bob, usd)]) == TRAPPED
    assert pair.soroban(issuer, _invoke(cid, "mint", [
        addr(bob), sac.sc_i128(5)]), ro, [_tl(bob, usd)]) == SUCCESS
    assert pair.soroban(alice, _invoke(cid, "burn", [
        addr(alice), sac.sc_i128(7)]), ro, [_tl(alice, usd)]) == SUCCESS
    allow = sac.allowance_key(_contract_addr(cid), _account_addr(alice),
                              _account_addr(bob))
    until = cx.SCVal(cx.SCValType.SCV_U32, pair.led.header().ledgerSeq + 1000)
    assert pair.soroban(alice, _invoke(cid, "approve", [
        addr(alice), addr(bob), sac.sc_i128(100), until]), ro,
        [allow]) == SUCCESS
    for amount, code in ((60, SUCCESS), (60, TRAPPED), (40, SUCCESS)):
        assert pair.soroban(bob, _invoke(cid, "transfer_from", [
            addr(bob), addr(alice), addr(bob), sac.sc_i128(amount)]), ro,
            both + [allow]) == code
    assert pair.soroban(issuer, _invoke(cid, "clawback", [
        addr(alice), sac.sc_i128(3)]), ro, [_tl(alice, usd)]) == SUCCESS
    assert pair.soroban(alice, _invoke(cid, "no_such_fn"), ro, []) == TRAPPED


def test_native_sac_transfer():
    pair = Pair()
    alice = pair.fresh()
    native = Asset(AssetType.ASSET_TYPE_NATIVE)
    preimage = cx.ContractIDPreimage(
        cx.ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ASSET, native)
    cid = J.host.contract_id_from_preimage(NETWORK_ID, preimage)
    inst = J.host.instance_key(_contract_addr(cid))
    assert pair.soroban(pair.master, _host_fn(
        cx.HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT,
        cx.CreateContractArgs(
            contractIDPreimage=preimage, executable=cx.ContractExecutable(
                cx.ContractExecutableType.CONTRACT_EXECUTABLE_STELLAR_ASSET))),
        [], [inst]) == SUCCESS
    rw = [LedgerKey.account(alice.account_id),
          LedgerKey.account(pair.master.account_id)]
    assert pair.soroban(alice, _invoke(cid, "transfer", [
        J.sac._addr_scval(_account_addr(alice)),
        J.sac._addr_scval(_account_addr(pair.master)),
        J.sac.sc_i128(100 * XLM)]), [inst], rw) == SUCCESS
    assert pair.soroban(alice, _invoke(cid, "burn", [
        J.sac._addr_scval(_account_addr(alice)), J.sac.sc_i128(1)]),
        [inst], rw) == TRAPPED


# -------------------------------------------------------- the wasm VM --

def test_wasm_contract_raises_not_implemented():
    """The reference's own wasm build of the counter (scvm_wasm) runs in
    both packages alike: uploading, creating and invoking it give the
    same results, events, return values and ledger, and the counter
    reads 1 in both. (The port once raised NotImplementedError here;
    its wasm VM is the reference's now.)"""
    code = P.scvm_wasm.make_wasm_code(COUNTER_FUNCTIONS)
    assert code == J.scvm_wasm.make_wasm_code(COUNTER_FUNCTIONS)
    assert code.startswith(P.wasm_host.WASM_MAGIC)
    pair, cid, ro, rw = deploy_counter(code)
    assert pair.soroban(pair.master, _invoke(cid, "increment"), ro,
                        rw) == SUCCESS
    for root in (pair.led.root, pair.proot):
        assert root._lookup(
            _counter_key(cid).to_bytes()).data.value.val.value == 1


def _budget_needed(pair, acct, body, ro, rw):
    """The fewest `instructions` with which `body` succeeds, bisected in
    the JAX package alone on a LedgerTxn that is rolled back."""
    def succeeds(instructions):
        frame = pair.frame(acct, body, ro, rw, instructions,
                           seq=acct.seq + 1)
        with J.ledger_txn.LedgerTxn(pair.led.root) as ltx:
            frame.process_fee_seq_num(ltx, 100)
            ok = frame.apply(ltx, 100)
            ltx.rollback()
        return ok

    lo, hi = 0, 4_000_000
    assert succeeds(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if succeeds(mid) else (mid, hi)
    return hi


@pytest.mark.parametrize("build", ["wasm", "env"])
def test_wasm_budget_exactly_enough_and_one_short(build):
    """The fewest instructions a wasm call needs, bisected in the JAX
    package: one short is RESOURCE_LIMIT_EXCEEDED and exactly enough is
    SUCCESS in both packages, so the port's fuel (wasm_host's meter,
    COST_WASM_INSTRUCTION, the host-call charge, bulk-memory bytes)
    matches instruction for instruction. The env-ABI counter's auth_bump
    with address credentials needs one more than chip_smoke.py's
    WASM_FUEL_INSTRUCTIONS, which phase 12's fuel kind declares."""
    code = J.scvm_wasm.make_wasm_code(COUNTER_FUNCTIONS) if build == "wasm" \
        else J.env_contract.build_env_counter()
    pair, cid, ro, rw = deploy_counter(code)
    if build == "wasm":
        def body(nonce):
            return _invoke(cid, "increment")
    else:
        holder = pair.fresh()
        arg = cx.SCVal(cx.SCValType.SCV_ADDRESS, _account_addr(holder))
        seq = pair.led.header().ledgerSeq
        rw = []

        def body(nonce):
            return _invoke(cid, "auth_bump", [arg], auth=[_address_auth(
                holder.key, cid, "auth_bump", [arg], nonce, seq + 100)])
    need = _budget_needed(pair, pair.master, body(1), ro, rw)
    if build == "env":
        assert need == chip_smoke.WASM_FUEL_INSTRUCTIONS + 1
    assert pair.soroban(pair.master, body(2), ro, rw,
                        instructions=need - 1) == \
        "INVOKE_HOST_FUNCTION_RESOURCE_LIMIT_EXCEEDED"
    assert pair.soroban(pair.master, body(3), ro, rw,
                        instructions=need) == SUCCESS


@pytest.mark.parametrize("build", ["scvm", "wasm"])
def test_contract_moves_classic_asset(usd_sac, build):
    """tests/test_sac.py::test_wasm_contract_moves_classic_asset in both
    packages, on the SCVM build of its treasury contract (as there) and
    on its wasm build: the treasury, minted 100 USD, pays bob 60 through
    the USD SAC under invoker auth, and bob's trustline moves."""
    pair, issuer, alice, bob, usd, cid = usd_sac
    sac_addr = _contract_addr(cid)
    scvm = J.scvm
    fns = {"pay": scvm.op(
        scvm.sym("call"),
        scvm.op(scvm.sym("lit"), cx.SCVal(cx.SCValType.SCV_ADDRESS,
                                          sac_addr)),
        scvm.op(scvm.sym("lit"), scvm.sym("transfer")),
        scvm.op(scvm.sym("self")),
        scvm.op(scvm.sym("arg"), scvm.u64(0)),
        scvm.op(scvm.sym("arg"), scvm.u64(1)))}
    code = scvm.make_code(fns) if build == "scvm" \
        else J.scvm_wasm.make_wasm_code(fns)
    tcid, code_key = _deploy(pair, code)
    taddr = _contract_addr(tcid)
    bkey = J.sac.balance_key(sac_addr, taddr)
    issuer_key = LedgerKey.account(issuer.account_id)
    inst = J.host.instance_key
    assert pair.soroban(issuer, _invoke(cid, "mint", [
        J.sac._addr_scval(taddr), J.sac.sc_i128(100)]),
        [inst(sac_addr), issuer_key], [bkey]) == SUCCESS
    before = pair.proot._lookup(_tl(bob, usd).to_bytes()).data.value.balance
    assert pair.soroban(pair.master, _invoke(tcid, "pay", [
        J.sac._addr_scval(_account_addr(bob)), J.sac.sc_i128(60)]),
        [code_key, inst(taddr), inst(sac_addr), issuer_key],
        [bkey, _tl(bob, usd)]) == SUCCESS
    assert pair.proot._lookup(
        _tl(bob, usd).to_bytes()).data.value.balance == before + 60


def _data_key(cid, sym):
    return LedgerKey.contract_data(_contract_addr(cid),
                                   cx.SCVal(cx.SCValType.SCV_SYMBOL, sym),
                                   cx.ContractDataDurability.PERSISTENT)


def _env_calls(pair, build):
    """(function, args, expected code) of tests/test_env_abi.py's
    end-to-end scenarios for one of the env-ABI contracts."""
    sk = J.keys.SecretKey.pseudo_random_for_testing(7)
    msg = b"toolkit message"
    sig = sk.sign(msg)

    def b(x):
        return cx.SCVal(cx.SCValType.SCV_BYTES, x)

    if build == "counter":
        me = cx.SCVal(cx.SCValType.SCV_ADDRESS, _account_addr(pair.master))
        return [("increment", [], SUCCESS), ("increment", [], SUCCESS),
                ("get_count", [], SUCCESS), ("boom", [], TRAPPED),
                ("copy_hash", [], SUCCESS), ("drop_then_init", [], TRAPPED),
                ("auth_bump", [me], SUCCESS)]
    if build == "toolkit":
        bad = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        return [("map_demo", [], SUCCESS), ("i128_demo", [], SUCCESS),
                ("str_demo", [], SUCCESS),
                ("sig_demo", [b(sk.public_key().raw), b(msg), b(sig)],
                 SUCCESS),
                ("sig_demo", [b(sk.public_key().raw), b(msg), b(bad)],
                 TRAPPED)]
    return [("u256_demo", [], SUCCESS), ("div_zero", [], TRAPPED)]


@pytest.mark.parametrize("build", ["counter", "toolkit", "u256"])
def test_env_abi_contracts_upload_create_invoke(build):
    """The three hand-assembled env-ABI contracts of soroban/env_contract.py
    (the real soroban-env import ABI: tagged i64 Vals, single-letter
    modules) uploaded, created and invoked in both packages, every call
    of tests/test_env_abi.py's end-to-end scenarios; storage, events,
    return values and traps equal."""
    code = getattr(J.env_contract, f"build_env_{build}")()
    assert code == getattr(P.env_contract, f"build_env_{build}")()
    pair, cid, ro, _ = deploy_counter(code)
    rw = [_data_key(cid, b"count"), _data_key(cid, b"hash")]
    returns = {}
    for fn, args, want in _env_calls(pair, build):
        assert pair.soroban(pair.master, _invoke(cid, fn, args), ro,
                            rw) == want, fn
        returns[fn] = pair.last[3]
    if build == "counter":
        assert cx.SCVal.from_bytes(returns["get_count"]) == \
            cx.SCVal(cx.SCValType.SCV_U32, 2)
        assert pair.proot._lookup(_data_key(cid, b"hash").to_bytes()) \
            .data.value.val.value == sha256(J.env_contract.COPY_HASH_PREIMAGE)
    elif build == "u256":
        uv, iv = cx.SCVal.from_bytes(returns["u256_demo"]).value
        p = uv.value
        assert (p.hi_hi << 192 | p.hi_lo << 128 | p.lo_hi << 64
                | p.lo_lo) == ((1 << 192) + (2 << 128) + (3 << 64) + 9) << 7
        assert iv.disc == cx.SCValType.SCV_I256


@pytest.mark.parametrize("entry", ["soroban", "tx"])
def test_vm_registry_alike(entry):
    """In a fresh interpreter, importing the Soroban layer (or the
    transaction layer, which imports it) registers the same VMs, prefixes
    in the same order, in both packages: the wasm VM registers by import
    side effect, and without it wasm code would fail as 'no VM'."""
    got = []
    for root in ("stellar_core_tpu", "stellar_core_tpu_torch"):
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
                f"import {root}.{entry}; "
                f"from {root}.soroban.host import VM_REGISTRY; "
                "print([(p.hex(), f.__module__.split('.', 1)[1]) "
                "for p, f in VM_REGISTRY.items()])")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        got.append(r.stdout.strip())
    assert got[0] == got[1] == str([("5343564d", "soroban.scvm"),
                                    ("0061736d", "soroban.wasm_host")])


# ------------------------------------------------ fees and footprints --

def _resources(pkg, rng, keys):
    C = pkg.contract
    n_ro = int(rng.integers(0, len(keys)))
    return C.SorobanResources(
        footprint=C.LedgerFootprint(
            readOnly=[pkg.entries.LedgerKey.from_bytes(k)
                      for k in keys[:n_ro]],
            readWrite=[pkg.entries.LedgerKey.from_bytes(k)
                       for k in keys[n_ro:]]),
        instructions=int(rng.integers(0, 10 ** 8)),
        readBytes=int(rng.integers(0, 200_000)),
        writeBytes=int(rng.integers(0, 130_000)))


@pytest.mark.parametrize("seed", range(3))
def test_fees_agree(seed):
    """compute_transaction_resource_fee, compute_write_fee_per_1kb and
    compute_rent_fee on seeded resources, sizes and rent changes, under
    each package's SorobanNetworkConfig of the same settings."""
    rng = np.random.default_rng(seed)
    keys = [LedgerKey.contract_code(rng.bytes(32)).to_bytes()
            for _ in range(6)] + \
        [LedgerKey.account(PublicKey.ed25519(rng.bytes(32))).to_bytes()
         for _ in range(3)]
    cfgs = []
    for pkg in (J, P):
        root = pkg.ledger_txn.InMemoryLedgerTxnRoot(
            pkg.ledger.LedgerHeader.from_bytes(
                TestLedger().header().to_bytes()))
        with pkg.ledger_txn.LedgerTxn(root) as ltx:
            pkg.network_config.create_initial_settings(ltx)
            ltx.commit()
        with pkg.ledger_txn.LedgerTxn(root) as ltx:
            cfgs.append(pkg.network_config.SorobanNetworkConfig(ltx))
    for _ in range(100):
        state = rng.bit_generator.state
        got = []
        for pkg, cfg in zip((J, P), cfgs):
            rng.bit_generator.state = state
            res = _resources(pkg, rng, keys)
            size = int(rng.integers(0, 100_000))
            events = int(rng.integers(0, 20_000))
            bucket = int(rng.integers(0, 2 ** 40))
            seq = int(rng.integers(1, 10 ** 6))
            changes = [{"is_persistent": bool(rng.integers(2)),
                        "old_size_bytes": int(rng.integers(0, 5000)),
                        "new_size_bytes": int(rng.integers(0, 5000)),
                        "old_live_until": int(rng.integers(0, seq + 10)),
                        "new_live_until": int(rng.integers(seq, seq + 10 ** 6))}
                       for _ in range(int(rng.integers(0, 4)))]
            got.append((
                pkg.fees.compute_transaction_resource_fee(res, size, events,
                                                          cfg),
                pkg.fees.compute_write_fee_per_1kb(bucket, cfg.ledger_cost),
                pkg.fees.compute_rent_fee(changes, cfg, bucket, seq)))
        assert got[0] == got[1]


@pytest.mark.parametrize("seed", range(2))
def test_extract_footprint_agrees(seed):
    """extract_footprint(s) of seeded classic transactions (payments,
    path payments, offers, trust, account ops, claimable balances and
    pools) and of Soroban ones: the same key sets and precision."""
    from stellar_core_tpu.xdr.transaction import (
        ClaimClaimableBalanceOp, LiquidityPoolDepositOp, ManageSellOfferOp)
    from stellar_core_tpu.xdr.ledger_entries import (ClaimableBalanceID,
                                                     ClaimableBalanceIDType,
                                                     Price)
    from txtest_utils import _op, op_path_payment_strict_send
    rng = np.random.default_rng(20 + seed)
    led = TestLedger()
    accts = [TestAccount.fresh(led) for _ in range(4)]
    usd = make_asset(b"USD", accts[0].account_id)
    xlm = Asset(AssetType.ASSET_TYPE_NATIVE)
    frames = []
    for _ in range(60):
        a, b = (accts[int(i)] for i in rng.choice(4, 2, replace=False))
        pick = int(rng.integers(8))
        if pick == 0:
            op = op_payment(b.muxed, 10, usd if rng.random() < .5 else None)
        elif pick == 1:
            op = op_path_payment_strict_send(xlm, 10, b.muxed, usd, 1, [])
        elif pick == 2:
            op = _op(OperationType.MANAGE_SELL_OFFER, ManageSellOfferOp(
                selling=xlm, buying=usd, amount=5, price=Price(n=1, d=1),
                offerID=int(rng.integers(0, 3))))
        elif pick == 3:
            op = op_change_trust(usd, 10 ** 9)
        elif pick == 4:
            op = op_create_account(PublicKey.ed25519(rng.bytes(32)), XLM)
        elif pick == 5:
            op = _op(OperationType.CLAIM_CLAIMABLE_BALANCE,
                     ClaimClaimableBalanceOp(balanceID=ClaimableBalanceID(
                         ClaimableBalanceIDType.CLAIMABLE_BALANCE_ID_TYPE_V0,
                         rng.bytes(32))))
        elif pick == 6:
            op = _op(OperationType.LIQUIDITY_POOL_DEPOSIT,
                     LiquidityPoolDepositOp(
                         liquidityPoolID=rng.bytes(32), maxAmountA=1,
                         maxAmountB=1, minPrice=Price(n=1, d=1),
                         maxPrice=Price(n=1, d=1)))
        else:
            op = op_set_options(inflationDest=None, clearFlags=None,
                                setFlags=None, masterWeight=None,
                                lowThreshold=None, medThreshold=None,
                                highThreshold=None, homeDomain=b"x",
                                signer=None)
        frames.append(a.tx([op] * int(rng.integers(1, 3))))
    envs = [f.envelope.to_bytes() for f in frames]
    envs += chip_smoke.soroban_workload(6)["envelopes"]
    got = []
    for pkg in (J, P):
        fs = [frame_of(pkg, e) for e in envs]
        got.append([(sorted(fp.keys), fp.precise)
                    for fp in pkg.footprint.extract_footprints(fs)])
        assert [(sorted(pkg.footprint.extract_footprint(f).keys),
                 pkg.footprint.extract_footprint(f).precise)
                for f in fs] == got[-1]
    assert got[0] == got[1]
    assert any(p for _, p in got[1]) and not all(p for _, p in got[1])


# ------------------------------------------------- auth-entry tuples --

def _malformed_maps():
    """Signature SCVals of address credentials: a void-typed map (the
    reference's remote-DoS case), a bare map, a map missing its
    signature, a vec of two maps, a non-vec, an empty vec."""
    def entry(k, v):
        return cx.SCMapEntry(key=cx.SCVal(cx.SCValType.SCV_SYMBOL, k), val=v)

    def b(x):
        return cx.SCVal(cx.SCValType.SCV_BYTES, x)

    void = cx.SCVal(cx.SCValType.SCV_VOID)
    good = cx.SCVal(cx.SCValType.SCV_MAP, [entry(b"public_key", b(b"\1" * 32)),
                                           entry(b"signature", b(b"\2" * 64))])
    return [
        cx.SCVal(cx.SCValType.SCV_VEC, [cx.SCVal(cx.SCValType.SCV_MAP, [
            entry(b"public_key", void), entry(b"signature", void)])]),
        good,
        cx.SCVal(cx.SCValType.SCV_MAP, [entry(b"public_key", b(b"\1" * 32))]),
        cx.SCVal(cx.SCValType.SCV_VEC, [good, good]),
        cx.SCVal(cx.SCValType.SCV_U32, 5),
        cx.SCVal(cx.SCValType.SCV_VEC, []),
    ]


def test_auth_tuples_agree_with_malformed_maps():
    """collect_signature_tuples(frames, network_id) is equal in both
    packages on the phase-11 mix and on address credentials with the
    malformed signature maps of tests/test_soroban.py:616-666 and more;
    without a network id it holds the envelope tuples alone."""
    wl = chip_smoke.soroban_workload(20)
    envs = list(wl["envelopes"])
    pair = Pair()
    holder = pair.fresh()
    cid = b"\x21" * 32
    for sig_val in _malformed_maps():
        entry = _address_auth(holder.key, cid, "auth_bump", [], 3, 10_000)
        entry.credentials.value.signature = sig_val
        body = _invoke(cid, "auth_bump", [], auth=[entry, _source_auth(
            entry.rootInvocation)])
        tx = Transaction(
            sourceAccount=holder.muxed, fee=100, seqNum=holder.next_seq(),
            cond=Preconditions(PreconditionType.PRECOND_NONE),
            memo=Memo(MemoType.MEMO_NONE),
            operations=[Operation(sourceAccount=None, body=body)],
            ext=_TxExt(0))
        env = TransactionEnvelope(EnvelopeType.ENVELOPE_TYPE_TX,
                                  TransactionV1Envelope(tx=tx, signatures=[]))
        frame = J.frame.make_frame(env, NETWORK_ID)
        sign_frame(frame, holder.key)
        envs.append(frame.envelope.to_bytes())
    for nid in (None, wl["network_id"], NETWORK_ID):
        got = [pkg.checker.collect_signature_tuples(
            [frame_of(pkg, e, nid or NETWORK_ID) for e in envs], nid)
            for pkg in (J, P)]
        assert got[0] == got[1]
        assert all(len(p) == 32 and len(s) == 64 and len(m) == 32
                   for p, s, m in got[1])
    auth = len(got[1]) - len(envs)
    kinds = wl["kinds"]
    assert auth == sum(k in ("sac_addr", "scvm", "bad_auth", "expired")
                       for k in kinds) + 3


# --------------------------------------------------- phase 11 at n = 40 --

def test_phase11_mix_matches_jax_with_invariants():
    """chip_smoke.py phase 11's workload at 40 transactions through both
    packages' txset path with every default invariant enabled (they
    hold on this mix in the JAX package, so phase 11 runs with them):
    validation through the herder's prevalidator, then catchup's
    apply-time batch written through to the verify cache, on the port's
    plain kernels (CudaBatchVerifier on the CPU) and on the oracle for
    the JAX package. Equal sets, verdicts, trim, batches, results and
    ledgers; every auth verify of the host's is a cache hit."""
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier
    wl = chip_smoke.soroban_workload(40)
    nid = wl["network_id"]
    jroot = jax_root_from_xdr(wl["header"], wl["entries"])
    proot = P.ledger_txn.InMemoryLedgerTxnRoot.from_xdr(wl["header"],
                                                        wl["entries"])
    assert state_of(jroot) == state_of(proot)
    oracle = OracleVerifier()
    jout = run_set(J, jroot, wl["envelopes"], oracle, nid,
                   apply_batch=oracle, invariants=True)
    card = chip_smoke.RecordingVerifier(CudaBatchVerifier(device="cpu"))
    pout = run_set(P, proot, wl["envelopes"], card, nid, apply_batch=card,
                   invariants=True)
    assert pout == jout
    assert [len(c[0]) for c in card.calls] == [40, 76]
    assert [c[1].count(False) for c in card.calls] == [1, 1]
    assert pout["apply_cache"] == (36, 0) and len(pout["dropped"]) == 1
    assert pout["applied"].count(False) == 2 and set(wl["kinds"]) == {
        "sac_addr", "sac_source", "scvm", "bad_auth", "expired", "flipped"}
