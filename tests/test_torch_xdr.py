"""The port's XDR layer against the JAX package's, on the CPU.

Values are built with the JAX package (tests/txtest_utils.py and real
applied operations), their bytes go through the port's `from_bytes` /
`to_bytes` and must come back byte for byte, with equal contents and
full hashes. Corrupted bytes must fail, or re-encode, alike in both.
tests/test_torch_xdr_leaves.py covers the rest of the XDR layer."""

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from stellar_core_tpu.crypto.keys import SecretKey
from stellar_core_tpu.xdr.ledger_entries import (
    Asset, AssetType, Claimant, ClaimantV0, ClaimableBalanceEntry,
    ClaimableBalanceID, ClaimableBalanceIDType, ClaimPredicate,
    ClaimPredicateType, LedgerEntry, LedgerEntryType, Price, Signer,
    _LedgerEntryData)
from stellar_core_tpu.xdr.transaction import (
    FeeBumpTransaction, FeeBumpTransactionEnvelope,
    LedgerBounds, Memo, MemoType, MuxedAccount, Preconditions,
    PreconditionsV2, PreconditionType, TimeBounds, Transaction,
    TransactionEnvelope, TransactionV0, TransactionV0Envelope,
    TransactionV1Envelope, _FeeBumpInnerTx, _MuxedAccountMed25519, _TxExt)
from stellar_core_tpu.xdr.types import (CryptoKeyType, Ed25519SignedPayload,
                                        EnvelopeType, PublicKey, SignerKey,
                                        SignerKeyType)

from torch_tx_parity import J, NETWORK_ID, P, XLM, clear_caches, port_root
from txtest_utils import (TEST_NETWORK_ID, TestAccount, TestLedger,
                          make_asset, make_header, op_change_trust,
                          op_create_account, op_manage_data,
                          op_manage_sell_offer, op_payment, op_set_options,
                          sign_frame)


@pytest.fixture(autouse=True)
def _fresh_verify_caches():
    clear_caches()
    yield
    clear_caches()


def _key(n):
    return SecretKey.from_seed(hashlib.sha256(b"xdr parity %d" % n).digest())


def _roundtrip(jax_value, port_cls):
    """The JAX value's bytes through the port's class: decoded, encoded
    back, and compared."""
    b = jax_value.to_bytes()
    pv = port_cls.from_bytes(b)
    assert pv.to_bytes() == b
    assert pv.clone().to_bytes() == b
    assert port_cls.from_bytes(b) == pv
    return pv


# ------------------------------------------------------------- envelopes --

def _v1(src, ops, memo=None, cond=None, signers=(), source=None):
    """A v1 envelope of `src` (seq 7 << 32 + 1) signed by src and
    `signers`, as the JAX frame the tests take hashes from."""
    tx = Transaction(
        sourceAccount=source or MuxedAccount.from_ed25519(
            src.public_key().raw),
        fee=100 * len(ops), seqNum=(7 << 32) + 1,
        cond=cond or Preconditions(PreconditionType.PRECOND_NONE),
        memo=memo or Memo(MemoType.MEMO_NONE), operations=list(ops),
        ext=_TxExt(0))
    env = TransactionEnvelope(EnvelopeType.ENVELOPE_TYPE_TX,
                              TransactionV1Envelope(tx=tx, signatures=[]))
    frame = J.frame.make_frame(env, TEST_NETWORK_ID)
    for sk in (src, *signers):
        sign_frame(frame, sk)
    return frame


def _dest(n=2):
    return MuxedAccount.from_ed25519(_key(n).public_key().raw)


def _pay(n=2, amount=XLM):
    return op_payment(_dest(n), amount)


def env_plain():
    return _v1(_key(1), [_pay()]).envelope


def env_memo_text():
    return _v1(_key(1), [_pay()], memo=Memo(MemoType.MEMO_TEXT,
                                            b"twenty-eight bytes of memo!!")
               ).envelope


def env_memo_id():
    return _v1(_key(1), [_pay()],
               memo=Memo(MemoType.MEMO_ID, 2**64 - 1)).envelope


def env_memo_hash():
    return _v1(_key(1), [_pay()],
               memo=Memo(MemoType.MEMO_HASH, b"\x11" * 32)).envelope


def env_memo_return():
    return _v1(_key(1), [_pay()],
               memo=Memo(MemoType.MEMO_RETURN, b"\x22" * 32)).envelope


def env_time_bounds():
    cond = Preconditions(PreconditionType.PRECOND_TIME,
                         TimeBounds(minTime=5, maxTime=2**40))
    return _v1(_key(1), [_pay()], cond=cond).envelope


def env_precond_v2():
    sp = Ed25519SignedPayload(ed25519=_key(4).public_key().raw,
                              payload=b"signed payload")
    cond = Preconditions(PreconditionType.PRECOND_V2, PreconditionsV2(
        timeBounds=TimeBounds(minTime=0, maxTime=2**33),
        ledgerBounds=LedgerBounds(minLedger=1, maxLedger=900),
        minSeqNum=3, minSeqAge=60, minSeqLedgerGap=2,
        extraSigners=[
            SignerKey(SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                      _key(3).public_key().raw),
            SignerKey(SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD,
                      sp)]))
    return _v1(_key(1), [_pay()], cond=cond, signers=[_key(3)]).envelope


def env_muxed_source():
    return _v1(_key(1), [_pay()], source=MuxedAccount(
        CryptoKeyType.KEY_TYPE_MUXED_ED25519,
        _MuxedAccountMed25519(id=99, ed25519=_key(1).public_key().raw))
    ).envelope


def env_many_ops():
    usd = make_asset(b"USD", PublicKey.ed25519(_key(5).public_key().raw))
    ops = [_pay(), op_create_account(
        PublicKey.ed25519(_key(6).public_key().raw), 10 * XLM),
        op_change_trust(usd, 10**12), op_manage_data(b"k", b"v"),
        op_manage_data(b"gone", None),
        op_manage_sell_offer(usd, Asset(AssetType.ASSET_TYPE_NATIVE), 5,
                             Price(n=3, d=7)),
        op_set_options(masterWeight=2, homeDomain=b"example.org",
                       signer=Signer(key=SignerKey(
                           SignerKeyType.SIGNER_KEY_TYPE_HASH_X,
                           b"\x33" * 32), weight=1)),
        op_payment(_dest(7), 3, usd, source=MuxedAccount.from_ed25519(
            _key(8).public_key().raw))]
    return _v1(_key(1), ops, signers=[_key(8)]).envelope


def env_v0():
    v0 = TransactionV0(sourceAccountEd25519=_key(1).public_key().raw,
                       fee=100, seqNum=(7 << 32) + 1,
                       timeBounds=TimeBounds(minTime=0, maxTime=10**10),
                       memo=Memo(MemoType.MEMO_ID, 5), operations=[_pay()],
                       ext=_TxExt(0))
    env = TransactionEnvelope(EnvelopeType.ENVELOPE_TYPE_TX_V0,
                              TransactionV0Envelope(tx=v0, signatures=[]))
    frame = J.frame.make_frame(env, TEST_NETWORK_ID)
    sign_frame(frame, _key(1))
    return env


def env_fee_bump():
    inner = _v1(_key(1), [_pay()]).envelope
    fb = FeeBumpTransactionEnvelope(tx=FeeBumpTransaction(
        feeSource=MuxedAccount.from_ed25519(_key(9).public_key().raw),
        fee=1000, innerTx=_FeeBumpInnerTx(EnvelopeType.ENVELOPE_TYPE_TX,
                                          inner.value),
        ext=_TxExt(0)), signatures=[])
    env = TransactionEnvelope(EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP, fb)
    frame = J.frame.make_frame(env, TEST_NETWORK_ID)
    sign_frame(frame, _key(9))
    return env


ENVELOPES = {f.__name__[4:]: f for f in (
    env_plain, env_memo_text, env_memo_id, env_memo_hash, env_memo_return,
    env_time_bounds, env_precond_v2, env_muxed_source, env_many_ops, env_v0,
    env_fee_bump)}


def _port_contents_hash(env):
    """The port's signed hash built by hand (the port has no frame for
    most op types): SHA256(networkId ‖ tagged tx), v0 bodies upgraded."""
    T = P.transaction
    if env.disc == EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP:
        tagged = T._TaggedTransaction(EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP,
                                      env.value.tx)
    elif env.disc == EnvelopeType.ENVELOPE_TYPE_TX_V0:
        tagged = T._TaggedTransaction(EnvelopeType.ENVELOPE_TYPE_TX,
                                      P.frame._v0_to_v1_tx(env.value.tx))
    else:
        tagged = T._TaggedTransaction(EnvelopeType.ENVELOPE_TYPE_TX,
                                      env.value.tx)
    return hashlib.sha256(T.TransactionSignaturePayload(
        networkId=TEST_NETWORK_ID, taggedTransaction=tagged).to_bytes()
    ).digest()


@pytest.mark.parametrize("kind", sorted(ENVELOPES))
def test_envelope_roundtrip_and_hashes(kind):
    jenv = ENVELOPES[kind]()
    penv = _roundtrip(jenv, P.transaction.TransactionEnvelope)
    jframe = J.frame.make_frame(jenv, TEST_NETWORK_ID)
    assert _port_contents_hash(penv) == jframe.contents_hash()
    assert hashlib.sha256(penv.to_bytes()).digest() == jframe.full_hash()
    pframe = P.frame.make_frame(penv, TEST_NETWORK_ID)
    assert pframe.contents_hash() == jframe.contents_hash()
    assert pframe.full_hash() == jframe.full_hash()
    assert pframe.source_id.to_bytes() == jframe.source_id.to_bytes()
    assert pframe.fee_source_id.to_bytes() == \
        jframe.fee_source_id.to_bytes()
    assert pframe.num_operations() == jframe.num_operations()


def env_invoke_host_function():
    """An InvokeHostFunction envelope with an address-credential auth
    entry and Soroban resources in the tx ext (xdr/contract.py)."""
    from stellar_core_tpu.xdr import contract as cx
    from stellar_core_tpu.xdr.transaction import Operation, OperationType
    from stellar_core_tpu.xdr.transaction import _OperationBody
    src = _key(1).public_key().raw
    invoke = cx.InvokeContractArgs(
        contractAddress=cx.SCAddress(
            cx.SCAddressType.SC_ADDRESS_TYPE_CONTRACT, b"\x21" * 32),
        functionName=b"transfer", args=[cx.SCVal(cx.SCValType.SCV_U32, 7)])
    auth = cx.SorobanAuthorizationEntry(
        credentials=cx.SorobanCredentials(
            cx.SorobanCredentialsType.SOROBAN_CREDENTIALS_ADDRESS,
            cx.SorobanAddressCredentials(
                address=cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_ACCOUNT,
                                     PublicKey.ed25519(src)),
                nonce=5, signatureExpirationLedger=100,
                signature=cx.SCVal(cx.SCValType.SCV_VOID))),
        rootInvocation=cx.SorobanAuthorizedInvocation(
            function=cx.SorobanAuthorizedFunction(
                cx.SorobanAuthorizedFunctionType
                .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CONTRACT_FN, invoke),
            subInvocations=[]))
    op = Operation(sourceAccount=None, body=_OperationBody(
        OperationType.INVOKE_HOST_FUNCTION, cx.InvokeHostFunctionOp(
            hostFunction=cx.HostFunction(
                cx.HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT,
                invoke), auth=[auth])))
    frame = _v1(_key(1), [op])
    frame.envelope.value.tx.ext = _TxExt(1, cx.SorobanTransactionData(
        resources=cx.SorobanResources(
            footprint=cx.LedgerFootprint(readOnly=[], readWrite=[]),
            instructions=1000, readBytes=10, writeBytes=10),
        resourceFee=100))
    return frame.envelope


def test_frame_for_unported_op_type_raises():
    """No op type is left unported: both registries hold a frame for
    every OperationType, of the same class, and a claimable-balance and
    a Soroban envelope build frames in the port as in the JAX package
    (the name is from when op types were still left out)."""
    from stellar_core_tpu.xdr.transaction import (CreateClaimableBalanceOp,
                                                  Operation, OperationType,
                                                  _OperationBody)
    jreg, preg = J.op_frame._REGISTRY, P.op_frame._REGISTRY
    assert len(preg) == len(P.transaction.OperationType) == len(jreg)
    assert {int(k): c.__name__ for k, c in preg.items()} == \
        {int(k): c.__name__ for k, c in jreg.items()}
    op = Operation(sourceAccount=None, body=_OperationBody(
        OperationType.CREATE_CLAIMABLE_BALANCE, CreateClaimableBalanceOp(
            asset=Asset(AssetType.ASSET_TYPE_NATIVE), amount=XLM,
            claimants=[])))
    for jenv in (_v1(_key(1), [op]).envelope, env_invoke_host_function()):
        penv = _roundtrip(jenv, P.transaction.TransactionEnvelope)
        pframe = P.frame.make_frame(penv, TEST_NETWORK_ID)
        jframe = J.frame.make_frame(jenv, TEST_NETWORK_ID)
        assert [type(o).__name__ for o in pframe.op_frames] == \
            [type(o).__name__ for o in jframe.op_frames]
        assert pframe.full_hash() == jframe.full_hash()


# ---------------------------------------------------------- ledger state --

@pytest.fixture(scope="module")
def rich():
    """A JAX ledger after real operations: signers of all four types,
    a trustline with liabilities, an offer, a data entry, ext v1-v3
    accounts; plus a claimable balance with a nested predicate. Keeps
    the frames whose results the result tests round-trip."""
    led = TestLedger()
    root = led.root_account
    a, b, issuer = (TestAccount.fresh(led) for _ in range(3))
    for acct in (a, b, issuer):
        assert root.create(acct, 1000 * XLM)
        acct.sync_seq()
    usd = make_asset(b"USD", issuer.account_id)
    frames = {}

    def run(name, acct, ops, **kw):
        frame = acct.tx(ops, **kw)
        led.apply_tx(frame)
        frames[name] = frame

    sp = Ed25519SignedPayload(ed25519=_key(11).public_key().raw,
                              payload=b"payload")
    for key in (SignerKey(SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                          b.key.public_key().raw),
                SignerKey(SignerKeyType.SIGNER_KEY_TYPE_HASH_X, b"\x44" * 32),
                SignerKey(SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX,
                          b"\x55" * 32),
                SignerKey(SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD,
                          sp)):
        run("set_options", a, [op_set_options(signer=Signer(key=key,
                                                            weight=1))])
    run("home_domain", a, [op_set_options(
        homeDomain=b"a.example", lowThreshold=1, medThreshold=1,
        highThreshold=2, inflationDest=b.account_id)])
    run("change_trust", a, [op_change_trust(usd, 10**13)])
    run("issue", issuer, [op_payment(a.muxed, 500 * XLM, usd)])
    run("data", a, [op_manage_data(b"greeting", b"hello")])
    run("offer", a, [op_manage_sell_offer(
        usd, Asset(AssetType.ASSET_TYPE_NATIVE), 7 * XLM, Price(n=2, d=3))])
    run("pay", b, [op_payment(a.muxed, 3 * XLM)])
    run("underfunded", b, [op_payment(a.muxed, 10**6 * XLM)])
    run("bad_seq", b, [op_payment(a.muxed, XLM)], seq=b.seq + 5)
    b.sync_seq()
    inner = b.tx([op_payment(a.muxed, 2 * XLM)])
    fb = FeeBumpTransactionEnvelope(tx=FeeBumpTransaction(
        feeSource=issuer.muxed, fee=1000,
        innerTx=_FeeBumpInnerTx(EnvelopeType.ENVELOPE_TYPE_TX,
                                inner.envelope.value), ext=_TxExt(0)),
        signatures=[])
    fee_bump = J.frame.make_frame(TransactionEnvelope(
        EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP, fb), TEST_NETWORK_ID)
    sign_frame(fee_bump, issuer.key)
    led.apply_tx(fee_bump)
    frames["fee_bump"] = fee_bump
    P_ = ClaimPredicate
    T_ = ClaimPredicateType
    pred = P_(T_.CLAIM_PREDICATE_AND, [
        P_(T_.CLAIM_PREDICATE_OR, [
            P_(T_.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME, 1_800_000_000),
            P_(T_.CLAIM_PREDICATE_NOT,
               P_(T_.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME, 3600))]),
        P_(T_.CLAIM_PREDICATE_UNCONDITIONAL)])
    cb = ClaimableBalanceEntry(
        balanceID=ClaimableBalanceID(
            ClaimableBalanceIDType.CLAIMABLE_BALANCE_ID_TYPE_V0,
            b"\x66" * 32),
        claimants=[Claimant(0, ClaimantV0(destination=b.account_id,
                                          predicate=pred))],
        asset=usd, amount=12345)
    claimable = LedgerEntry(lastModifiedLedgerSeq=2, data=_LedgerEntryData(
        LedgerEntryType.CLAIMABLE_BALANCE, cb))
    return SimpleNamespace(ledger=led, a=a, frames=frames,
                           claimable=claimable)


def _entry(rich, kind):
    if kind == "claimable_balance":
        return rich.claimable
    want = {"account_signers": LedgerEntryType.ACCOUNT,
            "trustline": LedgerEntryType.TRUSTLINE,
            "offer": LedgerEntryType.OFFER,
            "data": LedgerEntryType.DATA}[kind]
    for e in rich.ledger.root._entries.values():
        if e.data.disc == want and (want != LedgerEntryType.ACCOUNT or
                                    len(e.data.value.signers) == 4):
            return e
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["account_signers", "trustline", "offer",
                                  "data", "claimable_balance"])
def test_ledger_entry_roundtrip(rich, kind):
    e = _entry(rich, kind)
    pe = _roundtrip(e, P.entries.LedgerEntry)
    assert P.entries.ledger_entry_key(pe).to_bytes() == \
        J.entries.ledger_entry_key(e).to_bytes()
    if kind == "account_signers":
        acc = pe.data.value
        assert acc.ext.disc == 1 and acc.ext.value.ext.disc == 2   # v1 -> v2
        assert [s.key.disc for s in acc.signers] == \
            [s.key.disc for s in e.data.value.signers]


def test_every_entry_of_a_ledger_crosses(rich):
    """from_xdr carries the whole JAX ledger: the same keys, entries and
    header bytes, and LedgerTxn loads on both sides agree."""
    jroot = rich.ledger.root
    proot = port_root(jroot)
    assert proot.get_header().to_bytes() == jroot.get_header().to_bytes()
    assert sorted(proot._entries) == sorted(jroot._entries)
    for kb, e in jroot._entries.items():
        assert proot._entries[kb].to_bytes() == e.to_bytes()
    key = P.entries.LedgerKey.account(
        P.types.PublicKey.ed25519(rich.a.key.public_key().raw))
    with P.ledger_txn.LedgerTxn(proot) as ltx:
        assert ltx.load_without_record(key).to_bytes() == \
            rich.ledger.root._entries[key.to_bytes()].to_bytes()


def test_from_xdr_rejects_a_duplicate_entry(rich):
    e = _entry(rich, "data").to_bytes()
    hb = rich.ledger.root.get_header().to_bytes()
    with pytest.raises(RuntimeError, match="duplicate"):
        P.ledger_txn.InMemoryLedgerTxnRoot.from_xdr(hb, [e, e])


@pytest.mark.parametrize("variant", ["default", "upgrades_signed", "ext_v1"])
def test_header_roundtrip(variant):
    h = make_header(ledger_version=21, ledger_seq=77)
    h.previousLedgerHash = b"\x01" * 32
    h.skipList = [bytes([i]) * 32 for i in range(4)]
    h.feePool, h.idPool, h.inflationSeq = 12345, 678, 9
    if variant == "upgrades_signed":
        up = J.ledger.LedgerUpgrade(
            J.ledger.LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE, 200)
        h.scpValue.upgrades = [up.to_bytes()]
        h.scpValue.ext = J.ledger._StellarValueExt(
            J.ledger.StellarValueType.STELLAR_VALUE_SIGNED,
            J.ledger.LedgerCloseValueSignature(
                nodeID=PublicKey.ed25519(b"\x02" * 32),
                signature=b"\x03" * 64))
    elif variant == "ext_v1":
        h.ext = J.ledger._LedgerHeaderExt(
            1, J.ledger.LedgerHeaderExtensionV1(flags=7))
    ph = _roundtrip(h, P.ledger.LedgerHeader)
    assert hashlib.sha256(ph.to_bytes()).digest() == \
        hashlib.sha256(h.to_bytes()).digest()
    for up in ph.scpValue.upgrades:
        assert P.ledger.LedgerUpgrade.from_bytes(up).to_bytes() == up


@pytest.mark.parametrize("name", ["set_options", "change_trust", "issue",
                                  "data", "offer", "pay", "underfunded",
                                  "bad_seq", "fee_bump"])
def test_transaction_result_roundtrip(rich, name):
    res = rich.frames[name].result
    pr = _roundtrip(res, P.results.TransactionResult)
    assert pr.result.disc == res.result.disc
    pair = J.results.TransactionResultPair(
        transactionHash=rich.frames[name].full_hash(), result=res)
    _roundtrip(pair, P.results.TransactionResultPair)


@pytest.mark.parametrize("version", [19, 21])
def test_tx_set_wire_roundtrip(version):
    """Legacy (protocol 19) and generalized (protocol 21) wire sets: the
    same bytes and contents hash on both sides."""
    led = TestLedger(ledger_version=version)
    frames = [TestAccount(led, _key(20 + i)).tx([_pay(30 + i)])
              for i in range(5)]
    for f in frames:
        f.tx.seqNum = 1
    jf, _, _ = J.tx_set.make_tx_set_from_transactions(
        frames, led.header(), TEST_NETWORK_ID)
    cls = P.ledger.GeneralizedTransactionSet if version >= 20 \
        else P.ledger.TransactionSet
    pset = _roundtrip(jf.to_xdr(), cls)
    pf = P.tx_set.TxSetFrame(pset, TEST_NETWORK_ID)
    assert pf.get_contents_hash() == jf.get_contents_hash()
    assert pf.size_tx_total() == 5


# ------------------------------------------------------------- bad bytes --

def _outcome(cls, data):
    try:
        return ("ok", cls.from_bytes(data).to_bytes())
    except Exception as e:          # noqa: BLE001 — compared by kind
        return ("error", type(e).__name__)


@pytest.mark.parametrize("seed", range(6))
def test_corrupted_envelopes_fail_or_reencode_alike(seed):
    """Seeded byte flips, truncations and appended bytes: both packages
    reject the same inputs (each with its XdrError) and re-encode the
    rest to the same bytes."""
    rng = np.random.default_rng(seed)
    base = bytearray(ENVELOPES[sorted(ENVELOPES)[seed % len(ENVELOPES)]]()
                     .to_bytes())
    for _ in range(60):
        data = bytearray(base)
        op = rng.integers(3)
        if op == 0:
            for _ in range(int(rng.integers(1, 4))):
                data[int(rng.integers(len(data)))] = int(rng.integers(256))
        elif op == 1:
            data = data[:int(rng.integers(len(data)))]
        else:
            data += bytes(rng.integers(0, 256, int(rng.integers(1, 9)),
                                       dtype=np.uint8))
        j = _outcome(J.transaction.TransactionEnvelope, bytes(data))
        p = _outcome(P.transaction.TransactionEnvelope, bytes(data))
        assert j == p


@pytest.mark.parametrize("data", [
    b"", b"\x00\x00\x00", b"\x00\x00\x00\x07", b"\x00\x00\x00\x02\x00",
    b"\xff\xff\xff\xff" + b"\x00" * 8,
], ids=["empty", "short", "bad_disc", "truncated_body", "negative_disc"])
def test_malformed_envelope_bytes_raise_xdr_error(data):
    with pytest.raises(J.runtime.XdrError):
        J.transaction.TransactionEnvelope.from_bytes(data)
    with pytest.raises(P.runtime.XdrError):
        P.transaction.TransactionEnvelope.from_bytes(data)


def test_nonzero_padding_and_bad_bool_raise():
    memo = Memo(MemoType.MEMO_TEXT, b"abc").to_bytes()
    bad = memo[:-1] + b"\x01"
    for pkg in (J, P):
        with pytest.raises(pkg.runtime.XdrError, match="padding"):
            pkg.transaction.Memo.from_bytes(bad)
        with pytest.raises(pkg.runtime.XdrError, match="bool"):
            pkg.runtime.Bool.unpack(pkg.runtime.Reader(b"\x00\x00\x00\x02"))


# ------------------------------------ Soroban XDR; what waits for later slices --

def test_config_upgrade_waits_for_contract_xdr():
    """A LEDGER_UPGRADE_CONFIG arm needed xdr/contract.py, which the port
    now has: such an upgrade decodes and re-encodes as the JAX package's
    does, and so does the Soroban meta of xdr/ledger.py."""
    from stellar_core_tpu.xdr import contract as cx
    up = J.ledger.LedgerUpgrade(
        J.ledger.LedgerUpgradeType.LEDGER_UPGRADE_CONFIG,
        cx.ConfigUpgradeSetKey(contractID=b"\x31" * 32,
                               contentHash=b"\x32" * 32))
    pu = _roundtrip(up, P.ledger.LedgerUpgrade)
    assert pu.value.contractID == b"\x31" * 32
    meta = J.ledger.SorobanTransactionMeta(
        events=[cx.ContractEvent(
            contractID=b"\x33" * 32, type=cx.ContractEventType.CONTRACT,
            body=cx._ContractEventBody(0, cx._ContractEventV0(
                topics=[cx.SCVal(cx.SCValType.SCV_SYMBOL, b"transfer")],
                data=cx.SCVal(cx.SCValType.SCV_I64, -3))))],
        returnValue=cx.SCVal(cx.SCValType.SCV_BOOL, True))
    _roundtrip(meta, P.ledger.SorobanTransactionMeta)


def test_soroban_auth_tuples_wait_for_the_soroban_slice():
    """The Soroban slice has landed: with a network id the port collects
    the auth-entry tuples of an INVOKE_HOST_FUNCTION op as the JAX
    package does (a void signature map yields none), and without one the
    envelope tuples alone, equal in both."""
    frame = P.frame.make_frame(P.transaction.TransactionEnvelope.from_bytes(
        env_plain().to_bytes()), TEST_NETWORK_ID)
    jframe = J.frame.make_frame(env_plain(), TEST_NETWORK_ID)
    assert P.checker.collect_signature_tuples([frame]) == \
        J.checker.collect_signature_tuples([jframe])
    assert P.checker.collect_signature_tuples([frame], NETWORK_ID) == \
        J.checker.collect_signature_tuples([jframe], NETWORK_ID)
    jenv = env_invoke_host_function()
    pinvoke = P.frame.make_frame(P.transaction.TransactionEnvelope.from_bytes(
        jenv.to_bytes()), TEST_NETWORK_ID)
    jinvoke = J.frame.make_frame(jenv, TEST_NETWORK_ID)
    for nid in (None, NETWORK_ID):
        got = P.checker.collect_signature_tuples([pinvoke], nid)
        assert got == J.checker.collect_signature_tuples([jinvoke], nid)
        assert got == P.checker.collect_signature_tuples([pinvoke])
