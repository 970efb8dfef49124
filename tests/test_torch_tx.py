"""The port's transaction layer against the JAX package's, on the CPU.

Each scenario sets up its ledger with the JAX package (operations the
port has no frame for yet, such as SetOptions, run there), then carries
the ledger into the port with `InMemoryLedgerTxnRoot.from_xdr` and the
transactions under test as envelope bytes. Both packages run check_valid
and then fee + apply on their own copy: the result bytes of both steps
and every ledger entry afterwards must be equal. The signer scenarios are
those of tests/test_signer_types.py; the payment scenarios cover the
Payment frame and the transaction-level rules in front of it."""

import hashlib

import numpy as np
import pytest

from stellar_core_tpu.crypto.keys import SecretKey
from stellar_core_tpu.xdr.ledger_entries import Signer
from stellar_core_tpu.xdr.results import TransactionResultCode as RC
from stellar_core_tpu.xdr.transaction import (
    DecoratedSignature, FeeBumpTransaction, FeeBumpTransactionEnvelope,
    MuxedAccount, Preconditions, PreconditionsV2, PreconditionType,
    TimeBounds, TransactionEnvelope, _FeeBumpInnerTx, _MuxedAccountMed25519,
    _TxExt)
from stellar_core_tpu.xdr.types import (CryptoKeyType, Ed25519SignedPayload,
                                        EnvelopeType, SignerKey,
                                        SignerKeyType)

from torch_tx_parity import (J, P, check_then_apply, clear_caches,
                             jax_root_copy, port_root)
from txtest_utils import (TEST_NETWORK_ID, TestAccount, TestLedger,
                          make_asset, op_change_trust, op_payment,
                          op_set_options, sign_frame, signed_payload_hint)

XLM = 10_000_000


@pytest.fixture(autouse=True)
def _fresh_verify_caches():
    clear_caches()
    yield
    clear_caches()


def _replace_sigs(frame, sigs):
    frame.signatures[:] = list(sigs)
    frame.envelope.value.signatures = frame.signatures


def _add_sig(frame, ds):
    frame.signatures.append(ds)
    frame.envelope.value.signatures = frame.signatures


def _mk(led):
    root = led.root_account
    a, b = TestAccount.fresh(led), TestAccount.fresh(led)
    assert root.create(a, 100 * XLM)
    assert root.create(b, 100 * XLM)
    a.sync_seq()
    b.sync_seq()
    return a, b


def _hash_x(preimage):
    hx = hashlib.sha256(preimage).digest()
    return hx, SignerKey(SignerKeyType.SIGNER_KEY_TYPE_HASH_X, hx)


def _payload_signer(acct, payload):
    return SignerKey(SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD,
                     Ed25519SignedPayload(ed25519=acct.key.public_key().raw,
                                          payload=payload))


def _payload_sig(acct, payload, signed=None):
    return DecoratedSignature(
        hint=signed_payload_hint(acct.key.public_key().raw, payload),
        signature=acct.key.sign(payload if signed is None else signed))


def _fee_bump(led, inner, payer, fee=1000):
    fb = FeeBumpTransactionEnvelope(tx=FeeBumpTransaction(
        feeSource=payer.muxed, fee=fee,
        innerTx=_FeeBumpInnerTx(EnvelopeType.ENVELOPE_TYPE_TX,
                                inner.envelope.value),
        ext=_TxExt(0)), signatures=[])
    frame = J.frame.make_frame(TransactionEnvelope(
        EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP, fb), TEST_NETWORK_ID)
    sign_frame(frame, payer.key)
    return frame


# Each scenario: (ledger) -> (frames in order, result code of each after
# apply, as tests/test_signer_types.py and the reference expect).
SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ------------------------------------------------------------- signer rules --

@scenario
def hash_x_authorizes(led):
    a, b = _mk(led)
    preimage = b"open sesame, 32 bytes or longer!"
    hx, key = _hash_x(preimage)
    assert a.apply([op_set_options(signer=Signer(key=key, weight=1))])
    f = a.tx([op_payment(b.muxed, XLM)])
    _replace_sigs(f, [DecoratedSignature(hint=hx[28:], signature=preimage)])
    return [f], [RC.txSUCCESS]


@scenario
def hash_x_wrong_preimage(led):
    a, b = _mk(led)
    hx, key = _hash_x(b"the real preimage")
    assert a.apply([op_set_options(signer=Signer(key=key, weight=1))])
    f = a.tx([op_payment(b.muxed, XLM)])
    _replace_sigs(f, [DecoratedSignature(hint=hx[28:], signature=b"not it")])
    return [f], [RC.txBAD_AUTH]


@scenario
def hash_x_longest_preimage(led):
    """64 bytes, the most a DecoratedSignature holds on the wire (a
    65-byte one cannot be encoded: see the checker test below)."""
    a, b = _mk(led)
    preimage = b"x" * 64
    hx, key = _hash_x(preimage)
    assert a.apply([op_set_options(signer=Signer(key=key, weight=1))])
    f = a.tx([op_payment(b.muxed, XLM)])
    _replace_sigs(f, [DecoratedSignature(hint=hx[28:], signature=preimage)])
    return [f], [RC.txSUCCESS]


@scenario
def hash_x_hint_must_match(led):
    a, b = _mk(led)
    hx, key = _hash_x(b"hinted")
    assert a.apply([op_set_options(signer=Signer(key=key, weight=1))])
    f = a.tx([op_payment(b.muxed, XLM)])
    _replace_sigs(f, [DecoratedSignature(
        hint=bytes(x ^ 0xFF for x in hx[28:]), signature=b"hinted")])
    return [f], [RC.txBAD_AUTH]


@scenario
def pre_auth_applies_unsigned_and_is_consumed(led):
    a, b = _mk(led)
    future = a.tx([op_payment(b.muxed, XLM)], seq=a.seq + 2)
    _replace_sigs(future, [])
    key = SignerKey(SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX,
                    future.contents_hash())
    assert a.apply([op_set_options(signer=Signer(key=key, weight=1))])
    return [future], [RC.txSUCCESS]


@scenario
def pre_auth_other_tx_not_authorized(led):
    a, b = _mk(led)
    future = a.tx([op_payment(b.muxed, XLM)], seq=a.seq + 2)
    _replace_sigs(future, [])
    key = SignerKey(SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX,
                    future.contents_hash())
    assert a.apply([op_set_options(signer=Signer(key=key, weight=1))])
    other = a.tx([op_payment(b.muxed, 2 * XLM)], seq=a.seq + 1)
    _replace_sigs(other, [])
    return [other], [RC.txBAD_AUTH]


@scenario
def pre_auth_consumed_on_failed_tx(led):
    a, b = _mk(led)
    future = a.tx([op_payment(b.muxed, 10_000 * XLM)], seq=a.seq + 3)
    _replace_sigs(future, [])
    key = SignerKey(SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX,
                    future.contents_hash())
    other = SignerKey(SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX, b"\x42" * 32)
    assert a.apply([op_set_options(signer=Signer(key=key, weight=1))])
    assert a.apply([op_set_options(signer=Signer(key=other, weight=1))])
    return [future], [RC.txFAILED]


@scenario
def signed_payload_authorizes(led):
    a, b = _mk(led)
    c = TestAccount.fresh(led)
    payload = b"this exact payload"
    assert a.apply([op_set_options(signer=Signer(
        key=_payload_signer(c, payload), weight=1))])
    f = a.tx([op_payment(b.muxed, XLM)])
    _replace_sigs(f, [_payload_sig(c, payload)])
    return [f], [RC.txSUCCESS]


@scenario
def signed_payload_short_hint_pads(led):
    a, b = _mk(led)
    c = TestAccount.fresh(led)
    payload = b"xy"
    assert a.apply([op_set_options(signer=Signer(
        key=_payload_signer(c, payload), weight=1))])
    f = a.tx([op_payment(b.muxed, XLM)])
    _replace_sigs(f, [_payload_sig(c, payload)])
    return [f], [RC.txSUCCESS]


@scenario
def signed_payload_tx_hash_signature_does_not_match(led):
    a, b = _mk(led)
    c = TestAccount.fresh(led)
    payload = b"expected payload"
    assert a.apply([op_set_options(signer=Signer(
        key=_payload_signer(c, payload), weight=1))])
    f = a.tx([op_payment(b.muxed, XLM)])
    _replace_sigs(f, [_payload_sig(c, payload, signed=f.contents_hash())])
    return [f], [RC.txBAD_AUTH]


@scenario
def signed_payload_wrong_signer_key(led):
    a, b = _mk(led)
    c, d = TestAccount.fresh(led), TestAccount.fresh(led)
    payload = b"payload"
    assert a.apply([op_set_options(signer=Signer(
        key=_payload_signer(c, payload), weight=1))])
    f = a.tx([op_payment(b.muxed, XLM)])
    _replace_sigs(f, [DecoratedSignature(
        hint=signed_payload_hint(c.key.public_key().raw, payload),
        signature=d.key.sign(payload))])
    return [f], [RC.txBAD_AUTH]


@scenario
def hash_x_plus_master_reach_threshold(led):
    a, b = _mk(led)
    preimage = b"second factor"
    hx, key = _hash_x(preimage)
    assert a.apply([op_set_options(signer=Signer(key=key, weight=1),
                                   masterWeight=1, medThreshold=2)])
    alone = a.tx([op_payment(b.muxed, XLM)])
    both = a.tx([op_payment(b.muxed, XLM)])
    _add_sig(both, DecoratedSignature(hint=hx[28:], signature=preimage))
    return [alone, both], [RC.txFAILED, RC.txSUCCESS]


@scenario
def unused_alternate_signature_is_bad_auth_extra(led):
    a, b = _mk(led)
    hx, _ = _hash_x(b"nobody registered this")
    f = a.tx([op_payment(b.muxed, XLM)])
    _add_sig(f, DecoratedSignature(hint=hx[28:],
                                   signature=b"nobody registered this"))
    return [f], [RC.txBAD_AUTH_EXTRA]


@scenario
def multisig_two_of_two(led):
    a, b = _mk(led)
    c = TestAccount.fresh(led)
    assert a.apply([op_set_options(
        signer=Signer(key=SignerKey(SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                                    c.key.public_key().raw), weight=1),
        masterWeight=1, lowThreshold=1, medThreshold=2, highThreshold=2)])
    only_master = a.tx([op_payment(b.muxed, XLM)])
    both = a.tx([op_payment(b.muxed, XLM)], extra_signers=[c.key])
    return [only_master, both], [RC.txFAILED, RC.txSUCCESS]


@scenario
def master_weight_zero_locks_the_account(led):
    a, b = _mk(led)
    assert a.apply([op_set_options(masterWeight=0)])
    return [a.tx([op_payment(b.muxed, XLM)])], [RC.txBAD_AUTH]


@scenario
def precond_v2_extra_signers(led):
    a, b = _mk(led)
    c = TestAccount.fresh(led)
    extra = SignerKey(SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                      c.key.public_key().raw)

    def cond():
        return Preconditions(PreconditionType.PRECOND_V2, PreconditionsV2(
            minSeqNum=None, extraSigners=[extra]))
    missing = a.tx([op_payment(b.muxed, XLM)], cond=cond())
    # the first fails auth after its seqnum check, so apply consumes it
    signed = a.tx([op_payment(b.muxed, XLM)], cond=cond(),
                  extra_signers=[c.key])
    return [missing, signed], [RC.txBAD_AUTH, RC.txSUCCESS]


@scenario
def fee_bump_valid(led):
    a, b = _mk(led)
    return [_fee_bump(led, a.tx([op_payment(b.muxed, XLM)]), b)], \
        [RC.txFEE_BUMP_INNER_SUCCESS]


@scenario
def fee_bump_inner_bad_seq(led):
    a, b = _mk(led)
    inner = a.tx([op_payment(b.muxed, XLM)], seq=a.seq + 5)
    return [_fee_bump(led, inner, b)], [RC.txFEE_BUMP_INNER_FAILED]


@scenario
def fee_bump_outer_bad_auth(led):
    a, b = _mk(led)
    f = _fee_bump(led, a.tx([op_payment(b.muxed, XLM)]), b)
    _replace_sigs(f, [DecoratedSignature(hint=b.key.public_key().hint(),
                                         signature=a.key.sign(b"x"))])
    return [f], [RC.txBAD_AUTH]


# ----------------------------------------------------------------- payments --

@scenario
def payment_native(led):
    a, b = _mk(led)
    return [a.tx([op_payment(b.muxed, 7 * XLM)])], [RC.txSUCCESS]


@scenario
def payment_no_destination(led):
    a, _ = _mk(led)
    ghost = TestAccount.fresh(led)
    return [a.tx([op_payment(ghost.muxed, XLM)])], [RC.txFAILED]


@scenario
def payment_underfunded(led):
    a, b = _mk(led)
    return [a.tx([op_payment(b.muxed, 500 * XLM)])], [RC.txFAILED]


@scenario
def payment_to_self(led):
    a, _ = _mk(led)
    return [a.tx([op_payment(a.muxed, XLM)])], [RC.txSUCCESS]


@scenario
def payment_malformed_amount(led):
    a, b = _mk(led)
    return [a.tx([op_payment(b.muxed, 0)])], [RC.txFAILED]


@scenario
def payment_muxed_source_and_destination(led):
    a, b = _mk(led)
    f = a.tx([op_payment(MuxedAccount(
        CryptoKeyType.KEY_TYPE_MUXED_ED25519,
        _MuxedAccountMed25519(id=7, ed25519=b.key.public_key().raw)), XLM)])
    f.tx.sourceAccount = MuxedAccount(
        CryptoKeyType.KEY_TYPE_MUXED_ED25519,
        _MuxedAccountMed25519(id=9, ed25519=a.key.public_key().raw))
    _replace_sigs(f, [])
    f._contents_hash = None
    sign_frame(f, a.key)
    return [f], [RC.txSUCCESS]


@scenario
def payment_credit_asset(led):
    a, b = _mk(led)
    issuer = TestAccount.fresh(led)
    assert led.root_account.create(issuer, 100 * XLM)
    issuer.sync_seq()
    usd = make_asset(b"USD", issuer.account_id)
    assert a.apply([op_change_trust(usd, 1000 * XLM)])
    assert b.apply([op_change_trust(usd, 10 * XLM)])
    assert issuer.apply([op_payment(a.muxed, 100 * XLM, usd)])
    ok = a.tx([op_payment(b.muxed, 5 * XLM, usd)])
    full = a.tx([op_payment(b.muxed, 50 * XLM, usd)])
    burn = a.tx([op_payment(issuer.muxed, XLM, usd)])
    c = TestAccount.fresh(led)
    assert led.root_account.create(c, 10 * XLM)
    no_trust = issuer.tx([op_payment(c.muxed, XLM, usd)])
    return [ok, full, burn, no_trust], \
        [RC.txSUCCESS, RC.txFAILED, RC.txSUCCESS, RC.txFAILED]


@scenario
def bad_sequence_number(led):
    a, b = _mk(led)
    return [a.tx([op_payment(b.muxed, XLM)], seq=a.seq + 2)], [RC.txBAD_SEQ]


@scenario
def insufficient_fee(led):
    a, b = _mk(led)
    return [a.tx([op_payment(b.muxed, XLM)], fee=50)], \
        [RC.txINSUFFICIENT_FEE]


@scenario
def too_late(led):
    a, b = _mk(led)
    cond = Preconditions(PreconditionType.PRECOND_TIME,
                         TimeBounds(minTime=0, maxTime=1_000))
    return [a.tx([op_payment(b.muxed, XLM)], cond=cond)], [RC.txTOO_LATE]


@scenario
def too_early(led):
    a, b = _mk(led)
    cond = Preconditions(PreconditionType.PRECOND_TIME,
                         TimeBounds(minTime=2_000_000_000, maxTime=0))
    return [a.tx([op_payment(b.muxed, XLM)], cond=cond)], [RC.txTOO_EARLY]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_jax(name):
    led = TestLedger()
    frames, want = SCENARIOS[name](led)
    jroot, proot = jax_root_copy(led.root), port_root(led.root)
    codes = []
    for f in frames:
        env = f.envelope.to_bytes()
        j = check_then_apply(J, jroot, env)
        p = check_then_apply(P, proot, env)
        assert p == j
        codes.append(J.results.TransactionResult.from_bytes(
            j["result"]).result.disc)
    assert codes == want


# -------------------------------------------------- signature accounting --

def _raw_signer(kind, rng, keys):
    if kind == 0:
        sk = keys[int(rng.integers(len(keys)))]
        return SignerKey(SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                         sk.public_key().raw)
    if kind == 1:
        return SignerKey(SignerKeyType.SIGNER_KEY_TYPE_HASH_X,
                         hashlib.sha256(bytes([int(rng.integers(4))]))
                         .digest())
    if kind == 2:
        return SignerKey(SignerKeyType.SIGNER_KEY_TYPE_PRE_AUTH_TX,
                         bytes([int(rng.integers(2))]) * 32)
    sk = keys[int(rng.integers(len(keys)))]
    return SignerKey(SignerKeyType.SIGNER_KEY_TYPE_ED25519_SIGNED_PAYLOAD,
                     Ed25519SignedPayload(ed25519=sk.public_key().raw,
                                          payload=b"p" * int(rng.integers(
                                              1, 6))))


@pytest.mark.parametrize("seed", range(4))
def test_signature_checker_matches_on_random_signer_sets(seed):
    """Seeded signer sets of every type and weight against seeded
    signature lists (right, wrong and foreign signatures, preimages):
    both checkers give the same verdict and mark the same signatures
    used, call after call on one checker."""
    rng = np.random.default_rng(seed)
    keys = [SecretKey.from_seed(bytes([seed, i]) * 16) for i in range(3)]
    contents = bytes([1]) * 32
    for _ in range(25):
        signers = [(_raw_signer(int(rng.integers(4)), rng, keys),
                    int(rng.integers(0, 300)))
                   for _ in range(int(rng.integers(1, 5)))]
        sigs = []
        for _ in range(int(rng.integers(0, 4))):
            pick = int(rng.integers(4))
            sk = keys[int(rng.integers(len(keys)))]
            if pick == 0:
                sigs.append(DecoratedSignature(hint=sk.public_key().hint(),
                                               signature=sk.sign(contents)))
            elif pick == 1:
                pre = bytes([int(rng.integers(4))])
                sigs.append(DecoratedSignature(
                    hint=hashlib.sha256(pre).digest()[28:], signature=pre))
            elif pick == 2:
                payload = b"p" * int(rng.integers(1, 6))
                sigs.append(DecoratedSignature(
                    hint=signed_payload_hint(sk.public_key().raw, payload),
                    signature=sk.sign(payload)))
            else:
                sigs.append(DecoratedSignature(
                    hint=sk.public_key().hint(), signature=b"\x07" * 64))
        sig_bytes = [s.to_bytes() for s in sigs]
        jc = J.checker.SignatureChecker(contents, sigs)
        pc = P.checker.SignatureChecker(contents, [
            P.transaction.DecoratedSignature.from_bytes(b)
            for b in sig_bytes])
        for _ in range(2):
            need = int(rng.integers(0, 4))
            jv = jc.check_signature(signers, need)
            pv = pc.check_signature(
                [(P.types.SignerKey.from_bytes(s.to_bytes()), w)
                 for s, w in signers], need)
            assert pv == jv
            assert pc.used == jc.used
        assert pc.check_all_signatures_used() == \
            jc.check_all_signatures_used()


def test_oversized_preimage_never_matches():
    """A >64-byte preimage, which only a hand-built signature object can
    carry, matches no HASH_X signer in either checker."""
    preimage = b"x" * 65
    hx, key = _hash_x(preimage)
    for pkg in (J, P):
        ds = pkg.transaction.DecoratedSignature(hint=hx[28:],
                                                signature=preimage)
        sk = pkg.types.SignerKey.from_bytes(key.to_bytes())
        checker = pkg.checker.SignatureChecker(b"\x01" * 32, [ds])
        assert not checker.check_signature([(sk, 1)], 1)
        assert checker.used == [False]
