"""The port's classic operation families (account, misc, trust) against
the JAX package's, on the CPU.

Each case runs one of the JAX package's own operation tests
(tests/test_tx_ops.py, tests/test_signer_types.py) as written, under
`torch_tx_parity.mirrored()`: every transaction the test applies or
checks through tests/txtest_utils.py is carried into the port as
envelope bytes and run there on a root carried from the JAX ledger's
bytes. The verdicts, the result bytes and the whole ledger after each
commit must be equal. The protocol-version sweeps run their bodies on a
fresh ledger per version, so the port takes the same version branches
(the flags gate, the signer-weight clamp, zero-balance creation,
pool-share trustlines, Inflation's retirement)."""

import numpy as np
import pytest

import test_signer_types as ref_signers
import test_tx_ops as ref_ops
from stellar_core_tpu.xdr.ledger_entries import Signer
from stellar_core_tpu.xdr.transaction import Operation, OperationType, \
    _OperationBody
from stellar_core_tpu.xdr.types import SignerKey, SignerKeyType
from torch_tx_parity import (J, P, case_id, clear_caches, mirrored,
                             reference_cases, run_reference_test)
from txtest_utils import (TestAccount, TestLedger, make_asset,
                          op_account_merge, op_allow_trust, op_bump_sequence,
                          op_change_trust, op_create_account, op_manage_data,
                          op_payment, op_set_options, op_set_trustline_flags)

XLM = 10_000_000

OPS_CASES = reference_cases(ref_ops, [
    "TestCreateAccount", "TestPayment", "TestAuth", "TestMultisig",
    "TestMiscOps", "TestTxValidity", None])
SIGNER_CASES = reference_cases(ref_signers, [
    "TestHashX", "TestPreAuthTx", "TestSignedPayload", "TestMixedAlternate"])


@pytest.fixture(autouse=True)
def _fresh_verify_caches():
    clear_caches()
    yield
    clear_caches()


@pytest.mark.parametrize("case", OPS_CASES, ids=map(case_id, OPS_CASES))
def test_tx_ops_scenario_matches_jax(case):
    run_reference_test(*case)


@pytest.mark.parametrize("case", SIGNER_CASES,
                         ids=map(case_id, SIGNER_CASES))
def test_signer_scenario_matches_jax(case):
    run_reference_test(*case)


def test_sweeps_cover_every_version():
    """The five sweeps ran one ledger per protocol version they name, and
    the mirror followed each (a fresh port root per version)."""
    sweeps = [c for c in OPS_CASES if c[2].endswith("_sweeps_versions")]
    assert len(sweeps) == 5
    ledgers = {name: run_reference_test(*case).synced
               for case in sweeps for name in [case[2]]}
    assert ledgers == {"test_set_options_flags_gate_sweeps_versions": 9,
                       "test_signer_weight_clamp_sweeps_versions": 3,
                       "test_zero_balance_create_sweeps_versions": 3,
                       "test_pool_share_trustline_sweeps_versions": 3,
                       "test_inflation_retired_sweeps_versions": 2}


def test_operations_package_registers_the_ported_families():
    """Importing tx/operations registers the frames of every family, the
    classic ones and the Soroban ops, under the same classes' names as
    the JAX package: one for each op type."""
    import stellar_core_tpu_torch.tx.operations  # noqa: F401
    preg = {int(t): c.__name__ for t, c in P.op_frame._REGISTRY.items()}
    jreg = {int(t): c.__name__ for t, c in J.op_frame._REGISTRY.items()}
    assert preg == jreg
    assert set(preg) == {int(t) for t in J.transaction.OperationType}


@pytest.mark.parametrize("seed", range(4))
def test_seeded_account_session_matches_jax(seed):
    """Six accounts and an issuer make 70 seeded operations of the
    account, misc and trust families at their edges: CreateAccount at
    and around the two-reserve minimum, SetOptions with flags,
    thresholds, weights, home domains and signers (added, reweighted,
    removed), ManageData creates, updates and deletes, BumpSequence
    below, at and past the current number, AccountMerge (also of merged
    accounts), ChangeTrust limits (0 deletes), AllowTrust and
    SetTrustLineFlags on lines of an issuer whose flags change, credit
    payments, and Inflation. Ledgers advance every ten steps. A
    transaction whose source was merged away is only checked (a ledger
    close would not apply it). Every step is mirrored."""
    rng = np.random.default_rng(100 + seed)
    reserve = 5_000_000
    with mirrored() as stats:
        led = TestLedger()
        root = led.root_account
        issuer = TestAccount.fresh(led)
        accts = [TestAccount.fresh(led) for _ in range(6)]
        for a in [issuer] + accts:
            assert root.create(a, 100 * XLM)
            a.sync_seq()
        usd = make_asset(b"USD", issuer.account_id)
        fresh = []

        def pick(xs):
            return xs[int(rng.integers(len(xs)))]

        def signer_op():
            key = SignerKey(SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                            pick(accts + fresh or accts).key.public_key().raw)
            return op_set_options(signer=Signer(
                key=key, weight=int(rng.choice([0, 1, 2, 300]))))

        for step in range(70):
            if step % 10 == 9:
                led.advance_ledger()
            src = pick(accts) if rng.random() < 0.8 else issuer
            other = pick(accts + [issuer])
            kind = rng.choice(["create", "options", "signer", "data", "bump",
                               "merge", "trust", "allow", "flags", "pay",
                               "inflation"],
                              p=[.12, .12, .1, .1, .1, .03, .12, .08, .08,
                                 .1, .05])
            if kind == "create":
                dest = TestAccount.fresh(led)
                fresh.append(dest)
                op = op_create_account(dest.account_id, int(rng.choice(
                    [0, 1, 2 * reserve - 1, 2 * reserve, 2 * reserve + 1,
                     50 * XLM, 10 ** 12])))
            elif kind == "options":
                kw = {}
                if rng.random() < 0.5:
                    kw[rng.choice(["setFlags", "clearFlags"])] = \
                        int(rng.integers(0, 16))
                if rng.random() < 0.4:
                    kw["masterWeight"] = int(rng.choice([1, 2, 255, 256]))
                if rng.random() < 0.4:
                    kw["lowThreshold"] = int(rng.integers(0, 3))
                    kw["medThreshold"] = int(rng.integers(0, 3))
                if rng.random() < 0.4:
                    kw["homeDomain"] = rng.choice(
                        [b"", b"a.example", b"bad\x01domain"])
                op = op_set_options(**kw)
            elif kind == "signer":
                op = signer_op()
            elif kind == "data":
                op = op_manage_data(pick([b"k1", b"k2", b"", b"k3"]),
                                    None if rng.random() < 0.3 else
                                    rng.bytes(int(rng.integers(0, 65))))
            elif kind == "bump":
                acc = led.account(src.account_id)
                base = acc.seqNum if acc else 0
                op = op_bump_sequence(int(base + rng.choice(
                    [-1, 0, 1, 2 ** 32])))
            elif kind == "merge":
                op = op_account_merge(other.muxed)
            elif kind == "trust":
                op = op_change_trust(usd, int(rng.choice(
                    [0, 1, 10 * XLM, 2 ** 62])))
            elif kind == "allow":
                src = issuer
                op = op_allow_trust(other.account_id, b"USD",
                                    int(rng.integers(0, 3)))
            elif kind == "flags":
                src = issuer
                op = op_set_trustline_flags(
                    other.account_id, usd, int(rng.integers(0, 4)),
                    int(rng.integers(0, 4)))
            elif kind == "pay":
                op = op_payment(other.muxed, int(rng.integers(1, 5 * XLM)),
                                usd)
            else:
                op = Operation(sourceAccount=None,
                               body=_OperationBody(OperationType.INFLATION))
            src.sync_seq()
            frame = src.tx([op])
            if led.account(src.account_id) is None:
                led.check_valid(frame)      # merged away: txNO_ACCOUNT
            else:
                led.apply_tx(frame)
    assert stats.applied + stats.checked == 7 + 70
    assert stats.applied >= 7 + 50 and stats.synced >= 1 + 6
    codes = {int(c) for c in stats.codes}
    assert 0 in codes and -1 in codes       # successes and failed ops
