"""The port's DEX (ManageSellOffer, ManageBuyOffer, CreatePassiveSellOffer,
the path payments, offer_exchange, offer_math, liabilities) against the
JAX package's, on the CPU.

The JAX package's own DEX tests (tests/test_dex_ops.py TestManageOffers
and TestPathPayments) and seeded order-book sessions run under
`torch_tx_parity.mirrored()`: each transaction is carried into the port
as envelope bytes and applied there on a root carried from the JAX
ledger's bytes; result bytes and the whole ledger after each commit must
be equal. Hypothesis draws wheat, sheep and prices for `exchange_v10`,
its rounding and the liabilities of an offer."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import test_dex_ops as ref_dex
from stellar_core_tpu.xdr.ledger_entries import LedgerEntryType, Price
from stellar_core_tpu.xdr.results import OperationResultCode
from torch_tx_parity import (J, P, case_id, clear_caches, mirrored,
                             reference_cases, run_reference_test)
from txtest_utils import (TestAccount, TestLedger, make_asset, native,
                          op_change_trust, op_path_payment_strict_receive,
                          op_path_payment_strict_send, op_payment)

XLM = 10_000_000
INT64_MAX = 2 ** 63 - 1
DEX_CASES = reference_cases(ref_dex, ["TestManageOffers", "TestPathPayments"])


@pytest.fixture(autouse=True)
def _fresh_verify_caches():
    clear_caches()
    yield
    clear_caches()


@pytest.mark.parametrize("case", DEX_CASES, ids=map(case_id, DEX_CASES))
def test_dex_scenario_matches_jax(case):
    run_reference_test(*case)


# --------------------------------------------------- seeded order books --

def _offers_of(led, acct):
    return sorted(e.data.value.offerID for e in led.root._entries.values()
                  if e.data.disc == LedgerEntryType.OFFER
                  and e.data.value.sellerID == acct.account_id)


def _claimed(frame) -> int:
    """Offers crossed by the transaction's (first) operation, from its
    result: the ClaimAtoms of a manage-offer or path-payment success."""
    res = frame.result.result.value
    if not isinstance(res, list) or not res or \
            res[0].disc != OperationResultCode.opINNER:
        return 0
    inner = res[0].value.value
    body = getattr(inner, "value", None)
    return len(getattr(body, "offers", None) or
               getattr(body, "offersClaimed", None) or [])


@pytest.mark.parametrize("seed", range(4))
def test_seeded_order_book_session_matches_jax(seed):
    """Five traders holding XLM, USD and EUR make 60 seeded operations:
    sell, buy and passive offers on the three pairs at prices 1/20..20,
    updates and deletes of their own offers, and strict-send and
    strict-receive path payments with an empty path or one through EUR.
    Books cross, partly fill, fail for liabilities or line limits, and
    path payments run out of offers: every step is mirrored."""
    rng = np.random.default_rng(seed)
    with mirrored() as stats:
        led = TestLedger()
        root = led.root_account
        issuer = TestAccount.fresh(led)
        traders = [TestAccount.fresh(led) for _ in range(5)]
        for acct in [issuer] + traders:
            assert root.create(acct, 10_000 * XLM)
            acct.sync_seq()
        usd = make_asset(b"USD", issuer.account_id)
        eur = make_asset(b"EUR", issuer.account_id)
        assets = [native(), usd, eur]
        for t in traders:
            for a in (usd, eur):
                assert t.apply([op_change_trust(a, 5_000 * XLM)])
                assert issuer.apply([op_payment(t.muxed, 1_000 * XLM, a)])
        crossed = 0
        for _ in range(60):
            t = traders[int(rng.integers(len(traders)))]
            i, j = rng.choice(3, 2, replace=False)
            selling, buying = assets[i], assets[j]
            amount = int(rng.integers(1, 200)) * XLM // 10
            n, d = int(rng.integers(1, 21)), int(rng.integers(1, 21))
            kind = rng.choice(["sell", "buy", "passive", "update", "send",
                               "receive"], p=[.3, .2, .1, .15, .15, .1])
            dest = traders[int(rng.integers(len(traders)))]
            path = [eur] if i != 2 and j != 2 and rng.random() < 0.5 else []
            if kind == "sell":
                op = ref_dex.op_sell(selling, buying, amount, n, d)
            elif kind == "buy":
                op = ref_dex.op_buy(selling, buying, amount, n, d)
            elif kind == "passive":
                op = ref_dex.op_passive(selling, buying, amount, n, d)
            elif kind == "update":
                mine = [(o, e.data.value) for o in _offers_of(led, t)
                        for e in led.root._entries.values()
                        if e.data.disc == LedgerEntryType.OFFER
                        and e.data.value.offerID == o]
                if not mine:
                    continue
                oid, of = mine[int(rng.integers(len(mine)))]
                op = ref_dex.op_sell(of.selling, of.buying,
                                     0 if rng.random() < 0.4 else amount,
                                     n, d, offer_id=oid)
            elif kind == "send":
                op = op_path_payment_strict_send(
                    selling, amount // 4, dest.muxed, buying, 1, path)
            else:
                op = op_path_payment_strict_receive(
                    selling, amount, dest.muxed, buying, amount // 4, path)
            frame = t.tx([op])
            led.apply_tx(frame)
            crossed += _claimed(frame)
    assert stats.applied >= 1 + 6 + 20 + 40
    assert crossed > 0
    assert len(set(stats.codes)) >= 2


# ---------------------------------------------------------- offer_math --

def _outcome(fn, *args):
    try:
        r = fn(*args)
    except Exception as e:          # noqa: BLE001 — compared by kind
        return ("error", type(e).__name__, str(e))
    return ("ok", tuple(r) if isinstance(r, tuple) else r)


AMOUNT = st.one_of(st.integers(0, 1000), st.integers(0, 10 ** 12),
                   st.integers(0, INT64_MAX))
PRICE_PART = st.one_of(st.integers(1, 20), st.integers(1, 2 ** 31 - 1))


@settings(max_examples=400, deadline=None)
@given(n=PRICE_PART, d=PRICE_PART, wheat_send=AMOUNT, wheat_receive=AMOUNT,
       sheep_send=AMOUNT, sheep_receive=AMOUNT, round_type=st.integers(0, 2))
def test_exchange_v10_agrees(n, d, wheat_send, wheat_receive, sheep_send,
                             sheep_receive, round_type):
    """exchange_v10 and its parts, and adjust_offer_amount: the same
    amounts, or the same error, on random wheat, sheep and prices."""
    out = []
    for pkg in (J, P):
        om = pkg.offer_math
        price = pkg.entries.Price(n=n, d=d)
        rt = om.RoundingType(round_type)
        out.append([
            _outcome(om.exchange_v10, price, wheat_send, wheat_receive,
                     sheep_send, sheep_receive, rt),
            _outcome(om.exchange_v10_without_price_error_thresholds, price,
                     wheat_send, wheat_receive, sheep_send, sheep_receive,
                     rt),
            _outcome(om.adjust_offer_amount, price, wheat_send,
                     sheep_receive),
            _outcome(om.check_price_error_bound, price, wheat_receive,
                     sheep_send, bool(round_type))])
    assert out[0] == out[1]


@settings(max_examples=300, deadline=None)
@given(a=AMOUNT, b=AMOUNT, c=st.integers(-2, INT64_MAX),
       rounding=st.integers(0, 1))
def test_big_divide_agrees(a, b, c, rounding):
    assert _outcome(P.offer_math.big_divide, a, b, c,
                    P.offer_math.Rounding(rounding)) == \
        _outcome(J.offer_math.big_divide, a, b, c,
                 J.offer_math.Rounding(rounding))


@settings(max_examples=200, deadline=None)
@given(n=PRICE_PART, d=PRICE_PART, amount=AMOUNT)
def test_offer_liabilities_agree(n, d, amount):
    outs = []
    for pkg in (J, P):
        of = pkg.entries.OfferEntry(price=pkg.entries.Price(n=n, d=d),
                                    amount=amount)
        outs.append((_outcome(pkg.offer_math.offer_selling_liabilities, of),
                     _outcome(pkg.offer_math.offer_buying_liabilities, of)))
    assert outs[0] == outs[1]


def test_exchange_v10_known_values():
    """A few hand-checked crossings, so the property tests above compare
    working functions: 100 wheat at 3/2 against ample sheep."""
    for pkg in (J, P):
        om = pkg.offer_math
        r = om.exchange_v10(pkg.entries.Price(n=3, d=2), 100, INT64_MAX,
                            INT64_MAX, INT64_MAX, om.RoundingType.NORMAL)
        assert tuple(r) == (100, 150, False)
        assert om.adjust_offer_amount(pkg.entries.Price(n=1, d=3), 10,
                                      INT64_MAX) == 9
