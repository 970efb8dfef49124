"""Exchange arithmetic for the order book.

Reference: transactions/OfferExchange.cpp (exchangeV10 family) and the
bigDivide helpers in util/types.cpp. Python's arbitrary-precision ints
replace the reference's uint128 machinery; every result is still checked
into int64 like the reference's bigDivide overflow contract.

All semantics are value-preserving: the ledger must compute the exact
same traded amounts as the reference or consensus diverges.
"""

from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple

from ..util.checks import releaseAssert
from ..xdr.ledger_entries import Price

INT64_MAX = 2**63 - 1


class Rounding(IntEnum):
    ROUND_DOWN = 0
    ROUND_UP = 1


class RoundingType(IntEnum):
    NORMAL = 0
    PATH_PAYMENT_STRICT_SEND = 1
    PATH_PAYMENT_STRICT_RECEIVE = 2


def big_divide(a: int, b: int, c: int, rounding: Rounding) -> int:
    """(a * b) / c with explicit rounding; raises on int64 overflow
    (reference: util/types.cpp bigDivideOrThrow)."""
    releaseAssert(c > 0, "bigDivide by non-positive")
    x = a * b
    if rounding == Rounding.ROUND_DOWN:
        res = x // c
    else:
        res = (x + c - 1) // c
    if res > INT64_MAX or res < 0:
        raise OverflowError("bigDivide overflow")
    return res


def big_divide_128(value: int, c: int, rounding: Rounding) -> int:
    return big_divide(value, 1, c, rounding)


class ExchangeResultV10(NamedTuple):
    num_wheat_received: int
    num_sheep_send: int
    wheat_stays: bool


def _offer_value(price_n: int, price_d: int, max_send: int,
                 max_receive: int) -> int:
    return min(max_send * price_n, max_receive * price_d)


def exchange_v10_without_price_error_thresholds(
        price: Price, max_wheat_send: int, max_wheat_receive: int,
        max_sheep_send: int, max_sheep_receive: int,
        round_type: RoundingType) -> ExchangeResultV10:
    wheat_value = _offer_value(price.n, price.d,
                               max_wheat_send, max_sheep_receive)
    sheep_value = _offer_value(price.d, price.n,
                               max_sheep_send, max_wheat_receive)
    wheat_stays = wheat_value > sheep_value

    if wheat_stays:
        if round_type == RoundingType.PATH_PAYMENT_STRICT_SEND:
            wheat_receive = sheep_value // price.n
            sheep_send = min(max_sheep_send, max_sheep_receive)
        elif price.n > price.d or \
                round_type == RoundingType.PATH_PAYMENT_STRICT_RECEIVE:
            wheat_receive = sheep_value // price.n
            sheep_send = big_divide(wheat_receive, price.n, price.d,
                                    Rounding.ROUND_UP)
        else:
            sheep_send = sheep_value // price.d
            wheat_receive = big_divide(sheep_send, price.d, price.n,
                                       Rounding.ROUND_DOWN)
    else:
        if price.n > price.d:
            wheat_receive = wheat_value // price.n
            sheep_send = big_divide(wheat_receive, price.n, price.d,
                                    Rounding.ROUND_DOWN)
        else:
            sheep_send = wheat_value // price.d
            wheat_receive = big_divide(sheep_send, price.d, price.n,
                                       Rounding.ROUND_UP)

    releaseAssert(0 <= wheat_receive <= min(max_wheat_receive,
                                            max_wheat_send),
                  "wheatReceive out of bounds")
    releaseAssert(0 <= sheep_send <= min(max_sheep_receive, max_sheep_send),
                  "sheepSend out of bounds")
    return ExchangeResultV10(wheat_receive, sheep_send, wheat_stays)


def check_price_error_bound(price: Price, wheat_receive: int,
                            sheep_send: int, can_favor_wheat: bool) -> bool:
    """Both sides get a price within 1% of the crossed price
    (reference: OfferExchange.cpp checkPriceErrorBound)."""
    lhs = 100 * price.n * wheat_receive
    rhs = 100 * price.d * sheep_send
    if can_favor_wheat and rhs > lhs:
        return True
    return abs(lhs - rhs) <= price.n * wheat_receive


def apply_price_error_thresholds(
        price: Price, wheat_receive: int, sheep_send: int,
        wheat_stays: bool, round_type: RoundingType) -> ExchangeResultV10:
    if wheat_receive > 0 and sheep_send > 0:
        wheat_value = wheat_receive * price.n
        sheep_value = sheep_send * price.d
        if wheat_stays:
            releaseAssert(sheep_value >= wheat_value,
                          "favored sheep when wheat stays")
        else:
            releaseAssert(sheep_value <= wheat_value,
                          "favored wheat when sheep stays")
        if round_type == RoundingType.NORMAL:
            if not check_price_error_bound(price, wheat_receive, sheep_send,
                                           False):
                wheat_receive = 0
                sheep_send = 0
        else:
            releaseAssert(
                check_price_error_bound(price, wheat_receive, sheep_send,
                                        True),
                "exceeded price error bound")
    else:
        # one side rounds to zero: no trade for NORMAL / STRICT_RECEIVE;
        # STRICT_SEND may send sheep for no wheat (reference comment)
        if round_type != RoundingType.PATH_PAYMENT_STRICT_SEND:
            wheat_receive = 0
            sheep_send = 0
    return ExchangeResultV10(wheat_receive, sheep_send, wheat_stays)


def exchange_v10(price: Price, max_wheat_send: int, max_wheat_receive: int,
                 max_sheep_send: int, max_sheep_receive: int,
                 round_type: RoundingType) -> ExchangeResultV10:
    before = exchange_v10_without_price_error_thresholds(
        price, max_wheat_send, max_wheat_receive, max_sheep_send,
        max_sheep_receive, round_type)
    return apply_price_error_thresholds(
        price, before.num_wheat_received, before.num_sheep_send,
        before.wheat_stays, round_type)


def adjust_offer_amount(price: Price, max_wheat_send: int,
                        max_sheep_receive: int) -> int:
    """Largest executable offer amount (reference: adjustOffer)."""
    res = exchange_v10(price, max_wheat_send, INT64_MAX, INT64_MAX,
                       max_sheep_receive, RoundingType.NORMAL)
    return res.num_wheat_received


def offer_selling_liabilities(offer_entry) -> int:
    """reference: TransactionUtils.cpp:926-941 getOfferSellingLiabilities"""
    res = exchange_v10_without_price_error_thresholds(
        offer_entry.price, offer_entry.amount, INT64_MAX, INT64_MAX,
        INT64_MAX, RoundingType.NORMAL)
    return res.num_wheat_received


def offer_buying_liabilities(offer_entry) -> int:
    """reference: TransactionUtils.cpp:902-916 getOfferBuyingLiabilities"""
    res = exchange_v10_without_price_error_thresholds(
        offer_entry.price, offer_entry.amount, INT64_MAX, INT64_MAX,
        INT64_MAX, RoundingType.NORMAL)
    return res.num_sheep_send
