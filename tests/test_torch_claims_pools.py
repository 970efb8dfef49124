"""The port's claimable-balance, clawback, sponsorship and liquidity-pool
families and its invariants against the JAX package's, on the CPU.

The JAX package's own scenarios (tests/test_dex_ops.py TestClaimableBalances,
TestSponsorshipOps, TestClawback and TestLiquidityPools,
tests/test_claim_predicates.py and tests/test_pool_routing.py) run under
`torch_tx_parity.mirrored()`: each transaction is carried into the port as
envelope bytes and applied there on a root carried from the JAX ledger's
bytes; result bytes and the whole ledger after each commit must be equal.
The pure predicate and pool functions are compared on seeded inputs.

Every invariant of both packages gets the same OperationDeltas, recorded
as bytes from those scenarios' applies, and must give the same answer
in both (ConservationOfLumens fails alike on XLM moved into pools, which
it does not count). One corrupted delta per invariant must make both
raise InvariantDoesNotHold with the same message."""

from types import SimpleNamespace

import numpy as np
import pytest

import test_claim_predicates as ref_claims
import test_dex_ops as ref_dex
import test_pool_routing as ref_pools
from torch_tx_parity import (J, P, case_id, clear_caches, reference_cases,
                             run_reference_test)

CASES = (reference_cases(ref_dex, ["TestClaimableBalances",
                                   "TestSponsorshipOps", "TestClawback",
                                   "TestLiquidityPools"])
         + reference_cases(ref_claims, ["TestPredicatesOnLedger"])
         + reference_cases(ref_pools, ["TestPathThroughPool",
                                       "TestPoolDisableFlags"]))
INVARIANTS = ("ConservationOfLumens", "LedgerEntryIsValid",
              "AccountSubEntriesCountIsValid", "LiabilitiesMatchOffers",
              "OrderBookIsNotCrossed", "ConstantProductInvariant",
              "SponsorshipCountIsValid",
              "BucketListIsConsistentWithDatabase")


@pytest.fixture(autouse=True)
def _fresh_verify_caches():
    clear_caches()
    yield
    clear_caches()


@pytest.mark.parametrize("case", CASES, ids=map(case_id, CASES))
def test_claims_pools_scenario_matches_jax(case):
    run_reference_test(*case)


# ------------------------------------------------------- pure functions --

def _predicate(rng, depth):
    """A seeded ClaimPredicate of the JAX package, up to `depth` deep;
    a few arms are malformed (one-armed AND/OR, negative times)."""
    T = J.entries.ClaimPredicateType
    kind = int(rng.integers(6 if depth > 1 else 3))
    kind = (T.CLAIM_PREDICATE_UNCONDITIONAL,
            T.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME,
            T.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME, T.CLAIM_PREDICATE_AND,
            T.CLAIM_PREDICATE_OR, T.CLAIM_PREDICATE_NOT)[kind]
    if kind in (T.CLAIM_PREDICATE_BEFORE_ABSOLUTE_TIME,
                T.CLAIM_PREDICATE_BEFORE_RELATIVE_TIME):
        t = int(rng.integers(-50, 5000)) if rng.random() < 0.1 \
            else int(rng.integers(0, 5000))
        return J.entries.ClaimPredicate(kind, t)
    if kind in (T.CLAIM_PREDICATE_AND, T.CLAIM_PREDICATE_OR):
        arms = 1 if rng.random() < 0.05 else 2
        return J.entries.ClaimPredicate(
            kind, [_predicate(rng, depth - 1) for _ in range(arms)])
    if kind == T.CLAIM_PREDICATE_NOT:
        return J.entries.ClaimPredicate(kind, _predicate(rng, depth - 1))
    return J.entries.ClaimPredicate(kind)


@pytest.mark.parametrize("seed", range(3))
def test_claim_predicates_agree(seed):
    """validate_predicate (its depth cap of 4 included), the rebase of
    relative times at a close time and the evaluation at claim time, on
    seeded predicate trees up to six deep, in both packages; the balance
    ID preimage (operation_id) byte for byte."""
    rng = np.random.default_rng(seed)
    jcb, pcb = J.claimable_balance_ops, P.claimable_balance_ops
    assert jcb.MAX_PREDICATE_DEPTH == pcb.MAX_PREDICATE_DEPTH == 4
    valid = 0
    for _ in range(200):
        jp = _predicate(rng, int(rng.integers(1, 7)))
        pp = P.entries.ClaimPredicate.from_bytes(jp.to_bytes())
        ok = jcb.validate_predicate(jp)
        assert pcb.validate_predicate(pp) == ok
        valid += ok
        if not ok:
            continue
        close = int(rng.integers(0, 4000))
        jr, pr = jcb.rebase_predicate(jp, close), \
            pcb.rebase_predicate(pp, close)
        assert pr.to_bytes() == jr.to_bytes()
        for t in (0, close, close + 1, int(rng.integers(0, 10_000))):
            assert pcb.test_predicate(pr, t) == jcb.test_predicate(jr, t)
    assert 20 < valid < 200
    for i in range(20):
        raw = rng.bytes(32)
        seq, index = int(rng.integers(0, 2 ** 62)), int(rng.integers(100))
        jctx = SimpleNamespace(tx_source_id=J.types.PublicKey.ed25519(raw),
                               tx_seq_num=seq)
        pctx = SimpleNamespace(tx_source_id=P.types.PublicKey.ed25519(raw),
                               tx_seq_num=seq)
        assert pcb.operation_id(pctx, index) == jcb.operation_id(jctx, index)


@pytest.mark.parametrize("seed", range(3))
def test_pool_math_agrees(seed):
    """exchange_with_pool_amounts (strict send and strict receive, the
    30 bps fee and other fees, rejections) and pool IDs on seeded
    reserves, amounts and asset pairs, in both packages."""
    rng = np.random.default_rng(10 + seed)
    jx, px = J.offer_exchange, P.offer_exchange
    jr, pr = J.offer_math.RoundingType, P.offer_math.RoundingType
    rejected = 0
    for _ in range(400):
        r_in = int(rng.integers(1, 10 ** int(rng.integers(1, 15))))
        r_out = int(rng.integers(1, 10 ** int(rng.integers(1, 15))))
        fee = int(rng.choice([0, 1, 30, 100, 9999]))
        amount = int(rng.integers(1, 10 ** int(rng.integers(1, 13))))
        if rng.random() < 0.5:
            args = (r_in, amount, r_out, jx.INT64_MAX, fee)
            rt = "PATH_PAYMENT_STRICT_SEND"
        else:
            args = (r_in, jx.INT64_MAX, r_out, amount, fee)
            rt = "PATH_PAYMENT_STRICT_RECEIVE"
        got = px.exchange_with_pool_amounts(*args, pr[rt])
        assert got == jx.exchange_with_pool_amounts(*args, jr[rt])
        rejected += got is None
    assert 0 < rejected < 400
    for _ in range(20):
        codes = [bytes(rng.integers(65, 91, int(rng.integers(1, 13)),
                       dtype=np.uint8)) for _ in range(2)]
        issuer = J.types.PublicKey.ed25519(rng.bytes(32))
        jassets = [J.entries.Asset.credit(c, issuer) for c in codes]
        if rng.random() < 0.5:
            jassets[0] = J.entries.Asset.native()
        passets = [P.entries.Asset.from_bytes(a.to_bytes()) for a in jassets]
        assert P.pool_trust.pool_id_for_assets(*passets) == \
            J.pool_trust.pool_id_for_assets(*jassets)


# ----------------------------------------------------------- invariants --

class _DeltaRecorder:
    """An invariant manager stand-in that keeps each operation's delta as
    bytes: {key: (prev, curr)}, the header before and after."""

    def __init__(self):
        self.deltas = []

    def check_on_operation_apply(self, op, result, delta):
        self.deltas.append((
            {kb: (p and p.to_bytes(), c and c.to_bytes())
             for kb, (p, c) in delta.entries.items()},
            delta.header_prev.to_bytes(), delta.header_curr.to_bytes()))


@pytest.fixture(scope="module")
def recorded_deltas():
    """The deltas of every successful operation of the replayed
    scenarios, recorded from the JAX package's applies."""
    import txtest_utils as tu
    rec = _DeltaRecorder()
    orig = tu.TestLedger.apply_tx

    def apply_tx(self, frame, base_fee=None):
        with J.ledger_txn.LedgerTxn(self.root) as ltx:
            bf = base_fee if base_fee is not None else self.header().baseFee
            frame.process_fee_seq_num(ltx, bf)
            ok = frame.apply(ltx, bf, invariants=rec)
            ltx.commit()
        return ok

    tu.TestLedger.apply_tx = apply_tx
    try:
        for module, owner, name in CASES:
            J.keys.clear_verify_cache()
            led = tu.TestLedger()
            getattr(getattr(module, owner)(), name)(led, led.root_account)
    finally:
        tu.TestLedger.apply_tx = orig
    assert len(rec.deltas) > 50
    return rec.deltas


def _delta(pkg, raw):
    entries, hp, hc = raw
    le = pkg.entries.LedgerEntry

    def entry(b):
        return None if b is None else le.from_bytes(b)

    return pkg.inv_manager.OperationDelta(
        {kb: (entry(p), entry(c)) for kb, (p, c) in entries.items()},
        pkg.ledger.LedgerHeader.from_bytes(hp),
        pkg.ledger.LedgerHeader.from_bytes(hc))


class _Offers:
    def __init__(self, offers):
        self.offers = offers

    def iter_offers(self):
        return iter(self.offers)


def _offer(pkg, seller, offer_id, selling, buying, n, d):
    E = pkg.entries
    return E.LedgerEntry(
        lastModifiedLedgerSeq=2, data=E._LedgerEntryData(
            E.LedgerEntryType.OFFER, E.OfferEntry(
                sellerID=pkg.types.PublicKey.ed25519(seller),
                offerID=offer_id, selling=selling, buying=buying,
                amount=1000, price=E.Price(n=n, d=d), flags=0,
                ext=pkg.types.ExtensionPoint(0))),
        ext=E._LedgerEntryExt(0))


def _book(pkg, crossed: bool):
    """Two offers on one pair in opposite directions: crossed when both
    sell at half a unit of the other."""
    E = pkg.entries
    usd = E.Asset.credit(b"USD", pkg.types.PublicKey.ed25519(b"\x07" * 32))
    xlm = E.Asset.native()
    n, d = (1, 2) if crossed else (2, 1)
    return [(b"a", _offer(pkg, b"\x01" * 32, 1, xlm, usd, n, d)),
            (b"b", _offer(pkg, b"\x02" * 32, 2, usd, xlm, n, d))]


def _invariant(pkg, name, crossed=False, db=None):
    inv = getattr(pkg.invariants, name)
    if name == "OrderBookIsNotCrossed":
        return inv(lambda: _Offers(_book(pkg, crossed)))
    if name == "BucketListIsConsistentWithDatabase":
        return inv(db)
    return inv()


def _bucket_check(pkg, raw_deltas, corrupt: bool):
    """check_on_bucket_apply over LIVEENTRYs of every entry the deltas
    left, against a database holding them (one balance off when
    `corrupt`)."""
    L = pkg.ledger
    entries = {}
    for d in raw_deltas:
        for kb, (_, c) in d[0].items():
            if c is not None:
                entries[kb] = c
    db = {kb: pkg.entries.LedgerEntry.from_bytes(b)
          for kb, b in entries.items()}
    if corrupt:
        acct = next(e for e in db.values()
                    if e.data.disc == pkg.entries.LedgerEntryType.ACCOUNT)
        acct.data.value.balance += 1
    bucket = [L.BucketEntry(L.BucketEntryType.LIVEENTRY,
                            pkg.entries.LedgerEntry.from_bytes(b))
              for b in entries.values()]
    return _invariant(pkg, "BucketListIsConsistentWithDatabase",
                      db=db.get).check_on_bucket_apply(bucket, 7, 1, True)


def _native_pool_reserve_change(raw) -> int:
    """How many stroops of XLM the delta moved into (or out of) pool
    reserves."""
    T = J.entries.LedgerEntryType
    moved = 0
    for kb, (p, c) in raw[0].items():
        if J.entries.LedgerKey.from_bytes(kb).disc != T.LIQUIDITY_POOL:
            continue
        for b, sign in ((p, -1), (c, 1)):
            if b is None:
                continue
            cp = J.entries.LedgerEntry.from_bytes(b).data.value.body.value
            if cp.params.assetA.disc == J.entries.AssetType.ASSET_TYPE_NATIVE:
                moved += sign * cp.reserveA
    return moved


@pytest.mark.parametrize("name", INVARIANTS)
def test_invariant_holds_alike_on_scenario_deltas(name, recorded_deltas):
    """Each invariant returns the same answer in both packages on every
    delta the scenarios make, and the package exports the same names.
    Each holds on every delta but one kind: ConservationOfLumens does
    not count XLM held in pool reserves (the JAX package's
    `_native_amount` counts accounts and claimable balances), so it
    fails, in both packages alike, exactly on the deltas that move XLM
    into or out of a pool, with the reserve change as its entry delta."""
    assert P.invariant.__all__ == J.invariant.__all__
    flagged = 0
    for raw in recorded_deltas:
        got = [_invariant(pkg, name).check_on_operation_apply(
            None, None, _delta(pkg, raw)) for pkg in (J, P)]
        assert got[0] == got[1]
        moved = _native_pool_reserve_change(raw)
        if name == "ConservationOfLumens" and moved:
            assert got[1].startswith(
                f"lumens not conserved: entry delta {-moved}, ")
            flagged += 1
        else:
            assert got[1] is None
    assert flagged == (12 if name == "ConservationOfLumens" else 0)
    assert _bucket_check(J, recorded_deltas, False) is None
    assert _bucket_check(P, recorded_deltas, False) is None


def _first(deltas, pred):
    for i, raw in enumerate(deltas):
        for kb, (p, c) in raw[0].items():
            if pred(J.entries.LedgerKey.from_bytes(kb), p, c):
                return i, kb
    raise AssertionError("no delta of the kind")


def _corrupted(name, deltas):
    """One scenario delta, with the fault that `name` must catch, as
    bytes: lumens created, a lastModified off by one, a sub-entry count
    off by one, an offer whose amount moved without its liabilities, a
    pool trade that shrank the product, a sponsored count with no
    sponsored entry."""
    T = J.entries.LedgerEntryType
    E = J.entries.LedgerEntry

    def is_account(k, p, c):
        return k.disc == T.ACCOUNT and c is not None

    def is_offer(k, p, c):
        return k.disc == T.OFFER and c is not None

    def is_trade(k, p, c):
        if k.disc != T.LIQUIDITY_POOL or p is None or c is None:
            return False
        pv = E.from_bytes(p).data.value.body.value
        cv = E.from_bytes(c).data.value.body.value
        return pv.totalPoolShares == cv.totalPoolShares and \
            pv.reserveA != cv.reserveA

    def is_sponsored(k, p, c):
        return is_account(k, p, c) and \
            E.from_bytes(c).data.value.ext.disc == 1 and \
            E.from_bytes(c).data.value.ext.value.ext.disc == 2

    kind = {"ConservationOfLumens": is_account,
            "LedgerEntryIsValid": is_account,
            "AccountSubEntriesCountIsValid": is_account,
            "LiabilitiesMatchOffers": is_offer,
            "ConstantProductInvariant": is_trade,
            "SponsorshipCountIsValid": is_sponsored}[name]
    i, kb = _first(deltas, kind)
    entries, hp, hc = deltas[i]
    p, c = entries[kb]
    le = E.from_bytes(c)
    v = le.data.value
    if name == "ConservationOfLumens":
        v.balance += 1
    elif name == "LedgerEntryIsValid":
        le.lastModifiedLedgerSeq += 1
    elif name == "AccountSubEntriesCountIsValid":
        v.numSubEntries += 1
    elif name == "LiabilitiesMatchOffers":
        v.amount += 1
    elif name == "ConstantProductInvariant":
        prev = E.from_bytes(p).data.value.body.value
        v.body.value.reserveA = prev.reserveA - 1
        v.body.value.reserveB = prev.reserveB
    else:
        v.ext.value.ext.value.numSponsored += 1
    return {**entries, kb: (p, le.to_bytes())}, hp, hc


@pytest.mark.parametrize("name", INVARIANTS)
def test_invariant_catches_its_corrupted_delta_alike(name, recorded_deltas):
    """One corrupted delta per invariant: InvariantDoesNotHold in both
    packages, through an InvariantManager with that invariant alone
    enabled, with the same message (which names the invariant)."""
    msgs = []
    for pkg in (J, P):
        mgr = pkg.inv_manager.InvariantManager()
        if name == "BucketListIsConsistentWithDatabase":
            err = _bucket_check(pkg, recorded_deltas, True)
            assert err is not None
            with pytest.raises(pkg.inv_manager.InvariantDoesNotHold) as exc:
                mgr._on_failure(_invariant(pkg, name), err)
        else:
            mgr.register(_invariant(pkg, name, crossed=True))
            mgr.enable([name])
            raw = recorded_deltas[0] if name == "OrderBookIsNotCrossed" \
                else _corrupted(name, recorded_deltas)
            with pytest.raises(pkg.inv_manager.InvariantDoesNotHold) as exc:
                mgr.check_on_operation_apply(None, None, _delta(pkg, raw))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]
    assert msgs[1].startswith(f"invariant {name} does not hold: ")


def test_default_invariants_register_alike():
    """register_default_invariants registers the same eight invariants in
    the same order in both packages, and ".*" enables them all."""
    names = []
    for pkg in (J, P):
        mgr = pkg.inv_manager.InvariantManager()
        pkg.invariants.register_default_invariants(mgr)
        mgr.enable([".*"])
        names.append(mgr.enabled_invariants())
    assert names[0] == names[1]
    assert sorted(names[1]) == sorted(INVARIANTS)
