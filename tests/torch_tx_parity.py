"""Shared by tests/test_torch_{xdr,tx,txset,ops,dex,claims_pools,soroban,
wasm,close,persistence}.py:
the JAX package's and the port's transaction layers side by side.

State crosses as XDR bytes only: the JAX package's ledger goes into the
port through `InMemoryLedgerTxnRoot.from_xdr`, and envelopes through
`TransactionEnvelope.to_bytes()` / `from_bytes()`. `Pkg` gathers one
package's modules under the same names, so one runner drives either.
`mirrored()` replays every transaction a JAX-package test applies
through tests/txtest_utils.py in the port, and compares.
"""

from __future__ import annotations

import contextlib
import importlib
from types import SimpleNamespace

import numpy as np

from txtest_utils import TEST_NETWORK_ID as NETWORK_ID

XLM = 10_000_000

_MODULES = {
    "keys": "crypto.keys",
    "ledger_txn": "ledger.ledger_txn",
    "frame": "tx.frame",
    "tx_utils": "tx.tx_utils",
    "checker": "tx.signature_checker",
    "op_frame": "tx.operation_frame",
    "payment_ops": "tx.operations.payment_ops",
    "account_ops": "tx.operations.account_ops",
    "misc_ops": "tx.operations.misc_ops",
    "trust_ops": "tx.operations.trust_ops",
    "offer_ops": "tx.operations.offer_ops",
    "path_payment_ops": "tx.operations.path_payment_ops",
    "offer_math": "tx.offer_math",
    "liabilities": "tx.liabilities",
    "offer_exchange": "tx.offer_exchange",
    "pool_trust": "tx.pool_trust",
    "claimable_balance_ops": "tx.operations.claimable_balance_ops",
    "clawback_ops": "tx.operations.clawback_ops",
    "sponsorship_ops": "tx.operations.sponsorship_ops",
    "liquidity_pool_ops": "tx.operations.liquidity_pool_ops",
    "invariant": "invariant",
    "invariants": "invariant.invariants",
    "inv_manager": "invariant.manager",
    "footprint": "tx.footprint",
    "network_config": "soroban.network_config",
    "fees": "soroban.fees",
    "host": "soroban.host",
    "scvm": "soroban.scvm",
    "sac": "soroban.sac",
    "soroban_ops": "soroban.ops",
    "wasm": "soroban.wasm",
    "wasm_host": "soroban.wasm_host",
    "env_abi": "soroban.env_abi",
    "env_contract": "soroban.env_contract",
    "scvm_wasm": "soroban.scvm_wasm",
    "contract": "xdr.contract",
    "tx_set": "herder.tx_set",
    "herder": "herder.herder",
    "runtime": "xdr.runtime",
    "types": "xdr.types",
    "entries": "xdr.ledger_entries",
    "transaction": "xdr.transaction",
    "results": "xdr.results",
    "ledger": "xdr.ledger",
    "ledger_manager": "ledger.ledger_manager",
    "bucket_manager": "bucket.manager",
    "persistent_state": "main.persistent_state",
    "perf": "util.perf",
    "bucket": "bucket.bucket",
    "database": "db.database",
    "pg_stub": "db.pg_stub",
}


def Pkg(root: str) -> SimpleNamespace:
    """One package's transaction-layer modules by short name."""
    return SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{m}")
        for k, m in _MODULES.items()})


J = Pkg("stellar_core_tpu")
P = Pkg("stellar_core_tpu_torch")


def clear_caches() -> None:
    J.keys.clear_verify_cache()
    P.keys.clear_verify_cache()
    P.wasm_host._MODULE_CACHE.clear()


# ------------------------------------------------------------ state crossing --

def port_root(jroot):
    """The port's root holding the JAX root's header and entries."""
    return P.ledger_txn.InMemoryLedgerTxnRoot.from_xdr(
        jroot.get_header().to_bytes(),
        [e.to_bytes() for e in jroot._entries.values()])


def jax_root_from_xdr(header: bytes, entries) -> object:
    """A JAX root holding a header and entries given as XDR bytes (the
    counterpart of the port's `InMemoryLedgerTxnRoot.from_xdr`)."""
    r = J.ledger_txn.InMemoryLedgerTxnRoot(
        J.ledger.LedgerHeader.from_bytes(header))
    for b in entries:
        e = J.entries.LedgerEntry.from_bytes(b)
        r._entries[J.ledger_txn.entry_key_bytes(e)] = e
    return r


def jax_root_copy(jroot):
    """A fresh JAX root with the same header and entries (each run
    mutates its own)."""
    r = J.ledger_txn.InMemoryLedgerTxnRoot(
        J.ledger.LedgerHeader.from_bytes(jroot.get_header().to_bytes()))
    for kb, e in jroot._entries.items():
        r._entries[kb] = J.entries.LedgerEntry.from_bytes(e.to_bytes())
    return r


def frame_of(pkg, envelope: bytes, network_id: bytes = NETWORK_ID):
    return pkg.frame.make_frame(
        pkg.transaction.TransactionEnvelope.from_bytes(envelope), network_id)


def state_of(root) -> list:
    """(key bytes, entry bytes) of every entry, by key, then the
    header's bytes: the whole ledger as bytes."""
    return sorted((kb, e.to_bytes()) for kb, e in root._entries.items()) \
        + [(b"header", root.get_header().to_bytes())]


def apply_one(pkg, root, frame, base_fee=None) -> bool:
    """Fee, then apply, in one LedgerTxn that commits (the op-level
    tests' simplified ledger close, as txtest_utils.TestLedger.apply_tx)."""
    with pkg.ledger_txn.LedgerTxn(root) as ltx:
        bf = base_fee if base_fee is not None else root.get_header().baseFee
        frame.process_fee_seq_num(ltx, bf)
        ok = frame.apply(ltx, bf)
        ltx.commit()
    return ok


def check_then_apply(pkg, root, envelope: bytes) -> dict:
    """check_valid, then fee + apply, of one envelope on `root`: both
    results as bytes and the ledger after."""
    frame = frame_of(pkg, envelope)
    with pkg.ledger_txn.LedgerTxn(root) as ltx:
        valid = frame.check_valid(ltx)
    checked = frame.result.to_bytes()
    applied = apply_one(pkg, root, frame)
    return {"valid": valid, "checked": checked, "applied": applied,
            "result": frame.result.to_bytes(), "state": state_of(root)}


# ------------------------------------------------------- mirrored tests --

@contextlib.contextmanager
def mirrored():
    """While open, every `TestLedger.apply_tx` and `check_valid` of
    tests/txtest_utils.py (the JAX package's op-level test ledger) runs
    in the port too, on a port root carried from the JAX root's bytes:
    the verdict, the result bytes and, after an apply, every ledger entry
    and the header must be equal. A port root is (re)built from the JAX
    root whenever the two differ before a step, which happens only when
    the test changed the JAX ledger by hand (`advance_ledger`, a direct
    entry edit) or on a ledger's first step. An envelope the JAX package
    cannot encode (a hand-built 65-byte signature) cannot reach the
    port, and is only counted. Yields counters: applied, checked,
    synced, unencodable, and the JAX result code of each apply."""
    import txtest_utils as tu
    stats = SimpleNamespace(applied=0, checked=0, synced=0, unencodable=0,
                            codes=[])
    roots = {}
    orig_apply, orig_check = tu.TestLedger.apply_tx, tu.TestLedger.check_valid

    def port_root_for(led):
        held = roots.get(id(led))
        if held is None or state_of(held[1]) != state_of(led.root):
            held = roots[id(led)] = (led, port_root(led.root))
            stats.synced += 1
        return held[1]

    def port_frame(frame):
        try:
            data = frame.envelope.to_bytes()
        except J.runtime.XdrError:
            stats.unencodable += 1
            return None
        return frame_of(P, data)

    def apply_tx(self, frame, base_fee=None):
        proot = port_root_for(self)
        pframe = port_frame(frame)
        if pframe is None:
            return orig_apply(self, frame, base_fee)
        ok = orig_apply(self, frame, base_fee)
        pok = apply_one(P, proot, pframe, base_fee)
        assert (pok, pframe.result.to_bytes()) == \
            (ok, frame.result.to_bytes())
        assert state_of(proot) == state_of(self.root)
        stats.applied += 1
        stats.codes.append(frame.result.result.disc)
        return ok

    def check_valid(self, frame):
        proot = port_root_for(self)
        pframe = port_frame(frame)
        ok = orig_check(self, frame)
        if pframe is None:
            return ok
        with P.ledger_txn.LedgerTxn(proot) as ltx:
            pok = pframe.check_valid(ltx)
        assert (pok, pframe.result.to_bytes()) == \
            (ok, frame.result.to_bytes())
        stats.checked += 1
        return ok

    tu.TestLedger.apply_tx, tu.TestLedger.check_valid = apply_tx, check_valid
    try:
        yield stats
    finally:
        tu.TestLedger.apply_tx = orig_apply
        tu.TestLedger.check_valid = orig_check


def run_reference_test(module, owner, name) -> SimpleNamespace:
    """Run one JAX-package test (`owner.name` of `module`, or the module
    function `name`) under `mirrored()`: a method gets the fixtures
    `ledger` (a fresh TestLedger) and `root` (its root account). Returns
    the mirror's counters."""
    import txtest_utils as tu
    clear_caches()
    with mirrored() as stats:
        if owner is None:
            getattr(module, name)()
        else:
            ledger = tu.TestLedger()
            getattr(getattr(module, owner)(), name)(ledger,
                                                    ledger.root_account)
    assert stats.applied + stats.checked > 0
    return stats


def reference_cases(module, owners):
    """(module, owner, name) of each test method of the named classes;
    an owner of None names the module's test functions."""
    out = []
    for owner in owners:
        if owner is None:
            out += [(module, None, n) for n, f in vars(module).items()
                    if n.startswith("test_") and callable(f)]
        else:
            out += [(module, owner, n) for n in vars(getattr(module, owner))
                    if n.startswith("test_")]
    return out


def case_id(case) -> str:
    module, owner, name = case
    return f"{module.__name__}.{owner + '.' if owner else ''}{name}"


def contract_meta(meta):
    """The contract events and return value an apply wrote into `meta`,
    as bytes."""
    sm = meta.get("soroban") or {}
    rv = sm.get("return_value")
    return ([e.to_bytes() for e in sm.get("events", [])],
            None if rv is None else rv.to_bytes())


# ---------------------------------------------------------------- tx sets --

class OracleVerifier:
    """Batch-verifier stand-in: the port's strict oracle per tuple, every
    call recorded. With `fail`, each call raises after recording."""

    def __init__(self, fail: bool = False):
        self.calls = []
        self.fail = fail

    def verify_tuples(self, items):
        from stellar_core_tpu_torch.crypto import ed25519_ref
        self.calls.append(list(items))
        if self.fail:
            raise RuntimeError("stand-in batch verifier down")
        return [ed25519_ref.verify(p, s, m) for p, s, m in items]

    def verify_tuples_async(self, items):
        """The same, as the collect handle the supervisor and the
        service dispatch through."""
        out = self.verify_tuples(items)
        return lambda: out


def run_set(pkg, root, envelopes, batch_verifier=None,
            network_id: bytes = NETWORK_ID, apply_batch=None,
            invariants: bool = False, events: bool = False) -> dict:
    """The herder's txset path in `pkg`: a set of the envelopes, its
    check_valid (through `_LazyBatchPrevalidator(batch_verifier)` when
    given, else `default_verify`), trim_invalid, a set of the valid
    ones, and its apply in apply order (every fee, then every tx) in one
    LedgerTxn over the next ledger's header, which commits. With
    `apply_batch`, the apply verifies as catchup's does: the valid
    transactions' tuples with the network id in one `verify_tuples`
    call, a `PrevalidatedVerifier` of its results as `verify`, each
    result written through to the verify cache (the host's auth check
    reads the cache), whose hits and misses during the apply are
    returned. With `invariants`, every default invariant is enabled; with
    `events`, each applied transaction's contract events and return
    value are returned, as bytes."""
    pkg.keys.clear_verify_cache()
    frames = [frame_of(pkg, e, network_id) for e in envelopes]
    _, applicable, excluded = pkg.tx_set.make_tx_set_from_transactions(
        frames, root.get_header(), network_id)
    default = pkg.checker.default_verify
    verify = pkg.herder._LazyBatchPrevalidator(
        batch_verifier, applicable, default) if batch_verifier else default
    out = {"excluded": [t.full_hash() for t in excluded],
           "contents_hash": applicable.get_contents_hash(),
           "set_bytes": applicable.to_wire().to_bytes(),
           "apply_order": [t.full_hash()
                           for t in applicable.get_txs_in_apply_order()],
           "verdict": applicable.check_valid(root, verify=verify)}
    kept, dropped = pkg.tx_set.trim_invalid(applicable.txs, root, verify)
    out["kept"] = [t.full_hash() for t in kept]
    out["dropped"] = [t.full_hash() for t in dropped]
    out["codes"] = {t.full_hash(): t.result.to_bytes()
                    for t in applicable.txs}
    _, valid_set, _ = pkg.tx_set.make_tx_set_from_transactions(
        kept, root.get_header(), network_id)
    order = valid_set.get_txs_in_apply_order()
    manager = None
    if invariants:
        manager = pkg.invariant.InvariantManager()
        pkg.invariant.register_default_invariants(manager)
        manager.enable([".*"])
    if apply_batch is not None:
        tuples = pkg.checker.collect_signature_tuples(order, network_id)
        out["apply_tuples"] = tuples
        out["apply_verdicts"] = list(apply_batch.verify_tuples(tuples))
        verify = pkg.checker.PrevalidatedVerifier(fallback=default)
        verify.add_results(tuples, out["apply_verdicts"])
        for (pub, sig, msg), ok in zip(tuples, out["apply_verdicts"]):
            pkg.keys.seed_verify_cache(pub, sig, msg, ok)
        pkg.keys.flush_verify_cache_counts()
    metas = [{} if events else None for _ in order]
    with pkg.ledger_txn.LedgerTxn(root) as ltx:
        ltx.load_header().ledgerSeq += 1
        for t in order:
            t.process_fee_seq_num(ltx, valid_set.base_fee_for(t))
        out["applied"] = [t.apply(ltx, valid_set.base_fee_for(t),
                                  verify=verify, invariants=manager,
                                  meta=meta)
                          for t, meta in zip(order, metas)]
        ltx.commit()
    if events:
        out["events"] = [contract_meta(meta) for meta in metas]
    if apply_batch is not None:
        out["apply_cache"] = pkg.keys.flush_verify_cache_counts()
    out["order"] = [t.full_hash() for t in order]
    out["results"] = [t.result.to_bytes() for t in order]
    out["state"] = state_of(root)
    pv = getattr(verify, "_pv", None)
    out["pv"] = None if pv is None else (pv.hits, pv.misses)
    return out


# the mixed set: (kind, transactions of that kind) per 40
MIX = (("multisig", 2), ("fee_bump", 2), ("flipped", 1), ("extra_sig", 1),
       ("bad_seq", 2), ("low_balance", 2), ("underfunded_op", 2),
       ("chain", 4))


def jax_mixed_set(n: int = 40, seed: int = 11, mix=MIX):
    """A JAX ledger and the envelope bytes of n one-Payment txs: the
    chosen mix of chip_smoke.py phase 9 (2-of-2 multisig, fee bumps, a
    flipped signature byte, an unneeded signature) plus bad sequence
    numbers, a balance below the fee (txINSUFFICIENT_BALANCE), payments
    the source cannot cover (fail at apply) and chains of two txs from
    one account (each "chain" kind adds a second tx, so the set holds n
    plus that many); the rest plain. Returns (root, envelopes, the kind
    of each envelope)."""
    from stellar_core_tpu.crypto.keys import SecretKey
    from stellar_core_tpu.tx import make_frame
    from txtest_utils import make_header, op_payment
    T = J.transaction
    Ty = J.types
    rng = np.random.default_rng(seed)
    kinds = []
    for kind, k in mix:
        kinds += [kind] * k
    kinds += ["plain"] * (n - len(kinds))
    kinds = [kinds[i] for i in rng.permutation(n)]
    header = make_header()
    header.maxTxSetSize = 4 * n
    root = J.ledger_txn.InMemoryLedgerTxnRoot(header)
    seq0 = J.tx_utils.starting_sequence_number(1)

    def key():
        return SecretKey.from_seed(rng.bytes(32))

    def decorated(sk, h):
        return T.DecoratedSignature(hint=sk.public_key().hint(),
                                    signature=sk.sign(h))

    def account(ltx, sk, balance, second=None):
        le = J.tx_utils.make_account_ledger_entry(
            Ty.PublicKey.ed25519(sk.public_key().raw), balance, seq0)
        if second is not None:
            acc = le.data.value
            acc.signers = [J.entries.Signer(key=Ty.SignerKey(
                Ty.SignerKeyType.SIGNER_KEY_TYPE_ED25519,
                second.public_key().raw), weight=1)]
            acc.numSubEntries = 1
            acc.thresholds = bytes([1, 1, 2, 2])
        ltx.create(le)

    def envelope(src, dst, seq, amount, signers):
        tx = T.Transaction(
            sourceAccount=T.MuxedAccount.from_ed25519(src.public_key().raw),
            fee=100, seqNum=seq,
            cond=T.Preconditions(T.PreconditionType.PRECOND_NONE),
            memo=T.Memo(T.MemoType.MEMO_NONE),
            operations=[op_payment(
                T.MuxedAccount.from_ed25519(dst.public_key().raw), amount)],
            ext=T._TxExt(0))
        v1 = T.TransactionV1Envelope(tx=tx, signatures=[])
        env = T.TransactionEnvelope(Ty.EnvelopeType.ENVELOPE_TYPE_TX, v1)
        h = make_frame(env, NETWORK_ID).contents_hash()
        v1.signatures = [decorated(sk, h) for sk in signers]
        return env, v1

    envelopes, env_kinds = [], []
    with J.ledger_txn.LedgerTxn(root) as ltx:
        for i, kind in enumerate(kinds):
            src, dst = key(), key()
            second = key() if kind == "multisig" else None
            balance = 10_000_000 if kind == "low_balance" else 1000 * XLM
            account(ltx, src, balance, second)
            account(ltx, dst, 1000 * XLM)
            amount = (5000 if kind == "underfunded_op" else 1 + i) * XLM
            seq = seq0 + (3 if kind == "bad_seq" else 1)
            env, v1 = envelope(src, dst, seq, amount,
                               [src] + ([second] if second else []))
            if kind == "flipped":
                sig = bytearray(v1.signatures[0].signature)
                sig[int(rng.integers(64))] ^= 1 << int(rng.integers(8))
                v1.signatures[0].signature = bytes(sig)
            elif kind == "extra_sig":
                h = make_frame(env, NETWORK_ID).contents_hash()
                v1.signatures.append(decorated(key(), h))
            elif kind == "fee_bump":
                fb = T.FeeBumpTransactionEnvelope(
                    tx=T.FeeBumpTransaction(
                        feeSource=T.MuxedAccount.from_ed25519(
                            dst.public_key().raw),
                        fee=400, innerTx=T._FeeBumpInnerTx(
                            Ty.EnvelopeType.ENVELOPE_TYPE_TX, v1),
                        ext=T._TxExt(0)),
                    signatures=[])
                env = T.TransactionEnvelope(
                    Ty.EnvelopeType.ENVELOPE_TYPE_TX_FEE_BUMP, fb)
                fb.signatures = [decorated(
                    dst, make_frame(env, NETWORK_ID).contents_hash())]
            elif kind == "chain":
                nxt, _ = envelope(src, dst, seq0 + 2, XLM, [src])
                envelopes.append(nxt.to_bytes())
                env_kinds.append(kind)
            envelopes.append(env.to_bytes())
            env_kinds.append(kind)
        ltx.commit()
    return root, envelopes, env_kinds
