"""Fuzz harness: tx and overlay modes.

Reference: test/FuzzerImpl.{h,cpp} + docs/fuzzing.md — `gen-fuzz` writes
a random input file, `fuzz` injects one input into a prepared node. The
tx fuzzer interprets input as an XDR vector of Operations applied from a
funded source account; the overlay fuzzer interprets it as a
StellarMessage delivered over an authenticated loopback connection. A
fuzzer run "passes" when the node survives (rejecting is fine); any
crash propagates.
"""

from __future__ import annotations

import random
from typing import Any

from ..crypto.keys import SecretKey
from ..crypto.sha import sha256
from ..util.timer import ClockMode, VirtualClock
from ..xdr.runtime import (Array, EnumType, Lazy, Opaque,
                           Optional as XdrOptional, Reader, Struct, Union,
                           VarArray, VarOpaque, Writer, XdrError, _Bool,
                           _Composite, _Int32, _Int64, _Uint32, _Uint64)

FUZZER_MAX_OPERATIONS = 5


class XdrGenerator:
    """Random instances of declarative XDR types (reference: autocheck
    generators used by genFuzz; sizes biased small the same way)."""

    def __init__(self, rng: random.Random, max_elems: int = 3,
                 max_depth: int = 12):
        self.rng = rng
        self.max_elems = max_elems
        self.max_depth = max_depth

    def gen(self, t: Any, depth: int = 0) -> Any:
        if isinstance(t, Lazy):
            t = t._get()
        if isinstance(t, _Composite):
            t = t.cls
        if depth > self.max_depth:
            # bottom out with defaults to bound recursion
            return t.default() if hasattr(t, "default") else t()
        if isinstance(t, type) and issubclass(t, Struct):
            return t(**{fn: self.gen(ft, depth + 1)
                        for fn, ft in t._FIELDS})
        if isinstance(t, type) and issubclass(t, Union):
            disc = self.rng.choice(list(t._ARMS))
            arm = t._ARMS[disc]
            if arm is None or arm[1] is None:
                return t(disc)
            return t(disc, self.gen(arm[1], depth + 1))
        if isinstance(t, EnumType):
            return self.rng.choice(list(t.enum_cls))
        if isinstance(t, XdrOptional):
            if self.rng.random() < 0.5:
                return None
            return self.gen(t.elem, depth + 1)
        if isinstance(t, Opaque):
            return bytes(self.rng.getrandbits(8) for _ in range(t.n))
        if isinstance(t, VarOpaque):
            n = self.rng.randint(0, min(t.max_len, 32))
            return bytes(self.rng.getrandbits(8) for _ in range(n))
        if isinstance(t, Array):
            return [self.gen(t.elem, depth + 1) for _ in range(t.n)]
        if isinstance(t, VarArray):
            n = self.rng.randint(0, min(t.max_len, self.max_elems))
            return [self.gen(t.elem, depth + 1) for _ in range(n)]
        if isinstance(t, _Bool):
            return self.rng.random() < 0.5
        if isinstance(t, (_Int32, _Int64)):
            # biased small, occasionally extreme (autocheck-style)
            if self.rng.random() < 0.1:
                lo, hi = ((-2**31, 2**31 - 1) if isinstance(t, _Int32)
                          else (-2**63, 2**63 - 1))
                return self.rng.randint(lo, hi)
            return self.rng.randint(-100, 1000)
        if isinstance(t, (_Uint32, _Uint64)):
            if self.rng.random() < 0.1:
                hi = 2**32 - 1 if isinstance(t, _Uint32) else 2**64 - 1
                return self.rng.randint(0, hi)
            return self.rng.randint(0, 1000)
        raise TypeError(f"cannot generate {t!r}")


class TransactionFuzzer:
    """reference: FuzzerImpl.h:35 TransactionFuzzer — input is an XDR
    vector of Operations, applied from a funded account on a prepared
    standalone node."""

    def __init__(self):
        from .application import Application
        from .config import get_test_config
        self.clock = VirtualClock(ClockMode.VIRTUAL_TIME)
        cfg = get_test_config()
        self.app = Application.create(self.clock, cfg)
        self.app.start()
        # deterministic funded accounts the ops can reference
        from ..tx.tx_utils import make_account_ledger_entry
        from ..ledger.ledger_txn import LedgerTxn
        from ..xdr.types import PublicKey
        self.accounts = []
        with LedgerTxn(self.app.ledger_manager.root) as ltx:
            for i in range(8):
                sk = SecretKey.from_seed(sha256(b"fuzz-acct-%d" % i))
                le = make_account_ledger_entry(
                    PublicKey.ed25519(sk.public_key().raw), 10**12,
                    seq_num=0)
                ltx.create(le)
                self.accounts.append(sk)
            ltx.commit()

    @staticmethod
    def _ops_type():
        from ..xdr.transaction import Operation
        return VarArray(Operation, FUZZER_MAX_OPERATIONS)

    def _current_seq(self, sk: SecretKey) -> int:
        from ..ledger.ledger_txn import LedgerTxn
        from ..xdr.ledger_entries import (LedgerEntryType, LedgerKey,
                                          _LedgerKeyAccount)
        from ..xdr.types import PublicKey
        key = LedgerKey(LedgerEntryType.ACCOUNT, _LedgerKeyAccount(
            accountID=PublicKey.ed25519(sk.public_key().raw)))
        with LedgerTxn(self.app.ledger_manager.root) as ltx:
            le = ltx.load(key)
            return le.data.value.seqNum

    def inject(self, path: str) -> bool:
        """Returns True if the input parsed and was executed (possibly
        rejected); False for uninteresting (malformed) input."""
        with open(path, "rb") as f:
            data = f.read()
        try:
            r = Reader(data)
            ops = self._ops_type().unpack(r)
        except XdrError:
            return False
        if not r.done() or not ops:
            return False
        from ..tx.frame import make_frame
        from ..xdr.transaction import (EnvelopeType, Memo, MemoType,
                                       MuxedAccount, Preconditions,
                                       PreconditionType, Transaction,
                                       TransactionEnvelope,
                                       TransactionV1Envelope, _TxExt)
        source = self.accounts[0]
        muxed = MuxedAccount.from_ed25519(source.public_key().raw)
        seq = self._current_seq(source) + 1
        tx = Transaction(
            sourceAccount=muxed, fee=100 * len(ops), seqNum=seq,
            cond=Preconditions(PreconditionType.PRECOND_NONE),
            memo=Memo(MemoType.MEMO_NONE), operations=list(ops),
            ext=_TxExt(0))
        env = TransactionEnvelope(
            EnvelopeType.ENVELOPE_TYPE_TX,
            TransactionV1Envelope(tx=tx, signatures=[]))
        try:
            frame = make_frame(env, self.app.config.network_id())
        except Exception:
            return False
        from ..xdr.transaction import DecoratedSignature
        frame.signatures.append(DecoratedSignature(
            hint=source.public_key().hint(),
            signature=source.sign(frame.contents_hash())))
        frame.envelope.value.signatures = frame.signatures
        self.app.herder.recv_transaction(frame)
        self.app.manual_close()
        return True

    @classmethod
    def gen_fuzz(cls, path: str, seed: int) -> None:
        rng = random.Random(seed)
        gen = XdrGenerator(rng)
        n = rng.randint(1, FUZZER_MAX_OPERATIONS)
        from ..xdr.transaction import Operation
        ops = [gen.gen(Operation) for _ in range(n)]
        w = Writer()
        cls._ops_type().pack(w, ops)
        with open(path, "wb") as f:
            f.write(bytes(w.buf))

    def shutdown(self) -> None:
        self.app.shutdown()


class OverlayFuzzer:
    """reference: FuzzerImpl.h:66 OverlayFuzzer — input is one
    StellarMessage delivered over an authenticated loopback pair."""

    def __init__(self):
        from ..simulation import Simulation
        from .config import QuorumSetConfig

        def manual(cfg):
            cfg.MANUAL_CLOSE = True

        seeds = [SecretKey.from_seed(sha256(b"fuzz-ovl-%d" % i))
                 for i in range(2)]
        node_ids = [s.public_key().raw for s in seeds]
        qset = QuorumSetConfig(threshold=2, validators=list(node_ids))
        self.sim = Simulation(network_passphrase="fuzz overlay net")
        for sk in seeds:
            self.sim.add_node(sk, qset, configure=manual)
        self.sim.start_all_nodes()
        self.apps = self.sim.apps()
        self.sim.add_pending_connection(node_ids[0], node_ids[1])
        self.conn = self.sim.connections[0]
        self.conn.crank()

    def inject(self, path: str) -> bool:
        from ..xdr.overlay import StellarMessage
        with open(path, "rb") as f:
            data = f.read()
        try:
            msg = StellarMessage.from_bytes(data)
        except XdrError:
            return False
        self.conn.initiator.send_message(msg)
        self.conn.crank()
        # the receiving node must still close ledgers
        self.apps[1].manual_close()
        return True

    @classmethod
    def gen_fuzz(cls, path: str, seed: int) -> None:
        from ..xdr.overlay import MessageType, StellarMessage
        rng = random.Random(seed)
        gen = XdrGenerator(rng)
        msg = gen.gen(StellarMessage)
        # HELLO/AUTH/ERROR on an authenticated link are uninteresting
        # (reference: isBadOverlayFuzzerInput)
        while msg.disc in (MessageType.HELLO, MessageType.AUTH,
                           MessageType.ERROR_MSG):
            msg = gen.gen(StellarMessage)
        with open(path, "wb") as f:
            f.write(msg.to_bytes())

    def shutdown(self) -> None:
        self.sim.stop_all_nodes()
