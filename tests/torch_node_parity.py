"""Shared by tests/test_torch_{overlay,app,control,history}.py: the JAX
package's node tests (Application, Config, overlay, simulation, control
plane, history) run on both packages, with what they close recorded.

`run_both` runs one reference case (torch_rebind.reference_cases) as
written and then rebound to the port (torch_rebind.run_case), each with
its own tmp_path directory and monkeypatch, SecretKey.random drawing the
same seeded keys in both runs, and where the test selects the device
backend ("tpu"), the Application building a CountingVerifier
(tests/node_mix.py: the bypass cutoff and dispatch accounting of the
device verifier, verdicts from the host) in place of the device
verifier, so neither package compiles or launches a kernel; the fixed
localhost ports of the reference's TCP tests are moved to a range of the
run's own (shifted_ports). Each run records, in order, every TransactionQueue.try_add result and every
LedgerManager.close_ledger: the sequence number, the closed header's
txSetResultHash (the hash of every transaction's result) and the
header's hash.
"""

from __future__ import annotations

import contextlib
import hashlib
import random
import socket

from pytest import MonkeyPatch

from node_mix import CountingVerifier
from torch_rebind import run_case
from torch_tx_parity import J, P, clear_caches


def counting_verifier(pkg, app):
    return CountingVerifier(pkg.keys, app.config.VERIFY_DEVICE_MIN_BATCH,
                            app.metrics)


def plain_kernels(pkg, app):
    """The port's CudaBatchVerifier on the CPU: its plain kernels (about
    3 s per dispatch)."""
    return pkg.verifier.CudaBatchVerifier(
        perf=app.perf, device="cpu",
        device_min_batch=app.config.VERIFY_DEVICE_MIN_BATCH,
        metrics=app.metrics)


@contextlib.contextmanager
def host_device_backend(pkg, make_verifier=counting_verifier):
    """`pkg`'s Application builds `make_verifier(pkg, app)` (by default a
    CountingVerifier) where it builds the device verifier; yields the
    list of those it built."""
    cls = pkg.application.Application
    make, made = cls._make_batch_verifier, []

    def counting(app):
        made.append(make_verifier(pkg, app))
        return made[-1]
    cls._make_batch_verifier = counting
    try:
        yield made
    finally:
        cls._make_batch_verifier = make


@contextlib.contextmanager
def recording(pkg):
    """Record every try_add result and close_ledger of `pkg` (see the
    module docstring), with SecretKey.random drawing seeded keys."""
    out = []
    lm_cls = pkg.ledger_manager.LedgerManager
    tq_cls = pkg.tx_queue.TransactionQueue
    sk_cls = pkg.keys.SecretKey
    saved = (lm_cls.close_ledger, tq_cls.try_add, vars(sk_cls)["random"])
    close_ledger, try_add, _ = saved
    drawn = iter(range(1 << 30))

    def recorded_close(self, lcd, *args, **kwargs):
        try:
            res = close_ledger(self, lcd, *args, **kwargs)
        except Exception as e:
            out.append(("close", type(e).__name__))
            raise
        h = self.get_last_closed_ledger_header()
        out.append(("close", h.ledgerSeq, bytes(h.txSetResultHash),
                    self.get_last_closed_ledger_hash()))
        return res

    def recorded_add(self, *args, **kwargs):
        res = try_add(self, *args, **kwargs)
        out.append(("add", res.name))
        return res

    def seeded(cls):
        return cls.from_seed(hashlib.sha256(
            b"rebound key %d" % next(drawn)).digest())
    lm_cls.close_ledger = recorded_close
    tq_cls.try_add = recorded_add
    sk_cls.random = classmethod(seeded)
    try:
        yield out
    finally:
        lm_cls.close_ledger, tq_cls.try_add, sk_cls.random = saved


# the localhost ports the reference's TCP tests bind and dial (34000-
# 37999), which the reference suite binds too, perhaps at the same time
# in another worker: each run here uses its own copy of the range,
# 14000-17999 and 18000-21999, below Linux's ephemeral ports (32768 and
# up by default), so no outgoing socket of another process holds one
TEST_PORTS = range(34000, 38000)
PORT_SHIFT = {J.name: -20000, P.name: -16000}


@contextlib.contextmanager
def shifted_ports(offset):
    """Every socket binds and dials a port of TEST_PORTS moved by `offset`
    (the packages' code and the test's own sockets alike), except a port
    the system handed to a bind of port 0 here: that one is dialled as
    it is."""
    cls = socket.socket
    saved = cls.bind, cls.connect, cls.connect_ex
    ephemeral = set()

    def shift(addr):
        if isinstance(addr, tuple) and len(addr) >= 2 and \
                addr[1] in TEST_PORTS and addr[1] not in ephemeral:
            return (addr[0], addr[1] + offset) + tuple(addr[2:])
        return addr

    def bind(self, addr):
        saved[0](self, shift(addr))
        if isinstance(addr, tuple) and len(addr) >= 2 and addr[1] == 0:
            ephemeral.add(self.getsockname()[1])
    cls.bind = bind
    cls.connect = lambda self, addr: saved[1](self, shift(addr))
    cls.connect_ex = lambda self, addr: saved[2](self, shift(addr))
    try:
        yield
    finally:
        cls.bind, cls.connect, cls.connect_ex = saved


def run_both(case, tmp_path, builtin=None,
             port_verifier=counting_verifier, shift=True):
    """The case on the JAX package, then on the port: each run's record.
    With `shift`, each run's sockets use its own copy of TEST_PORTS
    (off for a test whose child processes bind the ports it dials).
    `builtin` adds pytest fixtures both runs share (caplog; capsys,
    whose captured output is dropped before each run);
    `port_verifier(pkg, app)` is the port's device verifier."""
    runs = []
    # a seeded generator of the test module starts each run where the
    # first found it, so both runs draw the same values
    rngs = [(r, r.getstate()) for r in vars(case[0]).values()
            if isinstance(r, random.Random)]
    # and both number their test configs (node seeds, ports) from the
    # same instance, whatever earlier tests drew in either package
    instance = max(pkg.config._test_instance_counter[0] for pkg in (J, P))
    for pkg in (J, P):
        for r, state in rngs:
            r.setstate(state)
        pkg.config._test_instance_counter[0] = instance
        clear_caches()
        tmp = tmp_path / pkg.name
        tmp.mkdir()
        mp = MonkeyPatch()
        make = port_verifier if pkg is P else counting_verifier
        if "capsys" in (builtin or {}):      # each run reads its own output
            builtin["capsys"].readouterr()
        try:
            with host_device_backend(pkg, make), \
                    shifted_ports(PORT_SHIFT[pkg.name] if shift else 0), \
                    recording(pkg) as out:
                run_case(case, pkg is P, dict(
                    builtin or {}, tmp_path=tmp, monkeypatch=mp))
        finally:
            mp.undo()
        runs.append(out)
    clear_caches()
    return runs
