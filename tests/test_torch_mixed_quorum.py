"""A mixed quorum: one port validator among three of the JAX package,
over loopback links that carry only bytes.

The network is the JAX package's simulation/topologies.core(4) (seeds
sha256("topo-core-i"), one flat quorum set of threshold 3, the
simulation's node configuration), with node 3 a port Application. Node
0's LoadGenerator creates accounts and floods payments, which reach the
port node through adverts, demands and the herder's batched admission,
and the port node's SCP envelopes reach the JAX nodes the same way.

Each package's Application runs on its own package's VirtualClock.
Lockstep cranks the two clocks as one, with the phases of
VirtualClock.crank in order over both: posted actions in the order they
were posted, the I/O pollers (the connections' pump, then each node's
process and work pollers, in node order), then due timers in (when, seq)
order, the two clocks drawing seq from one counter and holding one
virtual time (a jump goes to the earliest next event of either). Each
cross-package link is a LoopbackPeer of each package whose partner is a
Wire: it hands the other side's peer the frame's bytes and reads its
state's name, nothing else. The peers' handshake randomness (os.urandom:
the auth nonce, the ephemeral Curve25519 key) draws from one seeded
stream in every run.

The reference is the four JAX nodes of topologies.core(4) driven by
Simulation.crank_until on one clock, from the same seeds and stream. The
mixed run must externalize the same values, reach the same LCL, and
every node must send the same frames (the AuthenticatedMessage bytes,
MAC included) in the same order as in the reference.
"""

import hashlib
import heapq
import itertools
import os
import sys
from types import SimpleNamespace

from torch_tx_parity import J, P, clear_caches

NODES, PORT_NODE = 4, 3
LOAD, LEDGERS = 20, 4


class Wire:
    """The partner of a LoopbackPeer across the packages: delivers frame
    bytes to the other package's peer and reports its state's name."""

    def __init__(self, peer):
        self._peer = peer

    @property
    def state(self):
        return SimpleNamespace(name=self._peer.state.name)

    def recv_bytes(self, raw):
        self._peer.recv_bytes(bytes(raw))


class WiredConnection:
    """LoopbackPeerConnection between apps of two packages: each side a
    LoopbackPeer of its own package, joined by Wires."""

    def __init__(self, initiator_app, initiator_pkg, acceptor_app,
                 acceptor_pkg):
        self.initiator = initiator_pkg.loopback.LoopbackPeer(
            initiator_app.overlay_manager,
            initiator_pkg.peer.PeerRole.WE_CALLED_REMOTE)
        self.acceptor = acceptor_pkg.loopback.LoopbackPeer(
            acceptor_app.overlay_manager,
            acceptor_pkg.peer.PeerRole.REMOTE_CALLED_US)
        self.initiator.partner = Wire(self.acceptor)
        self.acceptor.partner = Wire(self.initiator)
        initiator_app.overlay_manager.add_pending_peer(self.initiator)
        acceptor_app.overlay_manager.add_pending_peer(self.acceptor)
        self.acceptor.connect_handler()
        self.initiator.connect_handler()


class Lockstep:
    """Crank VirtualClocks of several packages as one clock (see the
    module docstring)."""

    def __init__(self, clocks):
        self.clocks = clocks
        self.connections, self.pollers, self._actions = [], [], []
        seq = itertools.count()
        for c in clocks:
            c._seq = seq
            c.post = self._actions.append
            c.add_io_poller = self.pollers.append
            c.remove_io_poller = self._remove_poller

    def _remove_poller(self, poller):
        if poller in self.pollers:
            self.pollers.remove(poller)

    def now(self):
        return self.clocks[0].now()

    def _dispatch_due(self):
        n, now = 0, self.now()
        while True:
            heads = [c for c in self.clocks if c._heap]
            if not heads:
                return n
            c = min(heads, key=lambda c: (c._heap[0].when, c._heap[0].seq))
            if c._heap[0].when > now:
                return n
            ev = heapq.heappop(c._heap)
            if not ev.cancelled:
                ev.callback(sys.modules[type(c).__module__]
                            .TimerError.SUCCESS)
                n += 1

    def crank(self, block):
        actions, self._actions[:] = list(self._actions), []
        for a in actions:
            a()
        n = len(actions)
        for conn in self.connections:
            n += conn.initiator.deliver_all()
            n += conn.acceptor.deliver_all()
        for p in list(self.pollers):
            n += p()
        n += self._dispatch_due()
        if n == 0 and block:
            nxt = [t for t in (c.next_event_time() for c in self.clocks)
                   if t is not None]
            if nxt:
                t = max(self.now(), min(nxt))
                for c in self.clocks:
                    c._virtual_now = t
                n += self._dispatch_due()
        return n

    def crank_until(self, pred, timeout):
        deadline = self.now() + timeout
        while not pred() and self.now() < deadline:
            if self.crank(False) == 0:
                self.crank(True)
        return pred()


def _seeds(pkg):
    return [pkg.keys.SecretKey.from_seed(hashlib.sha256(
        b"topo-core-%d" % i).digest()) for i in range(NODES)]


def _urandom_stream():
    counter = itertools.count()
    return lambda n: b"".join(hashlib.sha256(
        b"handshake %d" % next(counter)).digest()
        for _ in range((n + 31) // 32))[:n]


def _recorded(pkgs):
    """Patch each package's LoopbackPeer._send_bytes and Herder's
    externalize hook to record frames and values per node id; returns
    (frames, values, undo)."""
    frames, values, undo = {}, {}, []
    for pkg in pkgs:
        cls, h_cls = pkg.loopback.LoopbackPeer, pkg.herder.Herder
        send, ext = cls._send_bytes, h_cls.value_externalized_from_scp

        def sent(self, raw, send=send):
            frames.setdefault(self.app.config.node_id(), []).append(
                bytes(raw))
            return send(self, raw)

        def externalized(self, slot, value, ext=ext):
            values.setdefault(self.config.node_id(), []).append(
                (slot, bytes(value)))
            return ext(self, slot, value)
        cls._send_bytes, h_cls.value_externalized_from_scp = \
            sent, externalized
        undo.append(lambda cls=cls, h_cls=h_cls, send=send, ext=ext: (
            setattr(cls, "_send_bytes", send),
            setattr(h_cls, "value_externalized_from_scp", ext)))
    return frames, values, lambda: [u() for u in undo]


def _load_and_close(apps, network, pkg0):
    """Node 0's load generator creates LOAD accounts, then pays LOAD
    payments before each later ledger; `network` cranks until every
    node closed each of LEDGERS ledgers. Returns the LCL hashes."""
    first = min(a.ledger_manager.get_last_closed_ledger_num()
                for a in apps)
    gen = pkg0.load_generator.LoadGenerator(apps[0], seed=42)
    gen.generate_accounts(LOAD)
    for seq in range(first + 1, first + 1 + LEDGERS):
        if seq > first + 1:
            gen.sync_account_seqs()
            gen.generate_payments(LOAD)
        assert network.crank_until(lambda: all(
            a.ledger_manager.get_last_closed_ledger_num() >= seq
            for a in apps), 120.0), seq
    return [a.ledger_manager.get_last_closed_ledger_hash() for a in apps]


def _reference_run():
    """topologies.core(4) of the JAX package through
    Simulation.crank_until."""
    frames, values, undo = _recorded([J])
    def configure(cfg):
        cfg.TESTING_UPGRADE_MAX_TX_SET_SIZE = 100
    sim = J.topologies.core(NODES, configure=configure)
    try:
        sim.start_all_nodes()
        lcl = _load_and_close(sim.apps(), sim, J)
    finally:
        undo()
        sim.stop_all_nodes()
    return frames, values, lcl


def _mixed_run():
    """The same network with node PORT_NODE a port Application, on the
    port's clock, cranked in lockstep with the JAX nodes' clock."""
    frames, values, undo = _recorded([J, P])
    pkgs = [P if i == PORT_NODE else J for i in range(NODES)]
    clocks = {pkg.name: pkg.timer.VirtualClock(
        pkg.timer.ClockMode.VIRTUAL_TIME) for pkg in (J, P)}
    lockstep = Lockstep([clocks[J.name], clocks[P.name]])
    ids = [s.public_key().raw for s in _seeds(J)]
    apps = []
    try:
        for i, pkg in enumerate(pkgs):
            qset = pkg.config.QuorumSetConfig(
                threshold=(2 * NODES + 2) // 3, validators=ids)
            shim = SimpleNamespace(network_passphrase="(V) (;,,;) (V)",
                                   data_dir=None)

            def configure(cfg):
                cfg.TESTING_UPGRADE_MAX_TX_SET_SIZE = 100
            cfg = pkg.simulation.Simulation._make_config(
                shim, i, _seeds(pkg)[i], qset, configure)
            apps.append(pkg.application.Application.create(
                clocks[pkg.name], cfg))
        for i in range(NODES):
            for j in range(i + 1, NODES):
                if pkgs[i] is pkgs[j]:
                    conn = pkgs[i].loopback.LoopbackPeerConnection(
                        apps[i], apps[j])
                else:
                    conn = WiredConnection(apps[i], pkgs[i], apps[j],
                                           pkgs[j])
                lockstep.connections.append(conn)
        for app in apps:
            app.start()
        lcl = _load_and_close(apps, lockstep, J)
    finally:
        undo()
        for app in apps:
            app.shutdown()
    return frames, values, lcl


def test_port_node_in_a_jax_quorum_sends_the_same_bytes(monkeypatch):
    monkeypatch.setattr(os, "urandom", _urandom_stream())
    clear_caches()
    ref_frames, ref_values, ref_lcl = _reference_run()
    monkeypatch.setattr(os, "urandom", _urandom_stream())
    clear_caches()
    frames, values, lcl = _mixed_run()
    clear_caches()
    port_id = _seeds(P)[PORT_NODE].public_key().raw
    assert len(set(lcl)) == 1 and lcl == ref_lcl
    assert values == ref_values
    assert set(frames) == set(ref_frames) and port_id in frames
    for node, sent in ref_frames.items():
        assert frames[node] == sent, node.hex()[:8]
    assert len(frames[port_id]) > 100
