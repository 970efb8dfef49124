"""Count the signature verifies of a four-validator network by kind: the
mix of the node's live verify path, in the JAX package or the port.

    JAX_PLATFORMS=cpu python tests/node_mix.py [--ledgers L] [--load N]
        [--service | --backend] [--port]

Runs `simulation/topologies.core(4)` (four validators, one flat quorum
set of threshold 3, native verification) on the CPU until every node has
closed ledger L + 1, and counts each `PubKeyUtils.verify_sig` call (the
seam every native verify goes through) by signed message length: 32
bytes, a transaction's contents hash; 76, a StellarValue's signed bytes
(network id, envelope type, tx set hash, close time); any other, an SCP
envelope's. Calls and verify-cache misses (the verifies that ran) are
counted apart, per kind. With `--load N`, node 0's LoadGenerator
submits the creation of N accounts before the first close and N
payments before each later one (PAY mode, as the load generator's tests
drive it), and every node votes maxTxSetSize max(N, 100). With
`--service`, every node gets a VerifyService over the host's verifier at
the node's defaults (VERIFY_MAX_BATCH 256, VERIFY_BATCH_DEADLINE_MS 2),
as a node with a device backend has it (main/application.py), so the
overlay admits each crank's buffered bodies in one
`Herder.recv_transactions` call (overlay/manager.py:793-824). With
`--backend`, every node's Config selects the device backend ("tpu" in
the JAX package, "cuda" in the port) and the Application builds its own
BackendSupervisor and VerifyService, over a `CountingVerifier` in place
of the device verifier (the only difference from a node on the card):
each of its dispatches is recorded, per node, with its size and the
prep mode the card would run (msg32 when every message is 32 bytes,
else k), as a device dispatch when it reaches VERIFY_DEVICE_MIN_BATCH
and as the native bypass below it, with the service's flushes by
reason, the consensus verifies by route (device, bypass, the service's
own cache) and the txset prevalidator's verify-cache probes. `--port`
runs the port's modules instead of the JAX package's. Every
`recv_transactions` call is counted by its number of frames (the flood
bursts), per node, also as a list in call order. Prints one JSON
object.
"""

import argparse
import collections
import importlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

JAX_ROOT, PORT_ROOT = "stellar_core_tpu", "stellar_core_tpu_torch"


def kind(msg):
    return {32: "tx", 76: "value"}.get(len(msg), "envelope")


class HostVerifier:
    """The verifier a VerifyService flushes into: each tuple through
    PubKeyUtils.verify_sig (so the counts below see it), one at a
    time."""

    def __init__(self, keys):
        self.keys = keys

    def verify_tuples(self, tuples):
        return [self.keys.PubKeyUtils.verify_sig(p, s, m)
                for p, s, m in tuples]

    def verify_tuples_async(self, tuples):
        got = self.verify_tuples(tuples)
        return lambda: got


class CountingVerifier(HostVerifier):
    """Stands in for the device batch verifier an Application builds for
    the device backend: the same bypass cutoff (`device_min_batch`, live
    re-tunable) and dispatch accounting (crypto.verify.dispatch.batch in
    `metrics`), verdicts from the host. Records each dispatch as
    (size, "msg32" | "k" | "bypass")."""

    def __init__(self, keys, device_min_batch=16, metrics=None):
        super().__init__(keys)
        self._device_min_batch = device_min_batch
        self._m_batch = None if metrics is None else \
            metrics.new_histogram("crypto.verify.dispatch.batch")
        self.dispatches = []

    def set_device_min_batch(self, n):
        self._device_min_batch = max(1, int(n))

    def verify_tuples(self, tuples):
        tuples = list(tuples)
        if not tuples:
            return []
        if len(tuples) < self._device_min_batch:
            mode = "bypass"
        else:
            mode = "msg32" if all(len(m) == 32 for _, _, m in tuples) \
                else "k"
            if self._m_batch is not None:
                self._m_batch.update(len(tuples))
        self.dispatches.append((len(tuples), mode))
        return super().verify_tuples(tuples)


def _pkg(port):
    root = PORT_ROOT if port else JAX_ROOT
    return {k: importlib.import_module(f"{root}.{m}") for k, m in (
        ("keys", "crypto.keys"), ("herder", "herder.herder"),
        ("service", "ops.verify_service"),
        ("topologies", "simulation.topologies"),
        ("load_generator", "simulation.load_generator"),
        ("application", "main.application"))}


def count(ledgers=6, load=0, service=False, port=False, backend=False):
    m = _pkg(port)
    keys, Herder = m["keys"], m["herder"].Herder
    Application = m["application"].Application

    calls, misses = collections.Counter(), collections.Counter()
    sizes = collections.Counter()
    verify, uncached = keys.PubKeyUtils.verify_sig, keys.verify_sig_uncached
    probe = keys.probe_verify_cache
    probes = [0, 0]

    def counted(pub, sig, msg, use_cache=True):
        calls[kind(msg)] += 1
        if kind(msg) == "envelope":
            sizes[len(msg)] += 1
        return verify(pub, sig, msg, use_cache)

    def counted_uncached(pub, sig, msg):
        misses[kind(msg)] += 1
        return uncached(pub, sig, msg)

    def counted_probe(*t):
        hit = probe(*t)
        probes[hit is None] += 1
        return hit

    bursts = collections.defaultdict(list)
    consensus = collections.defaultdict(collections.Counter)
    recv = Herder.recv_transactions
    verify_env, verify_sv = (Herder.verify_envelope,
                             Herder.verify_stellar_value_signature)
    make_bv = Application._make_batch_verifier
    verifiers = {}

    def node(herder):
        return herder.config.NODE_SEED.public_key().raw

    def counted_recv(herder, frames, bad_sig=None):
        bursts[node(herder)].append(len(frames))
        return recv(herder, frames, bad_sig)

    def counted_env(herder, env):
        consensus[node(herder)]["envelope"] += 1
        return verify_env(herder, env)

    def counted_sv(herder, sv):
        consensus[node(herder)]["value"] += 1
        return verify_sv(herder, sv)

    def counting_bv(app):
        v = CountingVerifier(keys, app.config.VERIFY_DEVICE_MIN_BATCH,
                             app.metrics)
        verifiers[app.config.node_id()] = v
        return v

    keys.PubKeyUtils.verify_sig = staticmethod(counted)
    keys.verify_sig_uncached = counted_uncached
    keys.probe_verify_cache = counted_probe
    Herder.recv_transactions = counted_recv
    Herder.verify_envelope = counted_env
    Herder.verify_stellar_value_signature = counted_sv
    Application._make_batch_verifier = counting_bv

    def configure(cfg):
        if load:
            # a ledger must hold the N payments: every node votes
            # maxTxSetSize N (genesis admits 100 operations per set)
            cfg.TESTING_UPGRADE_MAX_TX_SET_SIZE = max(load, 100)
        if backend:
            cfg.SIGNATURE_VERIFY_BACKEND = "cuda" if port else "tpu"
    sim = None
    try:
        sim = m["topologies"].core(4, configure=configure
                                   if load or backend else None)
        if service:
            for app in sim.apps():
                app.verify_service = m["service"].VerifyService(
                    HostVerifier(keys), clock=app.clock,
                    metrics=app.metrics, perf=app.perf,
                    max_batch=app.config.VERIFY_MAX_BATCH,
                    deadline_ms=app.config.VERIFY_BATCH_DEADLINE_MS)
                app.herder.verify_service = app.verify_service
                app.ledger_manager.verify_service = app.verify_service
        sim.start_all_nodes()
        first = min(a.ledger_manager.get_last_closed_ledger_num()
                    for a in sim.apps())
        gen = m["load_generator"].LoadGenerator(sim.apps()[0], seed=42) \
            if load else None
        if gen is not None:
            gen.generate_accounts(load)
        paid = 0
        for seq in range(first + 1, first + 1 + ledgers):
            if gen is not None and seq > first + 1:
                gen.sync_account_seqs()
                paid += gen.generate_payments(load)
            if not sim.crank_until(lambda: sim.have_all_externalized(seq),
                                   120.0):
                raise SystemExit(f"ledger {seq} did not close everywhere")
        last = min(a.ledger_manager.get_last_closed_ledger_num()
                   for a in sim.apps())
        lcl = {a.ledger_manager.get_last_closed_ledger_hash().hex()
               for a in sim.apps()}
        services = [a.verify_service.stats() if backend else None
                    for a in sim.apps()]
    finally:
        keys.PubKeyUtils.verify_sig = staticmethod(verify)
        keys.verify_sig_uncached = uncached
        keys.probe_verify_cache = probe
        Herder.recv_transactions = recv
        Herder.verify_envelope = verify_env
        Herder.verify_stellar_value_signature = verify_sv
        Application._make_batch_verifier = make_bv
        if sim is not None:
            sim.stop_all_nodes()
    nodes = [a.config.NODE_SEED.public_key().raw for a in sim.apps()]
    out = {"nodes": 4, "ledgers": [first + 1, last], "load": load,
           "service": service, "backend": backend,
           "package": PORT_ROOT if port else JAX_ROOT,
           "payments_admitted": paid,
           "calls": dict(calls), "misses": dict(misses),
           "envelope_sizes": dict(sorted(sizes.items())),
           "recv_transactions_frames": [
               dict(sorted(collections.Counter(bursts[n]).items()))
               for n in nodes],
           "recv_transactions_calls": [bursts[n] for n in nodes],
           "lcl": sorted(lcl),
           "per_node_per_ledger": {
               k: round(v / 4 / (last - first), 2)
               for k, v in calls.items()}}
    if backend:
        out["verifier"] = [_dispatches(verifiers[n].dispatches,
                                       consensus[n], st)
                           for n, st in zip(nodes, services)]
        out["prevalidator_probes"] = {"hits": probes[0],
                                      "misses": probes[1]}
    return out


def _dispatches(dispatches, consensus, stats):
    """One node's verifier dispatches: device dispatches by prep mode,
    bypassed flushes, the sizes of each, the service's flushes by reason,
    and the consensus verifies by route (a k-mode or long-message
    dispatch holds consensus tuples only: flood flushes are tx hashes)."""
    by_mode = collections.Counter(mode for _, mode in dispatches)
    return {
        "device": {"msg32": by_mode["msg32"], "k": by_mode["k"]},
        "bypass": by_mode["bypass"],
        "device_sizes": [list(x) for x in sorted(collections.Counter(
            n for n, mode in dispatches if mode != "bypass").items())],
        "bypass_sizes": [list(x) for x in sorted(collections.Counter(
            n for n, mode in dispatches if mode == "bypass").items())],
        "flush_reasons": {r: c for r, c in sorted(
            stats["flush_reasons"].items()) if c},
        "fallbacks": stats["fallbacks"],
        "consensus_calls": dict(sorted(consensus.items()))}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ledgers", type=int, default=6)
    ap.add_argument("--load", type=int, default=0)
    ap.add_argument("--service", action="store_true")
    ap.add_argument("--backend", action="store_true")
    ap.add_argument("--port", action="store_true")
    a = ap.parse_args()
    print(json.dumps(count(a.ledgers, a.load, a.service, a.port,
                           a.backend)))
