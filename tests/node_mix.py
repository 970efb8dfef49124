"""Count the signature verifies of the JAX package's four-validator
network by kind: the mix of the node's live verify path.

    JAX_PLATFORMS=cpu python tests/node_mix.py [--ledgers L] [--load N]
        [--service]

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
drive it), and every node votes maxTxSetSize max(N, 100). With `--service`, every node gets a VerifyService over the
host's verifier at the node's defaults (VERIFY_MAX_BATCH 256,
VERIFY_BATCH_DEADLINE_MS 2), as a node with a device backend has it
(main/application.py), so the overlay admits each crank's buffered
bodies in one `Herder.recv_transactions` call
(overlay/manager.py:793-824). Every `recv_transactions` call is counted
by its number of frames (the flood bursts), per node. Prints one JSON
object.
"""

import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def kind(msg):
    return {32: "tx", 76: "value"}.get(len(msg), "envelope")


class HostVerifier:
    """The verifier a VerifyService flushes into: each tuple through
    PubKeyUtils.verify_sig (so the counts below see it), one at a
    time."""

    def verify_tuples_async(self, tuples):
        from stellar_core_tpu.crypto import keys
        got = [keys.PubKeyUtils.verify_sig(p, s, m) for p, s, m in tuples]
        return lambda: got


def count(ledgers=6, load=0, service=False):
    from stellar_core_tpu.crypto import keys
    from stellar_core_tpu.herder.herder import Herder
    from stellar_core_tpu.ops.verify_service import VerifyService
    from stellar_core_tpu.simulation import topologies
    from stellar_core_tpu.simulation.load_generator import LoadGenerator

    calls, misses = collections.Counter(), collections.Counter()
    sizes = collections.Counter()
    verify, uncached = keys.PubKeyUtils.verify_sig, keys.verify_sig_uncached

    def counted(pub, sig, msg, use_cache=True):
        calls[kind(msg)] += 1
        if kind(msg) == "envelope":
            sizes[len(msg)] += 1
        return verify(pub, sig, msg, use_cache)

    def counted_uncached(pub, sig, msg):
        misses[kind(msg)] += 1
        return uncached(pub, sig, msg)

    bursts = collections.defaultdict(collections.Counter)
    recv = Herder.recv_transactions

    def counted_recv(herder, frames, bad_sig=None):
        bursts[herder.config.NODE_SEED.public_key().raw][len(frames)] += 1
        return recv(herder, frames, bad_sig)

    keys.PubKeyUtils.verify_sig = staticmethod(counted)
    keys.verify_sig_uncached = counted_uncached
    Herder.recv_transactions = counted_recv
    def configure(cfg):
        # a ledger must hold the N payments: every node votes
        # maxTxSetSize N (genesis admits 100 operations per set)
        cfg.TESTING_UPGRADE_MAX_TX_SET_SIZE = max(load, 100)
    sim = topologies.core(4, configure=configure if load else None)
    try:
        if service:
            for app in sim.apps():
                app.verify_service = VerifyService(
                    HostVerifier(), clock=app.clock, metrics=app.metrics,
                    perf=app.perf,
                    max_batch=app.config.VERIFY_MAX_BATCH,
                    deadline_ms=app.config.VERIFY_BATCH_DEADLINE_MS)
                app.herder.verify_service = app.verify_service
                app.ledger_manager.verify_service = app.verify_service
        sim.start_all_nodes()
        first = min(a.ledger_manager.get_last_closed_ledger_num()
                    for a in sim.apps())
        gen = LoadGenerator(sim.apps()[0], seed=42) if load else None
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
    finally:
        keys.PubKeyUtils.verify_sig = staticmethod(verify)
        keys.verify_sig_uncached = uncached
        Herder.recv_transactions = recv
        sim.stop_all_nodes()
    nodes = [a.config.NODE_SEED.public_key().raw for a in sim.apps()]
    return {"nodes": 4, "ledgers": [first + 1, last], "load": load,
            "service": service, "payments_admitted": paid,
            "calls": dict(calls), "misses": dict(misses),
            "envelope_sizes": dict(sorted(sizes.items())),
            "recv_transactions_frames": [
                dict(sorted(bursts[n].items())) for n in nodes],
            "per_node_per_ledger": {
                k: round(v / 4 / (last - first), 2)
                for k, v in calls.items()}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ledgers", type=int, default=6)
    ap.add_argument("--load", type=int, default=0)
    ap.add_argument("--service", action="store_true")
    a = ap.parse_args()
    print(json.dumps(count(a.ledgers, a.load, a.service)))
