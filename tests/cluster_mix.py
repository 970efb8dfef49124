"""Phase 17's cluster on the CPU: what its run on the card should show.

    python tests/cluster_mix.py [--accounts N] [--rounds R] [--out FILE]

Runs chip_smoke.cluster_run (four `python -m stellar_core_tpu_torch run`
processes of the port's simulation/cluster.py over real TCP, leg 1's
load, leg 2's bad-signature flood, leg 3's kill -9 and catchup) three
times on the CPU: twice with SIGNATURE_VERIFY_BACKEND "native" (run B
twice: which fields of the end state two native runs share), and once
with "cuda" whose node processes start through this script (`--node`):
each Application then builds a counting host verifier
(tests/node_mix.py's CountingVerifier: the card's bypass cutoff and
dispatch accounting, verdicts from the host) where the card's would be,
with its own supervisor and verify service as on the card. Each node
process of that run writes, at its graceful exit, to
<data_dir>/mix-<pid>.json: every recv_transactions call's frames in
order, the verifier's dispatches (size, prep mode or bypass) and the
txset prevalidator's verify-cache probes (a node killed with -9 writes
nothing for that life). Prints one JSON object: per run the legs'
walls, the pay rounds, the close timers, the bad-signature accounting
and the end state's agreement; per node of the counting run the bursts
of 16 frames or more (one device dispatch each at the node's defaults),
the largest burst, the dispatches and the probes.
"""

import argparse
import collections
import glob
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def node_main(argv):
    """A node process of the counting run: the port's command line, with
    the device backend's verifier a CountingVerifier and the counts
    written at exit."""
    from node_mix import CountingVerifier
    from stellar_core_tpu_torch.crypto import keys
    from stellar_core_tpu_torch.herder.herder import Herder
    from stellar_core_tpu_torch.main.application import Application
    from stellar_core_tpu_torch.main.command_line import main

    made, bursts, probes = [], [], [0, 0]
    Application._make_batch_verifier = lambda app: made.append(
        CountingVerifier(keys, app.config.VERIFY_DEVICE_MIN_BATCH,
                         app.metrics)) or made[-1]
    recv = Herder.recv_transactions

    def received(self, frames, *args, **kwargs):
        bursts.append(len(frames))
        return recv(self, frames, *args, **kwargs)
    Herder.recv_transactions = received
    probe = keys.probe_verify_cache

    def counted(*t):
        hit = probe(*t)
        probes[hit is None] += 1
        return hit
    keys.probe_verify_cache = counted
    try:
        return main(argv)
    finally:
        if "run" in argv:
            conf = argv[argv.index("--conf") + 1]
            out = os.path.join(os.path.dirname(conf),
                               f"mix-{os.getpid()}.json")
            with open(out, "w") as f:
                json.dump({"bursts": bursts, "probes": probes,
                           "dispatches": [d for v in made
                                          for d in v.dispatches]}, f)


def counting_cluster():
    from stellar_core_tpu_torch.simulation.cluster import Cluster

    class CountingCluster(Cluster):
        def _cli(self, node, *args):
            return [sys.executable, os.path.abspath(__file__), "--node",
                    "--conf", node.cfg_path, "--ll", self.log_level, *args]
    return CountingCluster


def summary(rec):
    """A run's numbers, without the metrics and perf documents."""
    out = {k: rec[k] for k in ("boot_s", "create_s", "flood_s", "churn_s",
                               "wall_s", "submitted", "agree", "dropped_on",
                               "bad_sig", "caught_up", "lcl_at_kill",
                               "network_lcl_at_restart", "lcl", "rcs")}
    out["rounds"] = rec["rounds"]
    out["injected"] = {k: v.get("injected", {}) for k, v in
                       rec["chaos"].items()}
    out["close"] = rec["close"]
    out["dispatch_batch"] = {
        n: m.get("crypto.verify.dispatch.batch") for n, m in
        rec["metrics"].items()}
    out["fallbacks"] = {n: m.get("crypto.verify_service.fallback", {})
                        .get("count", 0) for n, m in rec["metrics"].items()}
    states = [json.dumps(sorted(s[0].items())) for s in
              rec["ledger"].values()]
    out["nodes_agree_on_accounts"] = len(set(states)) == 1
    out["applied"] = {n: s[1] for n, s in rec["ledger"].items()}
    out["forged_applied"] = {n: s[2] for n, s in rec["ledger"].items()}
    return out


def differing_fields(a, b):
    """Which fields of node 0's accounts differ between two runs:
    (label, field) pairs, balance and the seqNum's high and low 32 bits
    (the ledger an account was created in, and its transactions)."""
    acc_a = next(iter(a["ledger"].values()))[0]
    acc_b = next(iter(b["ledger"].values()))[0]
    out = collections.Counter()
    for label in sorted(set(acc_a) | set(acc_b)):
        if label not in acc_a or label not in acc_b:
            out["presence"] += 1
            continue
        (bal_a, seq_a), (bal_b, seq_b) = acc_a[label], acc_b[label]
        out["balance"] += bal_a != bal_b
        out["seq_ledger"] += seq_a >> 32 != seq_b >> 32
        out["seq_count"] += seq_a & 0xFFFFFFFF != seq_b & 0xFFFFFFFF
    return dict(out)


def node_counts(rec):
    out = {}
    for node in rec["nodes"]:
        files = sorted(glob.glob(os.path.join(rec["root"], node,
                                              "mix-*.json")))
        lives = [json.load(open(f)) for f in files]
        bursts = [b for life in lives for b in life["bursts"]]
        device = [s for life in lives for s, mode in life["dispatches"]
                  if mode != "bypass"]
        out[node] = {
            "lives_recorded": len(lives),
            "bursts": len(bursts),
            "bursts_ge16": sum(b >= 16 for b in bursts),
            "largest_burst": max(bursts, default=0),
            "device_dispatches": len(device),
            "largest_dispatch": max(device, default=0),
            "device_modes": dict(collections.Counter(
                mode for life in lives for _, mode in life["dispatches"])),
            "probes": {"hits": sum(life["probes"][0] for life in lives),
                       "misses": sum(life["probes"][1] for life in lives)},
            "burst_sizes": bursts}
    return out


def main():
    if sys.argv[1:2] == ["--node"]:
        return node_main(sys.argv[2:])
    ap = argparse.ArgumentParser()
    ap.add_argument("--accounts", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import chip_smoke as cs
    n = args.accounts or cs.NODE_LOAD
    rounds = args.rounds or cs.CLUSTER_ROUNDS
    work = tempfile.mkdtemp(prefix="cluster-mix-")
    runs = {}
    for tag, backend, cls in (("B1", "native", None),
                              ("B2", "native", None),
                              ("A", "cuda", counting_cluster())):
        root = os.path.join(work, tag)
        os.makedirs(root)
        rec = cs.cluster_run(backend, root, accounts=n, txs=n,
                             rounds=rounds, cluster_cls=cls)
        rec["root"] = root
        runs[tag] = rec
    doc = {"accounts": n, "rounds": rounds,
           "runs": {k: summary(v) for k, v in runs.items()},
           "fields_differing": {
               "B1_B2": differing_fields(runs["B1"], runs["B2"]),
               "A_B1": differing_fields(runs["A"], runs["B1"])},
           "nodes": node_counts(runs["A"])}
    text = json.dumps(doc)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
