"""Chaos convergence soak: many seeded scenario rounds, one verdict.

Runs the canonical multinode chaos scenario (simulation/chaos.py) over a
range of seeds — every round must hold liveness, safety (surviving
nodes byte-identical to the fault-free run) and reproducibility (same
seed → same faults → same hashes). Aggregates into one JSON document.

Usage:
    python -m stellar_core_tpu_torch.scripts.chaos_soak [N_ROUNDS] \
        [--base-seed S] [--out PATH]

Exit status is nonzero if any round fails an invariant — wire it into
longer-running CI alongside `pytest -m soak`.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("rounds", nargs="?", type=int, default=3)
    ap.add_argument("--base-seed", type=int, default=1000)
    ap.add_argument("--target", type=int, default=10)
    ap.add_argument("--byzantine", action="store_true",
                    help="soak the adversarial scenario family "
                         "(simulation/byzantine.py: equivocation + "
                         "bad-sig flood + churn) instead of the "
                         "honest-but-faulty one")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from stellar_core_tpu_torch.simulation.chaos import (
        run_scenario, run_sick_device_window)
    from stellar_core_tpu_torch.util.chaos import SimulatedCrash

    def sick_device_leg(seed: int) -> dict:
        """A device-index-matched fault window must
        trip exactly one chip of the mesh (siblings uninterrupted, zero
        dispatches to the OPEN device, canary-probe regrow) — run twice
        to assert the schedule AND the per-device transition log
        reproduce (timestamps excluded: the bare supervisor harness
        rides time.monotonic, the determinism subject is the fault/
        transition SEQUENCE)."""
        one = run_sick_device_window(seed=seed)
        two = run_sick_device_window(seed=seed)

        def shape(r):
            return (r["injected"], r["log"],
                    [{k: t[k] for k in t if k != "t"}
                     for t in r["transitions"]])

        return {"ok": one["ok"], "repro_ok": shape(one) == shape(two),
                **{k: one[k] for k in (
                    "exact", "tripped", "siblings_closed",
                    "quiet_while_open", "siblings_served", "shrunk",
                    "regrown", "aggregate_stayed_closed", "injected")}}

    def one_round(seed: int, root: str) -> dict:
        if args.byzantine:
            from stellar_core_tpu_torch.simulation.byzantine import (
                run_smoke, run_tiered_chaos)
            smoke = run_smoke(seed=seed, target_slots=args.target)
            repro = run_smoke(seed=seed, target_slots=args.target)
            churn = run_tiered_chaos(
                seed=seed, n_orgs=3, validators_per_org=3, watchers=0,
                target_slots=max(4, args.target // 2),
                data_dir=os.path.join(root, "data"),
                churn_down_slots=1)
            injected = dict(smoke["injected"])
            for k, v in churn["injected"].items():
                injected[k] = injected.get(k, 0) + v
            return {"seed": seed, "smoke": smoke, "churn": churn,
                    "liveness_ok": smoke["liveness_ok"] and
                    churn["liveness_ok"],
                    "safety_ok": smoke["safety_ok"] and
                    churn["safety_ok"],
                    # same seed → same injected faults (virtual-time
                    # sim; the schedule must reproduce)
                    "repro_ok": repro["injected"] == smoke["injected"],
                    "injected": injected}
        res = run_scenario(seed=seed, target=args.target,
                           archive_dir=os.path.join(root, "archive"))
        # sick-device window: rides every honest-but-faulty
        # round beside the multinode scenario; its verdict gates the
        # round like the scenario invariants do
        sick = sick_device_leg(seed)
        res["sick_device"] = sick
        res["sick_device_ok"] = bool(sick["ok"] and sick["repro_ok"])
        return res

    rounds = []
    ok = True
    t0 = time.perf_counter()
    for i in range(args.rounds):
        seed = args.base_seed + i
        root = tempfile.mkdtemp(prefix="chaos-soak-")
        try:
            res = one_round(seed, root)
        except (Exception, SimulatedCrash) as e:  # a crash IS a
            res = {"seed": seed, "error": repr(e),  # failed round
                   "liveness_ok": False, "safety_ok": False,
                   "repro_ok": False, "archive_ok": False}
        finally:
            shutil.rmtree(root, ignore_errors=True)
        round_ok = res.get("liveness_ok") and res.get("safety_ok") \
            and res.get("repro_ok") and res.get("archive_ok", True) \
            and res.get("sick_device_ok", True)
        ok = ok and bool(round_ok)
        rounds.append(res)
        print("round %d seed=%d %s %s" % (
            i, seed, "PASS" if round_ok else "FAIL",
            res.get("injected", res.get("error"))),
            file=sys.stderr, flush=True)

    doc = {
        "metric": "byzantine_soak" if args.byzantine else "chaos_soak",
        "rounds": len(rounds),
        "passed": sum(1 for r in rounds
                      if r.get("liveness_ok") and r.get("safety_ok")
                      and r.get("repro_ok")
                      and r.get("archive_ok", True)
                      and r.get("sick_device_ok", True)),
        "wall_seconds": round(time.perf_counter() - t0, 1),
        "results": rounds,
    }
    out = json.dumps(doc, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
