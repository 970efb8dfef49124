"""Card Ed25519 differential job: run the valid, corrupted,
non-canonical and small-order vector suite on the card, and cross-check
the card's verdicts against the plain PyTorch versions of the kernels on
the CPU and against the pure-Python oracle on 10k+ random and
adversarial signatures.

Usage:
  python -m stellar_core_tpu_torch.scripts.cuda_differential run \\
      --out FILE [--n 10000] [--device cuda|cpu]
      # verify the vectors through CudaBatchVerifier on the device named
      # (the card by default); writes the results as an .npz and prints
      # one JSON line with the mismatches and the kernels' launches
  python -m stellar_core_tpu_torch.scripts.cuda_differential orchestrate \\
      [--n 10000]
      # run the card and the CPU in separate processes, then assert
      # card == CPU == oracle
  python -m stellar_core_tpu_torch.scripts.cuda_differential fast \\
      [--n 200]
      # the card against the oracle only, at a small n plus the whole
      # adversarial tail

The CUDA kernels and their plain versions are separate code, so this job
is the proof that they agree on every rejection class, on this card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)
MODULE = "stellar_core_tpu_torch.scripts.cuda_differential"


def _run(out_path: str, n: int, device: str) -> None:
    import numpy as np

    from stellar_core_tpu_torch.ops import ed25519_kernel as EK
    from stellar_core_tpu_torch.ops import ladder as LD
    from stellar_core_tpu_torch.ops.testvectors import (
        make_differential_vectors, oracle_results)
    from stellar_core_tpu_torch.ops.verifier import CudaBatchVerifier

    items = make_differential_vectors(n)
    v = CudaBatchVerifier(device=device)
    t0 = time.perf_counter()
    got = v.verify_tuples(items)
    dt = time.perf_counter() - t0
    want = oracle_results(items)
    mism = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    np.savez(out_path,
             results=np.asarray(got, dtype=np.uint8),
             oracle=np.asarray(want, dtype=np.uint8))
    print(json.dumps({"device": str(v.device), "n": len(items),
                      "mismatches_vs_oracle": len(mism),
                      "first_mismatches": mism[:10],
                      "secs": round(dt, 2),
                      "launches": {"msg32": EK.prep.mode_launches[0],
                                   "k": EK.prep.mode_launches[1],
                                   "ladder": LD.ladder.launches}}),
          flush=True)
    if mism:
        sys.exit(1)


def _orchestrate(n: int) -> None:
    import tempfile
    import numpy as np

    tmp = tempfile.mkdtemp(prefix="cuda-diff-")
    outs = {name: os.path.join(tmp, f"{name}.npz")
            for name in ("cuda", "cpu")}
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO

    # both runs at once: each spends most of its time in the oracle, on
    # one host core
    procs = {}
    for name, out in outs.items():
        print(f"[{name}] running differential suite ...", flush=True)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", MODULE, "run", "--out", out,
             "--n", str(n), "--device", name], env=env, cwd=REPO)
    try:
        failed = [name for name, p in procs.items()
                  if p.wait(timeout=3600) != 0]
    finally:
        for p in procs.values():
            p.kill()
    if failed:
        print(f"{failed} FAILED against the oracle")
        sys.exit(1)

    card = np.load(outs["cuda"])["results"]
    cpu = np.load(outs["cpu"])["results"]
    if card.shape != cpu.shape or not (card == cpu).all():
        bad = int((card != cpu).sum())
        print(f"CROSS-CHECK FAILED: card and CPU disagree on "
              f"{bad} signatures")
        sys.exit(1)
    print(f"CUDA DIFFERENTIAL: PASS ({len(card)} signatures; "
          "card == CPU == oracle)")


def _fast(n: int) -> None:
    """Fast card tier: the full strict-check corpus (non-canonical
    A/R/S, small order, torsion defects, mixed valid/invalid; the
    adversarial tail is appended whole whatever n is) at a small n, the
    card against the oracle only. The card == CPU cross-check stays in
    the full `orchestrate` tier."""
    import tempfile

    out = os.path.join(tempfile.mkdtemp(prefix="cuda-diff-fast-"),
                       "cuda.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", MODULE, "run", "--out", out,
         "--n", str(n), "--device", "cuda"],
        env=env, cwd=REPO, timeout=600)
    if r.returncode != 0:
        print("FAST DIFFERENTIAL: FAIL (card vs oracle)")
        sys.exit(1)
    print(f"FAST DIFFERENTIAL: PASS in {time.perf_counter() - t0:.0f}s")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["run", "orchestrate", "fast"])
    ap.add_argument("--out", default="cuda-diff.npz")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where `run` verifies: the card (its kernels) or "
                         "the CPU (their plain versions)")
    args = ap.parse_args()
    if args.mode == "run":
        _run(args.out, args.n if args.n is not None else 10000,
             args.device)
    elif args.mode == "fast":
        _fast(args.n if args.n is not None else 200)
    else:
        _orchestrate(args.n if args.n is not None else 10000)


if __name__ == "__main__":
    main()
