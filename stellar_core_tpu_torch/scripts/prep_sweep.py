"""Time the prep kernel (ed25519_prep), or a whole dispatch, of one or
more checkouts of the port on one card, in turns, on the same rows.

Usage:
  python -m stellar_core_tpu_torch.scripts.prep_sweep \\
      [--tree LABEL=DIR ...] [--n 16384,200,64000,178,1000,1831] \\
      [--rounds 2] [--stage prep|dispatch]

Each tree (by default this checkout, labelled "this") runs in a process
of its own with DIR first on sys.path, so it builds and loads its own
ops/csrc. Round r visits the trees in order, round r + 1 in reverse, so
two trees run A B B A. Before it times, every process holds prep's K,
NEGA and OK byte for byte against prep_plain on the card at every n in
both modes, on rows that hold the differential corpus (valid, corrupted,
non-canonical and small-order tuples) and random bytes. It takes two
times: `median_ms`, the one chip_smoke.py takes, the median of 25
launches through the wrapper (CUDA events around each call, after 3
warm-ups), which includes the wrapper's host work; and `loop_ms`, the
device time per launch of 50 back-to-back launches between two events,
where the host's work overlaps the kernels queued before it. Each
process prints one JSON line (the card, the kernel's launch geometry and
resources, its ptxas lines, its static SASS counts and its squaring
loop's, the times); the last line is a JSON summary by mode and n with
the card's name and power limit. Exits non-zero without a card or on
any byte off the plain version.

With --stage dispatch it times the device entries instead, by the same
two times: verify_kernel_msg32 (modes "msg32") and verify_kernel_full
with the tree's host_k (modes "k"), on kernel_profile.profile_rows (the
tree's; every 16th message corrupted), each verdict held against the
native batch_verify first; and it reports the ladder's ptxas lines and
its static SASS counts, whose windows loop's digest shows whether two
trees compiled the same windows.
"""

import argparse
import json
import os
import subprocess
import sys

if __package__:
    from ._kernel_timing import loop_ms, median_ms, rows, sass_counts
else:   # run as a file (--worker): the helpers beside it, so that the
    # package is imported only from the tree the worker times
    from _kernel_timing import loop_ms, median_ms, rows, sass_counts

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODES = ("msg32", "k")


def _tree(tree, label):
    """Put the checkout first on sys.path and check that its package is
    the one imported, on a machine with a card."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("prep_sweep: no CUDA device")
    from stellar_core_tpu_torch.ops import ed25519_kernel as EK
    if not EK.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"prep_sweep: {label} loaded {EK.__file__}")


def dispatch_worker(tree, label, ns):
    """--stage dispatch: the two device entries of one tree."""
    _tree(tree, label)
    import numpy as np
    import torch
    from stellar_core_tpu_torch.ops import _build
    from stellar_core_tpu_torch.ops import ed25519_kernel as EK
    from stellar_core_tpu_torch.ops.verifier import host_k
    from stellar_core_tpu_torch.native.loader import get_lib
    from stellar_core_tpu_torch.scripts.kernel_profile import profile_rows
    dev = torch.device("cuda", 0)
    _build.lib()
    ptxas = [line.strip() for line in _build.info["ptxas"].splitlines()
             if "registers" in line or "spill" in line]
    out = dict(label=label, tree=os.path.abspath(tree),
               card=torch.cuda.get_device_name(0),
               info=_build.kernel_info("ed25519_ladder"), ptxas=ptxas,
               sass=sass_counts(_build.info["path"], _build._nvcc(),
                                "ed25519_ladder_kernel"),
               times={m: {} for m in MODES}, loop={m: {} for m in MODES})

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    for n in ns:
        pubs, sigs, msgs = profile_rows(n)
        msgs = [bytes([m[0] ^ 1]) + m[1:] if i % 16 == 5 else m
                for i, m in enumerate(msgs)]
        want = get_lib().batch_verify(
            pubs, sigs, b"".join(msgs),
            np.arange(n + 1, dtype=np.uint64) * 32)
        a, r, s = on(pubs), on(sigs[:, :32]), on(sigs[:, 32:])
        m = on(np.frombuffer(b"".join(msgs), np.uint8).reshape(n, 32))
        k = on(host_k(pubs, sigs, msgs))
        for mode, fn in (
                ("msg32", lambda: EK.verify_kernel_msg32(a, r, s, m)),
                ("k", lambda: EK.verify_kernel_full(a, r, s, k))):
            if not (fn().cpu().numpy() == want).all():
                raise SystemExit(f"prep_sweep: {label} {mode} verdicts "
                                 f"differ from the native ones at n={n}")
            out["times"][mode][n] = median_ms(fn)
            out["loop"][mode][n] = loop_ms(fn)
    print(json.dumps(out), flush=True)


def worker(tree, label, ns):
    _tree(tree, label)
    import numpy as np
    import torch
    from stellar_core_tpu_torch.ops import _build
    from stellar_core_tpu_torch.ops import ed25519_kernel as EK
    from stellar_core_tpu_torch.ops import testvectors
    from stellar_core_tpu_torch.ops.verifier import host_k
    dev = torch.device("cuda", 0)
    _build.lib()
    ptxas = [line.strip() for line in _build.info["ptxas"].splitlines()
             if "prep" in line or "registers" in line or "spill" in line]
    out = dict(label=label, tree=os.path.abspath(tree),
               card=torch.cuda.get_device_name(0),
               info=_build.kernel_info("ed25519_prep"), ptxas=ptxas,
               sass=sass_counts(_build.info["path"], _build._nvcc()),
               times={m: {} for m in MODES}, loop={m: {} for m in MODES})

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    for n in ns:
        pubs, sigs, msgs, m32 = rows(n, testvectors)
        a, r, s = on(pubs), on(sigs[:, :32]), on(sigs[:, 32:])
        for mode, mk in ((EK.MODE_MSG32, on(m32)),
                         (EK.MODE_K, on(host_k(pubs, sigs, msgs)))):
            got = EK.prep(a, r, s, mk, mode)
            want = EK.prep_plain(a, r, s, mk, mode)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"prep_sweep: {label} prep[{MODES[mode]}] "
                                 f"differs from prep_plain at n={n}")
            out["times"][MODES[mode]][n] = median_ms(
                lambda: EK.prep(a, r, s, mk, mode))
            out["loop"][MODES[mode]][n] = loop_ms(
                lambda: EK.prep(a, r, s, mk, mode))
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=DIR, a checkout of the port (repeatable)")
    ap.add_argument("--n", default="16384,200,64000,178,1000,1831")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--stage", choices=("prep", "dispatch"), default="prep")
    ap.add_argument("--worker", nargs=2, metavar=("DIR", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    ns = [int(x) for x in args.n.split(",")]
    if args.worker:
        fn = worker if args.stage == "prep" else dispatch_worker
        return fn(args.worker[0], args.worker[1], ns)
    trees = [t.split("=", 1) for t in args.tree] or [["this", REPO]]
    runs = []
    for rnd in range(args.rounds):
        for label, tree in (trees if rnd % 2 == 0 else trees[::-1]):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", tree,
                 label, "--n", args.n, "--stage", args.stage],
                capture_output=True, text=True)
            sys.stderr.write(res.stderr)
            if res.returncode:
                raise SystemExit(f"prep_sweep: {label} failed "
                                 f"({res.returncode})")
            print(res.stdout.strip(), flush=True)
            runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    summary = {key: {m: {n: {label: [r[key][m][str(n)] for r in runs
                                     if r["label"] == label]
                             for label, _ in trees} for n in ns}
                     for m in MODES} for key in ("times", "loop")}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(card=card, median_ms=summary["times"],
                          loop_ms=summary["loop"])))


if __name__ == "__main__":
    sys.exit(main())
