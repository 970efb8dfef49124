"""Time the prep kernel (ed25519_prep) of one or more checkouts of the
port on one card, in turns, on the same rows.

Usage:
  python -m stellar_core_tpu_torch.scripts.prep_sweep \\
      [--tree LABEL=DIR ...] [--n 16384,200,64000,178,1000,1831] \\
      [--rounds 2]

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
"""

import argparse
import collections
import json
import os
import re
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODES = ("msg32", "k")


def median_ms(fn, reps=25, warm=3):
    import torch
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def loop_ms(fn, launches=50, reps=5):
    """Device time per launch: the median over `reps` runs of `launches`
    back-to-back calls between two CUDA events, so the host's work per
    call overlaps the kernels queued before it."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(launches):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / launches)
    return statistics.median(times)


def rows(n, testvectors, seed=16):
    """(pubs, sigs, msgs, m32) of n rows: the corpus's tuples and as many
    random ones, in a seeded order."""
    import numpy as np
    items = testvectors.make_differential_vectors(40)
    rng = np.random.default_rng(seed)
    junk = rng.integers(0, 256, (len(items), 128), dtype=np.uint8)
    pubs = [p for p, _, _ in items] + [j[:32].tobytes() for j in junk]
    sigs = [s for _, s, _ in items] + [j[32:96].tobytes() for j in junk]
    msgs = [m for _, _, m in items] + [j[96:].tobytes() for j in junk]
    order = rng.permutation(len(pubs))[np.arange(n) % len(pubs)]

    def pick(xs):
        return np.frombuffer(b"".join(xs[i] for i in order),
                             np.uint8).reshape(n, -1)
    m32 = rng.integers(0, 256, (len(pubs), 32), dtype=np.uint8)[order]
    return pick(pubs), pick(sigs), [msgs[i] for i in order], m32


def sass_counts(lib_path, nvcc):
    """Static SASS counts of the prep kernel (its listing holds the
    functions it calls): total, IMAD.WIDE and SHFL, and the same for its
    squaring loop, the longest body a backward branch closes (one field
    squaring per pass), with its selects."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], check=True,
                         capture_output=True, text=True).stdout
    ins, fn = [], None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*)", line)
        if m and fn and "prep" in fn:
            ins.append((int(m[1], 16), m[2], m[3]))

    def mix(ops):
        ops = collections.Counter(ops)
        return dict(total=sum(ops.values()),
                    imad_wide=sum(c for o, c in ops.items()
                                  if o.startswith("IMAD.WIDE")),
                    shfl=sum(c for o, c in ops.items()
                             if o.startswith("SHFL")),
                    sel=ops["SEL"])
    at = {addr: i for i, (addr, _, _) in enumerate(ins)}
    loops = []
    for i, (addr, op, rest) in enumerate(ins):
        m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if m and int(m[1], 16) < addr and int(m[1], 16) in at:
            loops.append(ins[at[int(m[1], 16)]:i + 1])
    counts = mix(op for _, op, _ in ins)
    if loops:
        counts["loop"] = mix(op for _, op, _ in max(loops, key=len))
    return counts


def worker(tree, label, ns):
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("prep_sweep: no CUDA device")
    from stellar_core_tpu_torch.ops import _build
    from stellar_core_tpu_torch.ops import ed25519_kernel as EK
    from stellar_core_tpu_torch.ops import testvectors
    from stellar_core_tpu_torch.ops.verifier import host_k
    if not EK.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"prep_sweep: {label} loaded {EK.__file__}")
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
    ap.add_argument("--worker", nargs=2, metavar=("DIR", "LABEL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    ns = [int(x) for x in args.n.split(",")]
    if args.worker:
        return worker(args.worker[0], args.worker[1], ns)
    trees = [t.split("=", 1) for t in args.tree] or [["this", REPO]]
    runs = []
    for rnd in range(args.rounds):
        for label, tree in (trees if rnd % 2 == 0 else trees[::-1]):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker", tree,
                 label, "--n", args.n], capture_output=True, text=True)
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
