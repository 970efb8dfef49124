"""Kernel variant sweep on the card: the verify kernels compiled with
other launch geometries, held against their plain versions and timed.

    python -m stellar_core_tpu_torch.scripts.kernel_sweep \\
        [BATCH ...] [--variant NAME=VALUE[,NAME=VALUE ...]] [--rounds 2]

The counterpart of the JAX package's scripts/kernel_sweep.py, which
sweeps its kernel's one knob (SCAN_UNROLL). The port's knobs are the
compile-time constants of csrc/ed25519.cu (ops/_build.py KNOBS:
kPrepThreads, kPrepMinBlocks, kLadderThreads, kLadderMinBlocks); a variant
is the library built with some of them set (`_build.lib(defines)`),
loaded beside the default one in this process. Batch sizes default to
16384 200 1000 64000. Without --variant it sweeps DEFAULT_SETS: today's,
kLadderThreads=64, kLadderMinBlocks=3 (about 168 registers per ladder
thread, against 128) and kPrepMinBlocks=4; with --variant, today's and
the sets given. (kLadderThreads=256 is left out: the ladder's static
shared memory, 46,528 B per block of 128, would pass the 48 KB static
limit.)

For each set it reports nvcc's seconds, ptxas's register and spill
lines and kernel_info; for each (batch, set) the byte check of prep
(msg32 mode) and of the ladder in the main path's verdict form (with its
x and y stores on for the check) against prep_plain and
ladder_verdict_plain on rows that hold the differential corpus and
random bytes, and each kernel's
`loop_ms` and `median_ms` (scripts/_kernel_timing.py), taken in turns:
round r visits the sets in order, round r + 1 in reverse. A set that
fails to build is listed under `not_built` with the compiler's error.
Prints one JSON object, then the card's name and power limit as the
last line. Exits non-zero without a card, on any byte off the plain
versions, or when a default set fails to build.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import _kernel_timing as KT

BATCHES = (16384, 200, 1000, 64000)
DEFAULT_SETS = ({}, {"kLadderThreads": 64}, {"kLadderMinBlocks": 3},
                {"kPrepMinBlocks": 4})


def parse_set(text: str) -> dict:
    """"kLadderThreads=64,kPrepMinBlocks=4" -> {name: int}."""
    out = {}
    for item in filter(None, text.split(",")):
        name, _, value = item.partition("=")
        out[name.strip()] = int(value)
    return out


def label(knobs: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in sorted(knobs.items())) or "today"


def run(batches=BATCHES, sets=DEFAULT_SETS, rounds: int = 2) -> dict:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_sweep: no CUDA device")
    from ..ops import _build
    from ..ops import ed25519_kernel as EK
    from ..ops import ladder as LD
    from ..ops import testvectors

    dev = torch.device("cuda", 0)
    built, not_built = [], []
    for knobs in sets:
        defines = _build.defines_of(knobs)
        try:
            lib = _build.lib(defines)
        except RuntimeError as e:   # nvcc's error, kept whole
            not_built.append({"set": label(knobs), "error": str(e)})
            continue
        report = _build.variant_info[defines] if defines else _build.info
        built.append({
            "set": label(knobs), "defines": list(defines), "lib": lib,
            "nvcc_s": report["seconds"],
            "ptxas": [line.strip() for line in report["ptxas"].splitlines()
                      if "registers" in line or "spill" in line],
            "info": {name: _build.kernel_info(name, defines)
                     for name in _build.KERNELS},
            "checks": {}, "times": {}})

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    for n in batches:
        pubs, sigs, _, m32 = KT.rows(n, testvectors)
        a, r, s, m = (on(pubs), on(sigs[:, :32]), on(sigs[:, 32:]),
                      on(m32))
        want_prep = EK.prep_plain(a, r, s, m, EK.MODE_MSG32)
        k, neg_a, ok = want_prep
        want_ladder = LD.ladder_verdict_plain(s, k, neg_a[:, :32],
                                              neg_a[:, 32:], r, ok)
        for v in built:
            got_prep = EK.launch_prep(v["lib"], a, r, s, m, EK.MODE_MSG32)
            got_ladder = LD.launch_ladder(v["lib"], s, k, neg_a, r, ok,
                                          xy=True)
            torch.cuda.synchronize()
            v["checks"][n] = {
                "prep": all(torch.equal(g, w)
                            for g, w in zip(got_prep, want_prep)),
                "ladder": all(torch.equal(g, w)
                              for g, w in zip(got_ladder, want_ladder))}
            v["times"][n] = {kern: {"loop_ms": [], "median_ms": []}
                             for kern in ("prep", "ladder")}
        for rnd in range(rounds):
            for v in (built if rnd % 2 == 0 else built[::-1]):
                lib = v["lib"]
                for kern, fn in (
                        ("prep", lambda: EK.launch_prep(lib, a, r, s, m,
                                                        EK.MODE_MSG32)),
                        ("ladder", lambda: LD.launch_ladder(lib, s, k, neg_a,
                                                            r, ok))):
                    v["times"][n][kern]["loop_ms"].append(KT.loop_ms(fn))
                    v["times"][n][kern]["median_ms"].append(
                        KT.median_ms(fn))
    for v in built:
        del v["lib"]
    return {"card": KT.card_line(), "device": torch.cuda.get_device_name(0),
            "batches": list(batches), "rounds": rounds, "built": built,
            "not_built": not_built}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="*", default=list(BATCHES))
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE[,NAME=VALUE ...] (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    sets = ([{}] + [parse_set(v) for v in args.variant] if args.variant
            else list(DEFAULT_SETS))
    out = run(args.batch, sets, args.rounds)
    print(json.dumps(out))
    print(out["card"])
    off = [(v["set"], n) for v in out["built"]
           for n, c in v["checks"].items() if not all(c.values())]
    defaults = {label(s) for s in DEFAULT_SETS} if not args.variant else \
        {"today"}
    failed = [x["set"] for x in out["not_built"] if x["set"] in defaults]
    if off or failed:
        print(f"kernel_sweep: off the plain versions {off}; default sets "
              f"not built {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
