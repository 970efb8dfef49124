"""The data-parallel scaling curve of the sharded verifier, and a
projection to many cards from this run's own rates.

    python -m stellar_core_tpu_torch.scripts.scaling_curve \\
        [--batch B] [--reps 10] [--device cuda|cpu] [--out PATH]

The counterpart of the JAX package's scripts/scaling_curve.py. It
measures ShardedBatchVerifier over N in {1, 2, 4, 8} positions, each
position a card while cards remain, then the cards again in turn (on a
one-card machine, N positions of cuda:0, whose shards share its stream
and run one after another). For each N: t_1(B/N), one position on the
first B/N rows; t_N(B), N positions on all B; and the sharding
efficiency N * t_1(B/N) / t_N(B), which is 1 when sharding costs
nothing beyond running the shards one after another (one card) and
measures the speed-up over N cards where each position is a card of its
own. Each time is the best of --reps calls after one warm-up, from bytes
to verdicts. The rows are the reference's: 16 keys, message i =
sha256(b"scale-msg-%d"), every 97th signature corrupted; every call's
verdicts must equal the native verifier's, which must equal the
oracle's on the corrupted rows and every 64th.

The projection takes this run's rates, never a stored artifact:
CudaBatchVerifier's verifies per second at B on the first position's
device, and the native batch_verify's on one host thread over the same
rows (best of 3), then rate x 8 x efficiency(8) and the cards needed for
ten times the native rate. B defaults to 16384 on the card and 256 with
--device cpu (the plain versions, about 3 s a shard). Prints one JSON
object, then the card's name and power limit (with --device cpu, the
word cpu) as the last line. --out also writes the JSON to a file; a path
in the repository root matching *_r*.json is refused, since the
reference's artifact globs read those.
"""

from __future__ import annotations

import argparse
import fnmatch
import hashlib
import json
import math
import os
import sys
import time

from . import _kernel_timing as KT

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NS = (1, 2, 4, 8)
REPS = 10
NATIVE_REPS = 3
BAD_STRIDE = 97          # every 97th signature corrupted
ORACLE_STRIDE = 64


def refuse_out(path: str) -> None:
    """Raise for a path the reference's artifact globs would read: a
    *_r*.json directly in the repository root."""
    full = os.path.abspath(path)
    if os.path.dirname(full) == REPO and \
            fnmatch.fnmatch(os.path.basename(full), "*_r*.json"):
        raise SystemExit(f"scaling_curve: refusing {path}: the repository "
                         f"root's *_r*.json files are the reference's")


def make_rows(n: int):
    """(pubs, sigs, msgs, bad) as the reference makes them, signed by the
    native library (RFC 8032: the oracle's bytes); `bad` marks the
    corrupted rows."""
    import numpy as np
    from ..native.loader import get_lib
    lib = get_lib()
    keyed = []
    for i in range(16):
        seed = hashlib.sha256(b"scale-key-%d" % i).digest()
        keyed.append((seed, lib.public_from_seed(seed)))
    pubs = np.zeros((n, 32), dtype=np.uint8)
    sigs = np.zeros((n, 64), dtype=np.uint8)
    msgs = []
    for i in range(n):
        seed, pub = keyed[i % len(keyed)]
        msg = hashlib.sha256(b"scale-msg-%d" % i).digest()
        msgs.append(msg)
        pubs[i] = np.frombuffer(pub, dtype=np.uint8)
        sigs[i] = np.frombuffer(lib.sign(seed, pub, msg), dtype=np.uint8)
    bad = np.zeros(n, dtype=bool)
    bad[::BAD_STRIDE] = True
    sigs[bad, 0] ^= 0xFF
    return pubs, sigs, msgs, bad


def positions(cards, n: int) -> list:
    """n positions: the cards in turn."""
    return [cards[i % len(cards)] for i in range(n)]


def fold(t1_of: dict, t_n: dict, batch: int) -> list:
    """Rows of the curve from t_1 by shard size and t_N by N (seconds)."""
    rows = []
    for n in sorted(t_n):
        ideal = n * t1_of[batch // n]
        rows.append({"ndev": n, "batch": batch, "t_ms": t_n[n] * 1e3,
                     "rate": batch / t_n[n],
                     "t1_shard_ms": t1_of[batch // n] * 1e3,
                     "sharding_efficiency": ideal / t_n[n]})
    return rows


def projection(rows: list, card_rate: float, native_rate: float) -> dict:
    """rate x N x efficiency at the curve's largest N, and the cards
    that ten times the native one-thread rate needs at that efficiency."""
    last = rows[-1]
    eff, n = last["sharding_efficiency"], last["ndev"]
    vs_native = card_rate / native_rate
    return {"per_card_rate": card_rate, "native_rate_1_thread": native_rate,
            "vs_native": vs_native, "assumed_efficiency": eff,
            f"projected_rate_{n}": card_rate * n * eff,
            "cards_to_10x_vs_native": math.ceil(10.0 / (vs_native * eff))}


def expected_launches(ns=NS, reps=REPS) -> int:
    """Launches of prep (msg32) and of the ladder alike in one run: one
    per shard of every call (1 warm-up + reps): t_1 on one position per
    N, t_N on N, and CudaBatchVerifier's rate."""
    return (1 + reps) * (len(ns) + sum(ns) + 1)


def host_state() -> dict:
    """Host load beside the times (the JAX package's bench._host_state):
    load averages, cores, and a fixed loop's best of 3 in ms."""
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        s = 0
        for i in range(200_000):
            s += i * i
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return {"loadavg": list(os.getloadavg()), "ncpu": os.cpu_count(),
            "spin_ms": best}


def run(batch=None, device=None, reps: int = REPS, ns=NS) -> dict:
    import numpy as np
    import torch
    from ..native.loader import get_lib
    from ..ops.testvectors import oracle_results
    from ..ops.verifier import (CudaBatchVerifier, ShardedBatchVerifier,
                                resolve_device)
    dev = resolve_device(device)
    if batch is None:
        batch = 16384 if dev.type == "cuda" else 256
    if any(batch % n for n in ns):
        raise ValueError(f"batch {batch} is not a multiple of every N {ns}")
    cards = ([torch.device("cuda", i)
              for i in range(torch.cuda.device_count())]
             if dev.type == "cuda" else [dev])
    host0 = host_state()
    pubs, sigs, msgs, bad = make_rows(batch)

    offsets = np.arange(batch + 1, dtype=np.uint64) * 32
    blob = b"".join(msgs)
    native_s = float("inf")
    for _ in range(NATIVE_REPS):
        t0 = time.perf_counter()
        expect = get_lib().batch_verify(pubs, sigs, blob, offsets)
        native_s = min(native_s, time.perf_counter() - t0)
    held = np.flatnonzero(bad | (np.arange(batch) % ORACLE_STRIDE == 0))
    oracle = oracle_results([(pubs[i].tobytes(), sigs[i].tobytes(), msgs[i])
                             for i in held])
    if not ((expect == ~bad).all() and (expect[held] == oracle).all()):
        raise SystemExit("scaling_curve: the native verdicts are not the "
                         "oracle's")

    def best_s(v, n):
        res = v.verify_batch(pubs[:n], sigs[:n], msgs[:n])     # warm-up
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            res2 = v.verify_batch(pubs[:n], sigs[:n], msgs[:n])
            best = min(best, time.perf_counter() - t0)
            if not (res2 == expect[:n]).all():
                raise SystemExit(f"scaling_curve: verdicts off the oracle "
                                 f"at {n} rows")
        if not (res == expect[:n]).all():
            raise SystemExit(f"scaling_curve: verdicts off the oracle at "
                             f"{n} rows (warm-up)")
        return best

    t1_of, t_n = {}, {}
    for n in ns:
        t1_of[batch // n] = best_s(
            ShardedBatchVerifier(positions(cards, 1)), batch // n)
        print(f"t_1({batch // n}) = {t1_of[batch // n] * 1e3:.3f} ms",
              file=sys.stderr, flush=True)
    for n in ns:
        t_n[n] = best_s(ShardedBatchVerifier(positions(cards, n)), batch)
        print(f"t_{n}({batch}) = {t_n[n] * 1e3:.3f} ms", file=sys.stderr,
              flush=True)
    rows = fold(t1_of, t_n, batch)
    card_rate = batch / best_s(CudaBatchVerifier(device=cards[0]), batch)
    return {"metric": "dp_sharding_scaling", "unit": "sharding_efficiency",
            "value": rows[-1]["sharding_efficiency"], "batch": batch,
            "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                       else "cpu"),
            "cards": len(cards), "reps": reps, "curve": rows,
            "projection": projection(rows, card_rate, batch / native_s),
            "host_load": {"start": host0, "end": host_state()},
            "note": ("positions beyond the cards repeat them: their shards "
                     "share a card's stream, so efficiency there measures "
                     "sharding overhead, not speed-up")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.out:
        refuse_out(args.out)
    out = run(args.batch, args.device, args.reps)
    if out["device"] != "cpu":
        out["card"] = KT.card_line()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
    print(json.dumps(out))
    print(out.get("card", "cpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
