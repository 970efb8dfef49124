"""Stage-sliced profile of the verify kernels on the card: where a
dispatch's device time goes, and each kernel's distance to its bound.

    python -m stellar_core_tpu_torch.scripts.kernel_profile \\
        [--batch 16384] [--n 200,1000,1831]

The counterpart of the JAX package's scripts/kernel_profile.py, on the
port's kernels. At `batch` signatures it builds the reference's rows (16
keys from sha256(b"kp-%d"), messages sha256(b"profile-%d"), all valid)
and first holds every stage's output on the card against its plain
version, byte for byte: prep in msg32 and k mode against prep_plain, the
ladder in the main path's verdict form (-A read in place from prep's
(n,64) output, R and prep's flags compared in its epilogue; with its x
and y stores on, for the check) against ladder_verdict_plain's verdicts,
x and y, and the ladder's windows alone (the WINDOWS_ONLY variant
library, built here, on -A's two halves) against ladder_windows_plain;
the verdicts of the ladder, verify_kernel_msg32, verify_kernel_full and
CudaBatchVerifier.verify_batch against the oracle (every 64th row) and
the native batch_verify (every row). At each n of --n the ladder and its
windows are held against the plain versions' first n rows, and
verify_kernel_msg32's verdicts against the native ones.

Then it times each stage by device time per launch (`loop_ms`) and by
the median of single calls through the wrapper (`median_ms`): prep in
both modes, the ladder (verdict form), its windows, both verify_kernel
entries, and verify_batch from bytes to verdicts (host clock); the
host's prep (host_k, and the native host_prepare), best of 3. At each n
the ladder, its windows and verify_kernel_msg32. From these: each
stage's share of a dispatch, and the epilogue's share of the ladder,
(ladder - windows) / ladder, at `batch` and at each n: Z^-1, the
encoding and the compare with R. In place of XLA's
cost analysis, for each kernel: products per signature (the bound's
count), bytes moved, the integer-multiply bound at this card's SMs x 64
x max SM clock, kernel_info and static SASS counts. In place of
jax.profiler, one torch.profiler trace of a verify_batch call (after a
warm-up call under the profiler), written to a temporary directory whose
path it prints, with device time by kernel, the idle share and any
device event other than the two kernels and the copies.

Prints one JSON object, then the card's name and power limit as the
last line. Exits non-zero without a card or on any byte or verdict off.
Its launches are fixed by its stages (`expected_launches`), and it
checks the kernel wrappers' counts against them.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
import time

from . import _kernel_timing as KT

BATCH = 16384
NODE_NS = (200, 1000, 1831)   # the node's flushes (PERF.md section 6)
ORACLE_STRIDE = 64            # rows held against the oracle: every 64th
HOST_REPS = 3
TRACE_CALLS = 2               # a warm-up call under the profiler, then the trace
# each input read once, each output written once
# (the ladder's verdict form: S, k, -A, R and ok in, the verdict out)
BYTES_PER_SIG = {"prep": 128 + 32 + 64 + 1, "ladder": 4 * 32 + 32 + 1 + 1,
                 "windows": 4 * 32 + 3 * 32}
# launches per call of each timed stage: prep msg32, prep k, ladder,
# ladder windows
STAGES = {"prep_msg32": (1, 0, 0, 0), "prep_k": (0, 1, 0, 0),
          "ladder": (0, 0, 1, 0), "windows": (0, 0, 0, 1),
          "verify_kernel_msg32": (1, 0, 1, 0),
          "verify_kernel_full": (0, 1, 1, 0), "verify_batch": (1, 0, 1, 0)}
BY_N = ("ladder", "windows", "verify_kernel_msg32")   # stages timed at each n
KERNEL_COUNTS = ("prep_msg32", "prep_k", "ladder", "ladder_windows")


def expected_launches(ns=NODE_NS) -> dict:
    """Kernel launches of one run: one check call of every stage, then
    MEDIAN_CALLS + LOOP_CALLS timed calls of each stage but verify_batch
    (MEDIAN_CALLS on the host clock, then TRACE_CALLS under the
    profiler); at each n
    one check and the timed calls of each stage of BY_N."""
    calls = {st: 1 + KT.MEDIAN_CALLS + KT.LOOP_CALLS for st in STAGES}
    calls["verify_batch"] = 1 + KT.MEDIAN_CALLS + TRACE_CALLS
    for st in BY_N:
        calls[st] += len(ns) * (1 + KT.MEDIAN_CALLS + KT.LOOP_CALLS)
    return {name: sum(calls[st] * STAGES[st][i] for st in STAGES)
            for i, name in enumerate(KERNEL_COUNTS)}


def launch_counts() -> dict:
    """The kernel wrappers' launch counters, under expected_launches'
    names."""
    from ..ops import ed25519_kernel as EK
    from ..ops import ladder as LD
    return {"prep_msg32": EK.prep.mode_launches[EK.MODE_MSG32],
            "prep_k": EK.prep.mode_launches[EK.MODE_K],
            "ladder": LD.ladder.launches,
            "ladder_windows": LD.ladder_windows.launches}


def profile_rows(batch: int):
    """The reference's rows: 16 keys, message i = sha256(b"profile-%d"),
    signed by the native library (RFC 8032: the oracle's bytes)."""
    import numpy as np
    from ..native.loader import get_lib
    lib = get_lib()
    keyed = []
    for i in range(16):
        seed = hashlib.sha256(b"kp-%d" % i).digest()
        keyed.append((seed, lib.public_from_seed(seed)))
    pubs = np.zeros((batch, 32), np.uint8)
    sigs = np.zeros((batch, 64), np.uint8)
    msgs = []
    for i in range(batch):
        seed, pub = keyed[i % len(keyed)]
        m = hashlib.sha256(b"profile-%d" % i).digest()
        msgs.append(m)
        pubs[i] = np.frombuffer(pub, np.uint8)
        sigs[i] = np.frombuffer(lib.sign(seed, pub, m), np.uint8)
    return pubs, sigs, msgs


def _best_s(fn, reps=HOST_REPS):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _wall_ms(fn):
    """Median host wall of MEDIAN_REPS calls after MEDIAN_WARM, each
    ending with its results on the host."""
    import statistics
    for _ in range(KT.MEDIAN_WARM):
        fn()
    times = []
    for _ in range(KT.MEDIAN_REPS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _max_err(got, want):
    """Largest byte difference of two tuples of uint8 tensors (0: equal)."""
    import torch
    return max(int((g.to(torch.int16) - w.to(torch.int16)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


def run(batch: int = BATCH, ns=NODE_NS, trace_dir=None) -> dict:
    """Profile on cuda:0; raises SystemExit on any byte or verdict off."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("kernel_profile: no CUDA device")
    from ..ops import _build
    from ..ops import ed25519_kernel as EK
    from ..ops import ladder as LD
    from ..ops.testvectors import oracle_results
    from ..ops.verifier import CudaBatchVerifier, host_k, host_prepare
    from ..native.loader import get_lib

    ns = tuple(n for n in ns if n <= batch)
    dev = torch.device("cuda", 0)
    before = launch_counts()
    card = KT.card_line()
    rate = KT.imad_per_s()
    t0 = time.perf_counter()
    pubs, sigs, msgs = profile_rows(batch)
    rows_s = time.perf_counter() - t0

    # --- host prep in isolation ------------------------------------------
    host = {"host_k_s": _best_s(lambda: host_k(pubs, sigs, msgs)),
            "host_prepare_s": _best_s(lambda: host_prepare(pubs, sigs,
                                                           msgs))}
    if not host_prepare(pubs, sigs, msgs)[2].all():
        raise SystemExit("kernel_profile: host_prepare rejected a row")

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    a, r, s = on(pubs), on(sigs[:, :32]), on(sigs[:, 32:])
    m = on(np.frombuffer(b"".join(msgs), np.uint8).reshape(batch, 32))
    k = on(host_k(pubs, sigs, msgs))

    # --- every stage against its plain version, before any timing ---------
    errors, plain_ms = {}, {}

    def plain(tag, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        plain_ms[tag] = (time.perf_counter() - t0) * 1e3
        return out
    for tag, mode, mk in (("prep_msg32", EK.MODE_MSG32, m),
                          ("prep_k", EK.MODE_K, k)):
        got = EK.prep(a, r, s, mk, mode)
        errors[tag] = _max_err(got, plain(
            tag, lambda: EK.prep_plain(a, r, s, mk, mode)))
        if tag == "prep_msg32":
            k_dev, neg_a, ok = got
            errors["device_k_is_host_k"] = _max_err((k_dev,), (k,))
    # the windows-only variant takes -A as two (n,32) tensors
    nax, nay = neg_a[:, :32].contiguous(), neg_a[:, 32:].contiguous()
    # ladder_plain is ladder_windows_plain then affine: one run of the
    # windows serves both
    win_want = plain("windows",
                     lambda: LD.ladder_windows_plain(s, k, nax, nay))
    xy_want = plain("affine", lambda: LD.affine(*win_want))
    lad_want = (LD.finish(*xy_want, r, ok), *xy_want)
    plain_ms["ladder"] = plain_ms["windows"] + plain_ms.pop("affine")
    verdict = LD.ladder_verdict(s, k, neg_a, r, ok, xy=True)
    errors["ladder"] = _max_err(verdict, lad_want)
    errors["windows"] = _max_err(LD.ladder_windows(s, k, nax, nay),
                                 win_want)
    for n in ns:
        errors[f"ladder@{n}"] = _max_err(
            LD.ladder_verdict(s[:n], k[:n], neg_a[:n], r[:n], ok[:n],
                              xy=True), [t[:n] for t in lad_want])
        errors[f"windows@{n}"] = _max_err(
            LD.ladder_windows(s[:n], k[:n], nax[:n], nay[:n]),
            [t[:n] for t in win_want])
    checks = {tag: err == 0 for tag, err in errors.items()}
    sample = list(range(0, batch, ORACLE_STRIDE))
    oracle = np.array(oracle_results([(pubs[i].tobytes(), sigs[i].tobytes(),
                                       msgs[i]) for i in sample]))
    offsets = np.arange(batch + 1, dtype=np.uint64) * 32
    native = get_lib().batch_verify(pubs, sigs, b"".join(msgs), offsets)
    verifier = CudaBatchVerifier(device=dev)
    verdicts = {
        "ladder_verdicts": verdict[0].cpu().numpy(),
        "verify_kernel_msg32": EK.verify_kernel_msg32(a, r, s, m)
        .cpu().numpy(),
        "verify_kernel_full": EK.verify_kernel_full(a, r, s, k)
        .cpu().numpy(),
        "verify_batch": verifier.verify_batch(pubs, sigs, msgs)}
    for tag, v in verdicts.items():
        checks[tag] = bool((v == native).all()
                           and (v[sample] == oracle).all())
    for n in ns:
        v = EK.verify_kernel_msg32(a[:n], r[:n], s[:n], m[:n]).cpu().numpy()
        checks[f"verify_kernel_msg32@{n}"] = bool((v == native[:n]).all())
    torch.cuda.synchronize()
    bad = sorted(t for t, good in checks.items() if not good)
    if bad:
        raise SystemExit(f"kernel_profile: off the plain version or the "
                         f"oracle: {bad}")

    # --- device time per stage ---------------------------------------------
    def stage_fns(n):
        """The stages of BY_N on the first n rows (views: each row block
        starts 16-byte aligned)."""
        return {"ladder": lambda: LD.ladder_verdict(s[:n], k[:n], neg_a[:n],
                                                    r[:n], ok[:n]),
                "windows": lambda: LD.ladder_windows(s[:n], k[:n], nax[:n],
                                                     nay[:n]),
                "verify_kernel_msg32": lambda: EK.verify_kernel_msg32(
                    a[:n], r[:n], s[:n], m[:n])}
    fns = {"prep_msg32": lambda: EK.prep(a, r, s, m, EK.MODE_MSG32),
           "prep_k": lambda: EK.prep(a, r, s, k, EK.MODE_K),
           **stage_fns(batch),
           "verify_kernel_full": lambda: EK.verify_kernel_full(a, r, s, k)}
    stages = {tag: {"loop_ms": KT.loop_ms(fn), "median_ms": KT.median_ms(fn)}
              for tag, fn in fns.items()}
    stages["verify_batch"] = {"wall_ms": _wall_ms(
        lambda: verifier.verify_batch(pubs, sigs, msgs))}
    by_n = {n: {tag: {"loop_ms": KT.loop_ms(fn), "median_ms": KT.median_ms(fn)}
                for tag, fn in stage_fns(n).items()} for n in ns}
    by_n[batch] = {tag: stages[tag] for tag in BY_N}

    def share(part, whole, key="loop_ms"):
        return part[key] / whole[key]
    full32, fullk = stages["verify_kernel_msg32"], stages["verify_kernel_full"]
    shares = {
        "of_msg32_dispatch": {t: share(stages[t], full32) for t in
                              ("prep_msg32", "ladder", "windows")},
        "of_k_dispatch": {t: share(stages[t], fullk) for t in
                          ("prep_k", "ladder")},
        "host_k_of_verify_batch": host["host_k_s"] * 1e3
        / stages["verify_batch"]["wall_ms"]}
    epilogue = {n: {key: {"ladder": v["ladder"][key],
                          "windows": v["windows"][key],
                          "share": 1 - v["windows"][key] / v["ladder"][key]}
                    for key in ("loop_ms", "median_ms")}
                for n, v in sorted(by_n.items())}
    dispatch = {n: v["verify_kernel_msg32"] for n, v in sorted(by_n.items())}

    # --- bounds and resources, in place of XLA's cost analysis -------------
    s_np, k_np = s.cpu().numpy(), k.cpu().numpy()
    lad_products = KT.ladder_products(
        [row.tobytes() for row in s_np], [row.tobytes() for row in k_np])
    products = {
        "prep_msg32": EK.prep_products(EK.MODE_MSG32),
        "prep_k": EK.prep_products(EK.MODE_K),
        "ladder": lad_products / batch,
        "windows": lad_products / batch - KT.EPILOGUE_PRODUCTS}
    _build.lib((_build.WINDOWS_ONLY,))
    win_lib = _build.variant_info[(_build.WINDOWS_ONLY,)]["path"]
    kernels = {}
    for tag, kind, name, path, defines, sass_name in (
            ("prep_msg32", "prep", "ed25519_prep", _build.info["path"], (),
             "prep"),
            ("prep_k", "prep", "ed25519_prep", _build.info["path"], (),
             "prep"),
            ("ladder", "ladder", "ed25519_ladder", _build.info["path"], (),
             "ed25519_ladder_kernel"),
            ("windows", "windows", _build.WINDOWS_KERNEL, win_lib,
             (_build.WINDOWS_ONLY,), "windows")):
        ops_ms = batch * products[tag] / rate * 1e3
        mem_ms = batch * BYTES_PER_SIG[kind] / KT.HBM_BYTES_PER_S * 1e3
        bound = max(ops_ms, mem_ms)
        kernels[tag] = {
            "products_per_sig": products[tag],
            "bytes_per_sig": BYTES_PER_SIG[kind],
            "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= mem_ms else "bytes",
            "share_of_bound": bound / stages[tag]["loop_ms"],
            "info": _build.kernel_info(name, defines),
            "sass": KT.sass_counts(path, _build._nvcc(), sass_name)}

    # --- one traced verify_batch, in place of jax.profiler -----------------
    trace_dir = trace_dir or tempfile.mkdtemp(prefix="kernel_profile-")
    for _ in range(TRACE_CALLS):   # the profiler's start-up lands in the first
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            verifier.verify_batch(pubs, sigs, msgs)
            wall_ms = (time.perf_counter() - t0) * 1e3
    trace_path = f"{trace_dir}/verify_batch.json"
    prof.export_chrome_trace(trace_path)
    by_name = KT.device_ms_by_name(prof)
    busy_ms = sum(by_name.values())
    trace = {"path": trace_path, "wall_ms": wall_ms,
             "device_busy_ms": busy_ms,
             "other_kernels": KT.other_kernels(by_name),
             "idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
             "device_ms_by_kernel": dict(sorted(
                 by_name.items(), key=lambda kv: -kv[1])[:8])}

    counted = {key: launch_counts()[key] - before[key] for key in before}
    want = expected_launches(ns)
    if counted != want:
        raise SystemExit(f"kernel_profile: launches {counted} != "
                         f"{want} (expected_launches)")
    return {"card": card, "device": torch.cuda.get_device_name(0),
            "batch": batch, "ns": list(ns), "rows_s": rows_s,
            "imad_per_s": rate, "host": host, "checks": checks,
            "max_abs_err": errors, "plain_ms": plain_ms,
            "stages": stages, "shares": shares, "epilogue": epilogue,
            "dispatch_msg32": dispatch,
            "kernels": kernels, "trace": trace, "launches": counted}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--n", default=",".join(map(str, NODE_NS)),
                    help="the smaller sizes for the epilogue's share")
    args = ap.parse_args(argv)
    out = run(args.batch, tuple(int(x) for x in args.n.split(",") if x))
    print(json.dumps(out, default=str))
    print(out["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
