"""Kernel timing helpers shared by the scripts that time the kernels on
the card (prep_sweep, kernel_profile, kernel_sweep): two timings of a
launch, the rows they time on, and the static SASS counts of a kernel.

- `median_ms`: the median of 25 calls through the wrapper, CUDA events
  around each call after 3 warm-ups (what chip_smoke.py takes), so the
  wrapper's host work counts;
- `loop_ms`: the device time per launch of 50 back-to-back calls between
  two events, where the host's work overlaps the kernels queued before
  it;
- `rows`: n rows holding the differential corpus's tuples and random
  bytes, in a seeded order;
- `sass_counts`: cuobjdump's static instruction counts of one kernel;
- `ladder_products`, `imad_per_s`, `card_line`, `device_ms_by_name`,
  `other_kernels`: the bound of a ladder run on its scalars, the card's
  integer-multiply rate, its name and power limit, a profiler run's
  device time by kernel, and the events in it that are neither verify
  kernel nor a copy.

Each timing calls `fn` a fixed number of times (`MEDIAN_CALLS`,
`LOOP_CALLS`), so a script can predict its launches.
"""

import collections
import functools
import hashlib
import os
import re
import statistics
import subprocess

MEDIAN_REPS, MEDIAN_WARM = 25, 3
LOOP_LAUNCHES, LOOP_REPS = 50, 5
MEDIAN_CALLS = MEDIAN_REPS + MEDIAN_WARM
LOOP_CALLS = 1 + LOOP_LAUNCHES * LOOP_REPS


def median_ms(fn, reps=MEDIAN_REPS, warm=MEDIAN_WARM):
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


def loop_ms(fn, launches=LOOP_LAUNCHES, reps=LOOP_REPS):
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


@functools.lru_cache(maxsize=4)
def _sass_listing(tool, lib_path):
    """cuobjdump's listing of a library, once per library: its path
    holds the hash of what was built, so the listing cannot change."""
    return subprocess.run([tool, "-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout


def sass_counts(lib_path, nvcc, kernel="prep"):
    """Static SASS counts of the kernels whose name holds `kernel` (a
    kernel's listing holds the functions it calls): total, IMAD.WIDE and
    SHFL, and the same for its longest loop, the longest body a backward
    branch closes (prep: one field squaring per pass; the ladder: its
    windows), with its selects and a digest of the loop's instructions
    and operands, addresses left out, so that two builds' loops compare
    equal where they hold the same code. None where cuobjdump is not
    beside nvcc."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = _sass_listing(tool, lib_path)
    ins, fn = [], None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)([^;]*)", line)
        if m and fn and kernel in fn:
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
        loop = max(loops, key=len)
        counts["loop"] = mix(op for _, op, _ in loop)
        text = "\n".join(op + re.sub(r"0x[0-9a-f]+", "0x", rest)
                         for _, op, rest in loop)
        counts["loop"]["digest"] = hashlib.sha256(
            text.encode()).hexdigest()[:16]
    return counts


# 32x32->64 products of one field squaring and one field multiply in ten
# radix-2^25.5 limbs (10 + 45 and 10 x 10)
SQ_PRODUCTS, MUL_PRODUCTS = 55, 100
# integer multiply-adds per SM per clock on compute capability 9.0 (CUDA
# C++ Programming Guide, "Arithmetic Instructions" throughput table, 32-bit
# integer multiply and multiply-add); each 32x32->64 IMAD.WIDE counted once
IMAD_PER_SM_CLK = 64
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return smi("name,power.limit")


def imad_per_s(device_index=0):
    """32x32->64 integer multiplies per second of the card: SMs x 64 per
    clock x the maximum SM clock."""
    import torch
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    mhz = float(smi("clocks.max.sm").splitlines()[device_index].split()[0])
    return sms * IMAD_PER_SM_CLK * mhz * 1e6


def wnaf(v, w=5):
    """(nonzero digits, index of the top digit) of v's width-w NAF."""
    n, top, i = 0, -1, 0
    while v:
        if v & 1:
            d = v & ((1 << w) - 1)
            v -= d - (1 << w) if d >> (w - 1) else d
            n, top = n + 1, i
        v >>= 1
        i += 1
    return n, top


# the ladder's epilogue in ladder_products: Z^-1 (254 squarings, 11
# multiplies) and x, y (2 multiplies)
EPILOGUE_PRODUCTS = 254 * SQ_PRODUCTS + 13 * MUL_PRODUCTS


def ladder_products(s_rows, k_rows):
    """Products that [S]B + [k](-A) in canonical affine form needs on
    these scalars (32-byte rows) at the fewest point operations of
    libsodium's ge25519_double_scalarmult_vartime: width-5 NAF digits of
    S and k; below the top digit, per position a doubling (4 squarings)
    and a p1p1 -> p2 conversion (3 multiplies), per nonzero digit of k a
    p3 conversion and cached addition of an odd multiple of -A (4 + 4),
    of S a p3 conversion and mixed addition of a stored multiple of B
    (4 + 3); the table of -A, 3(-A), ..., 15(-A) (4 squarings, 69
    multiplies); the epilogue (EPILOGUE_PRODUCTS)."""
    total = 0
    memo = {}
    for key in zip(s_rows, k_rows):
        if key not in memo:
            nb, tb = wnaf(int.from_bytes(key[0], "little"))
            na, ta = wnaf(int.from_bytes(key[1], "little"))
            top = max(ta, tb, 0)
            # the top digit's table entry is loaded, not added
            first = 8 if ta == top else 7 if tb == top else 0
            sq = 4 + 4 * top
            mul = 69 + 3 * top + 8 * na + 7 * nb - first
            memo[key] = (sq * SQ_PRODUCTS + mul * MUL_PRODUCTS
                         + EPILOGUE_PRODUCTS)
        total += memo[key]
    return total


def device_ms_by_name(prof):
    """Device time in ms by event name from a torch.profiler run."""
    by_name = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): a CPU op's device
        # time repeats that of the kernels it launched
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3
    return by_name


def other_kernels(by_name) -> list:
    """Names in device_ms_by_name's result that are neither of the two
    verify kernels nor a copy: a plain-torch operation that ran on the
    card during a dispatch lands here."""
    return sorted(name for name in by_name
                  if "ed25519_prep_kernel" not in name
                  and "ed25519_ladder_kernel" not in name
                  and "memcpy" not in name.lower())
