#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
1. report the card (nvidia-smi name and power limit, torch and CUDA);
2. build the kernels from ops/csrc/ with nvcc; print the build seconds,
   the compiler's register and spill report, and each kernel's SASS
   instruction mix (cuobjdump -sass: IMAD.WIDE, shuffles, shared and
   local loads, total; static counts);
3. hold each kernel against its plain PyTorch version at n = 16384 on
   the card, byte for byte: ed25519_prep (msg32 and k modes) and
   ed25519_ladder, on lanes of which a quarter the strict checks reject
   (the differential corpus's adversarial tuples and random bytes);
   hold prep's ok flags against the oracle's strict checks and the
   verdicts of prep -> ladder -> finish against the oracle, lane by
   lane; time each kernel (CUDA events, median of 25 launches after
   warm-up) beside the plain version and the integer-multiply bound
   (with the bound's products per signature) and its launch geometry
   (threads per signature, block, resident warps); print, on a line of
   its own, the static product count of each kernel's schedule, which
   the CPU tests count on the plain versions;
4. the differential corpus (make_differential_vectors(200)) through
   CudaBatchVerifier: 0 mismatches against the oracle;
5. the main path at width: 16384 signatures per dispatch in msg32 mode
   with 4 dispatches in flight, one 5000-signature dispatch, and one
   2048-signature host-k batch of mixed message lengths with every 10th
   tuple corrupted, checked against the oracle; the launch counters are
   set to 0 before each part and must equal its dispatch count;
6. one in-flight round under torch.profiler (after a warm-up round):
   device busy time by kernel and the device's idle share.
It prints one `kernels` JSON line, the card line, and last
{"ok": true, "device": {...}}.
"""

import collections
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N = 16384
IN_FLIGHT = 4
ROUNDS = 3
DISTINCT = 512
# integer multiply-adds per SM per clock on compute capability 9.0 (CUDA
# C++ Programming Guide, "Arithmetic Instructions" throughput table, 32-bit
# integer multiply and multiply-add); each 32x32->64 IMAD.WIDE counted once
IMAD_PER_SM_CLK = 64
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
# 32x32->64 products of one field squaring and one field multiply in ten
# radix-2^25.5 limbs (10 + 45 and 10 x 10)
SQ_PRODUCTS, MUL_PRODUCTS = 55, 100


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


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


def ladder_products(s_rows, k_rows):
    """Products that [S]B + [k](-A) in canonical affine form needs on
    these scalars at the fewest point operations of libsodium's
    ge25519_double_scalarmult_vartime: width-5 NAF digits of S and k;
    below the top digit, per position a doubling (4 squarings) and a
    p1p1 -> p2 conversion (3 multiplies), per nonzero digit of k a p3
    conversion and cached addition of an odd multiple of -A (4 + 4), of
    S a p3 conversion and mixed addition of a stored multiple of B
    (4 + 3); the table of -A, 3(-A), ..., 15(-A) (4 squarings, 69
    multiplies); Z^-1 (254 squarings, 11 multiplies); x and y (2)."""
    total = 0
    memo = {}
    for key in zip(s_rows, k_rows):
        if key not in memo:
            nb, tb = wnaf(int.from_bytes(key[0], "little"))
            na, ta = wnaf(int.from_bytes(key[1], "little"))
            top = max(ta, tb, 0)
            # the top digit's table entry is loaded, not added
            first = 8 if ta == top else 7 if tb == top else 0
            sq = 4 + 4 * top + 254
            mul = 69 + 3 * top + 8 * na + 7 * nb - first + 11 + 2
            memo[key] = sq * SQ_PRODUCTS + mul * MUL_PRODUCTS
        total += memo[key]
    return total


def sass_mix(lib_path, nvcc):
    """Static SASS opcode counts per function of the built library, from
    cuobjdump beside nvcc: {function: Counter(opcode)}, or None when the
    toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", lib_path], check=True,
                         capture_output=True, text=True).stdout
    mix, fn = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            mix[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and fn:
            mix[fn][m.group(1)] += 1
    return mix


def geometry(info, n, sms):
    """Launch geometry of a kernel at n signatures: resident warps per SM
    (the occupancy limit) and the warps per SM that n fills."""
    threads = n * info["threads_per_sig"]
    warps = -(-threads // 32)
    resident = info["blocks_per_sm"] * info["block"] // 32
    return dict(info, warps_per_sm_resident=resident,
                warps_per_sm=min(resident, warps / sms))


def strict_flags(ref, torsion_y, pub, sig):
    """The prep kernel's ok from the oracle's primitives: S < L; A and R
    canonical and not of a torsion y; A decompresses strictly."""
    mask = (1 << 255) - 1
    ya = int.from_bytes(pub, "little") & mask
    yr = int.from_bytes(sig[:32], "little") & mask
    return (int.from_bytes(sig[32:], "little") < ref.L
            and ya < ref.P and yr < ref.P
            and ya not in torsion_y and yr not in torsion_y
            and ref.pt_decompress(pub, strict=True) is not None)


def rows(tuples):
    """(pubs (n,32), sigs (n,64), msgs) as numpy uint8 arrays and a list."""
    n = len(tuples)
    pubs = np.frombuffer(b"".join(p for p, _, _ in tuples),
                         np.uint8).reshape(n, 32)
    sigs = np.frombuffer(b"".join(s for _, s, _ in tuples),
                         np.uint8).reshape(n, 64)
    return pubs, sigs, [m for _, _, m in tuples]


def describe(info):
    return (f"{info['threads_per_sig']} thread(s) per signature, blocks of "
            f"{info['block']}, {info['warps_per_sm']:.2f} warps per SM at "
            f"n={N} (resident limit {info['warps_per_sm_resident']}), "
            f"{info['regs']} registers, {info['local_bytes']} B local")


def median_ms(fn, reps=25, warm=3):
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


def once_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_abs_err(xs, ys):
    return max(int((x.to(torch.int16) - y.to(torch.int16)).abs().max())
               for x, y in zip(xs, ys))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stellar_core_tpu_torch.crypto import ed25519_ref as ref
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.ops import _build
    from stellar_core_tpu_torch.ops import ed25519_kernel as EK
    from stellar_core_tpu_torch.ops import ladder as LD
    from stellar_core_tpu_torch.ops.testvectors import (
        make_differential_vectors, oracle_results, small_order_points)
    from stellar_core_tpu_torch.ops.verifier import (CudaBatchVerifier,
                                                     host_k)

    # --- 1. the card -----------------------------------------------------
    card = smi("name,power.limit")
    clock_mhz = float(smi("clocks.max.sm").split()[0])
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"card: {card}; max SM clock {clock_mhz} MHz; {sms} SMs")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    imad_per_s = sms * IMAD_PER_SM_CLK * clock_mhz * 1e6

    # --- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.info['seconds']:.1f} s) -> "
          f"{os.path.relpath(_build.info['path'])}")
    for line in _build.info["ptxas"].splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print("  ptxas:", line.strip())
    mix = sass_mix(_build.info["path"], _build._nvcc())
    if mix is None:
        print("  sass: cuobjdump not found beside nvcc (not measured)")
    for fn, ops in sorted((mix or {}).items()):
        def count(*prefixes):
            return sum(c for op, c in ops.items() if op.startswith(prefixes))
        print(f"  sass {fn}: {sum(ops.values())} instructions, IMAD.WIDE "
              f"{count('IMAD.WIDE')}, IMAD {ops['IMAD']}, SHFL "
              f"{count('SHFL')}, LDS {count('LDS')}, LDL/STL "
              f"{count('LDL', 'STL')}; top {ops.most_common(6)}")
    infos = {k: geometry(_build.kernel_info(k), N, sms)
             for k in _build.KERNELS}
    for k, info in infos.items():
        print(f"  {k}: {info}")
    sys.stdout.flush()

    # --- signed tuples for phases 3 and 5 --------------------------------
    t0 = time.perf_counter()
    keys = [SecretKey.pseudo_random_for_testing(9000 + i) for i in range(64)]
    distinct = []
    for i in range(DISTINCT):
        sk = keys[i % len(keys)]
        msg = (b"chip-smoke-%d" % i).ljust(32, b".")
        distinct.append((sk.public_key().raw, sk.sign(msg), msg))
    print(f"signed {DISTINCT} distinct tuples in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pubs, sigs, msgs = rows([distinct[i % DISTINCT] for i in range(N)])

    # --- 3. kernels against their plain versions, n = 16384 --------------
    # every 4th lane is one the strict checks reject or the equation
    # fails: the corpus's 32-byte-message tuples (S >= L, non-canonical,
    # small-order and torsion-defect A and R, corrupted bytes) and random
    # bytes (A that does not decompress, S below 2^252 or random)
    rng = np.random.default_rng(7)
    corpus = make_differential_vectors(200)
    bad = [t for t in corpus if len(t[2]) == 32]
    for j in range(256):
        b = rng.integers(0, 256, 128, dtype=np.uint8).tobytes()
        s_ = b[64:96] if j % 2 else b[64:95] + bytes([b[95] & 0x0F])
        bad.append((b[:32], b[32:64] + s_, b[96:]))
    lanes = [bad[(i // 4) % len(bad)] if i % 4 == 3
             else distinct[i % DISTINCT] for i in range(N)]
    t0 = time.perf_counter()
    torsion_y = {int.from_bytes(t, "little") & ((1 << 255) - 1)
                 for t in small_order_points()}
    uniq = {t: (strict_flags(ref, torsion_y, t[0], t[1]), ref.verify(*t))
            for t in set(lanes)}
    want_ok = torch.tensor([uniq[t][0] for t in lanes], dtype=torch.uint8,
                           device=dev)
    want_verdict = [uniq[t][1] for t in lanes]
    print(f"phase 3 lanes: {len(uniq)} distinct, {int(want_ok.sum())} of "
          f"{N} pass the strict checks, {sum(want_verdict)} verify "
          f"(oracle, {time.perf_counter() - t0:.1f} s)", flush=True)
    p3, s3, m3 = rows(lanes)

    def dev_u8(arr):
        return torch.from_numpy(np.array(arr)).to(dev)

    a, r, s = dev_u8(p3), dev_u8(s3[:, :32]), dev_u8(s3[:, 32:])
    m = dev_u8(np.frombuffer(b"".join(m3), np.uint8).reshape(N, 32))
    k_host = dev_u8(host_k(p3, s3, m3))
    entries = []
    for mode, mk, tag in ((EK.MODE_MSG32, m, "msg32"),
                          (EK.MODE_K, k_host, "k")):
        got = EK.prep(a, r, s, mk, mode)
        want, plain_ms = once_ms(lambda: EK.prep_plain(a, r, s, mk, mode))
        match = all(torch.equal(x, y) for x, y in zip(got, want))
        ms = median_ms(lambda: EK.prep(a, r, s, mk, mode))
        # prep's work does not depend on the data: its schedule is the
        # fewest products the function needs
        products = N * EK.prep_products(mode)
        bytes_ = N * (128 + 32 + 64 + 1)
        b_ops = products / imad_per_s * 1e3
        b_mem = bytes_ / HBM_BYTES_PER_S * 1e3
        entries.append(dict(
            name=f"ed25519_prep[{tag}]", route="cuda",
            source="stellar_core_tpu_torch/ops/csrc/ed25519.cu",
            replaces=("stellar_core_tpu/ops/sha512.py:129 sha512_96, :240 "
                      "mod_l, ed25519_kernel.py:305 decompress_neg, :357 "
                      "_verify_full flags"),
            n=N, match=match, max_abs_err=max_abs_err(got, want),
            ms=ms, plain_ms=plain_ms, bound_ms=max(b_ops, b_mem),
            bound_by="operations" if b_ops >= b_mem else "bytes",
            library_ms=None, launches=None,
            bound_products_per_sig=products / N,
            bound_share=max(b_ops, b_mem) / ms, **infos["ed25519_prep"]))
        if not match:
            raise SystemExit(f"ed25519_prep[{tag}] disagrees with plain")
        print(f"prep[{tag}] matches plain at n={N}: {ms:.4f} ms "
              f"(plain {plain_ms:.1f} ms; bound {max(b_ops, b_mem):.4f} ms "
              f"= {max(b_ops, b_mem) / ms:.4f} of the time; the bound "
              f"counts {products / N:.0f} products per signature; "
              f"{describe(infos['ed25519_prep'])})",
              flush=True)
        if not torch.equal(got[2], want_ok):
            raise SystemExit(f"prep[{tag}] ok flags differ from the "
                             "oracle's strict checks")
        if mode == EK.MODE_MSG32:
            k_dev, neg_a, ok = got
            if not torch.equal(k_dev, k_host):
                raise SystemExit("device k differs from host k")
    nax, nay = neg_a[:, :32].contiguous(), neg_a[:, 32:].contiguous()
    got = LD.ladder(s, k_dev, nax, nay)
    want, plain_ms = once_ms(lambda: LD.ladder_plain(s, k_dev, nax, nay))
    match = all(torch.equal(x, y) for x, y in zip(got, want))
    ms = median_ms(lambda: LD.ladder(s, k_dev, nax, nay))
    s_np, k_np = s.cpu().numpy().tobytes(), k_dev.cpu().numpy().tobytes()
    products = ladder_products(
        [s_np[32 * i:32 * i + 32] for i in range(N)],
        [k_np[32 * i:32 * i + 32] for i in range(N)])
    b_ops = products / imad_per_s * 1e3
    b_mem = N * (4 * 32 + 2 * 32) / HBM_BYTES_PER_S * 1e3
    entries.append(dict(
        name="ed25519_ladder", route="cuda",
        source="stellar_core_tpu_torch/ops/csrc/ed25519.cu",
        replaces="stellar_core_tpu/ops/ed25519_pallas.py:202 ladder",
        n=N, match=match, max_abs_err=max_abs_err(got, want),
        ms=ms, plain_ms=plain_ms, bound_ms=max(b_ops, b_mem),
        bound_by="operations" if b_ops >= b_mem else "bytes",
        library_ms=None, launches=None,
        bound_products_per_sig=products / N,
        bound_share=max(b_ops, b_mem) / ms,
        **infos["ed25519_ladder"]))
    if not match:
        raise SystemExit("ed25519_ladder disagrees with plain")
    print(f"ladder matches plain at n={N}: {ms:.4f} ms "
          f"(plain {plain_ms:.1f} ms; bound {max(b_ops, b_mem):.4f} ms = "
          f"{max(b_ops, b_mem) / ms:.4f} of the time; the bound counts "
          f"{products / N:.0f} products per signature; "
          f"{describe(infos['ed25519_ladder'])})",
          flush=True)
    print(f"schedule products per signature (static counts of the plain "
          f"versions' schedules, which tests/test_torch_ladder.py::"
          f"test_plain_ladder_matches_oracle_on_edge_scalars and "
          f"tests/test_torch_field.py::test_prep_runs_its_product_count "
          f"check by counting field products; not measured in this run): "
          f"ladder {LD.LADDER_PRODUCTS}, prep[msg32] "
          f"{EK.prep_products(EK.MODE_MSG32)}, prep[k] "
          f"{EK.prep_products(EK.MODE_K)}", flush=True)
    verdict = EK.finish(got[0], got[1], r, ok).cpu().tolist()
    bad_lanes = sum(g != w for g, w in zip(verdict, want_verdict))
    if bad_lanes:
        raise SystemExit(f"prep -> ladder -> finish: {bad_lanes} lanes "
                         "differ from the oracle")
    print(f"prep -> ladder -> finish at n={N}: 0 lanes differ from the "
          "oracle", flush=True)

    # --- 4. differential corpus ------------------------------------------
    items = corpus
    want = oracle_results(items)
    for sha in (True, False):
        got = CudaBatchVerifier(device_sha=sha).verify_tuples(items)
        mism = sum(g != w for g, w in zip(got, want))
        print(f"corpus device_sha={sha}: n={len(items)} "
              f"mismatches={mism}", flush=True)
        if mism:
            raise SystemExit("corpus mismatch against the oracle")

    # --- 5. main path at width -------------------------------------------
    v = CudaBatchVerifier()
    if not v.verify_batch(pubs, sigs, msgs).all():           # warm-up
        raise SystemExit("warm-up dispatch rejected a valid signature")
    EK.prep.launches = LD.ladder.launches = 0
    rates = []
    dispatches = 0
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        handles = [v.verify_batch_async(pubs, sigs, msgs)
                   for _ in range(IN_FLIGHT)]
        results = [h() for h in handles]
        dt = time.perf_counter() - t0
        dispatches += IN_FLIGHT
        if not all(res.all() for res in results):
            raise SystemExit("a valid signature was rejected")
        rates.append(IN_FLIGHT * N / dt)
    t0 = time.perf_counter()
    res = v.verify_batch(pubs[:5000], sigs[:5000], msgs[:5000])
    dt5000 = time.perf_counter() - t0
    dispatches += 1
    if not res.all():
        raise SystemExit("5000 dispatch rejected a valid signature")
    msg32_launches = (EK.prep.launches, LD.ladder.launches)
    if msg32_launches != (dispatches, dispatches):
        raise SystemExit(f"launch counts {msg32_launches} != {dispatches}")
    print(f"msg32: {IN_FLIGHT} x {N} in flight, verifies/s per round "
          f"{[round(x, 1) for x in rates]}; 5000 in {dt5000 * 1e3:.2f} ms "
          f"[{card}]", flush=True)

    lengths = (0, 1, 31, 32, 33, 100, 1000)
    mixed = []
    for i in range(256):
        sk = keys[i % len(keys)]
        msg = bytes((i + j) & 0xFF for j in range(lengths[i % 7]))
        mixed.append((sk.public_key().raw, sk.sign(msg), msg))
    batch = []
    for i in range(2048):
        p_, s_, m_ = mixed[i % len(mixed)]
        if i % 10 == 0:
            s_ = s_[:40] + bytes([s_[40] ^ (1 + i % 7)]) + s_[41:]
        batch.append((p_, s_, m_))
    uniq = {t: ref.verify(*t) for t in set(batch)}
    EK.prep.launches = LD.ladder.launches = 0
    t0 = time.perf_counter()
    got = v.verify_tuples(batch)
    dt_k = time.perf_counter() - t0
    k_launches = (EK.prep.launches, LD.ladder.launches)
    if k_launches != (1, 1):
        raise SystemExit(f"host-k launch counts {k_launches} != (1, 1)")
    bad = sum(g != uniq[t] for g, t in zip(got, batch))
    if bad or sum(got) != 2048 - 205:
        raise SystemExit(f"host-k batch: {bad} mismatches, {sum(got)} ok")
    print(f"host-k: 2048 mixed lengths, every 10th corrupted, 0 mismatches, "
          f"{dt_k * 1e3:.1f} ms", flush=True)

    print(f"launch counts: msg32 part {dispatches} dispatches -> prep "
          f"{msg32_launches[0]}, ladder {msg32_launches[1]}; host-k part 1 "
          f"dispatch -> prep {k_launches[0]}, ladder {k_launches[1]}")

    # --- 6. where the time goes: one in-flight round under the profiler --
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()

    def profiled_round():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            handles = [v.verify_batch_async(pubs, sigs, msgs)
                       for _ in range(IN_FLIGHT)]
            for h in handles:
                h()
            wall_ms = (time.perf_counter() - t0) * 1e3
        return prof, wall_ms

    # a warm-up round under the profiler first: tracing's own start-up
    # lands there, not in the measured round
    profiled_round()
    prof, wall_ms = profiled_round()
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
    busy_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    if busy_ms:
        print(f"profile ({IN_FLIGHT} x {N} in flight, profiler on): wall "
              f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.4f}")
        for name, ms_ in top:
            print(f"  device {ms_:9.3f} ms  {name[:90]}")
    else:
        print("profile: the profiler saw no device time (not measured)")

    entries[0]["launches"] = msg32_launches[0]
    entries[1]["launches"] = k_launches[0]
    entries[2]["launches"] = msg32_launches[1] + k_launches[1]
    print(json.dumps({"kernels": entries,
                      "verifies_per_s": rates, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
