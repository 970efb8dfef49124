"""The control and the faults: the timed path broken underneath a run, so
that the check can be seen to fail. The benchmark's own runs never load
this module; seam_bench/tests drives it.

`broken(kind)` replaces the port's kernel entries that `_launch_shards`
calls (ops/ed25519_kernel.py `verify_kernel_msg32` and
`verify_kernel_full`) for the length of a `with` block:

- `lax`, the control: the program's own path with its strict flags
  switched off, prep then the ladder in its v1 form (the equation
  alone, `ladder_verdict` without `ok`). It breaks the guarantee that
  every verdict is libsodium's strict one: S + L, which only a strict
  verifier rejects, passes;
- `half_left_out`: the second half of each dispatch's rows is never
  verified and comes back False;
- `answer_altered`: the first verdict of each dispatch is flipped where
  it is produced;
- `stale`: each dispatch gets the verdicts of the one before it (the
  first its own), as a reused result buffer or a cache keyed by the
  batch would give them.
"""

from __future__ import annotations

import contextlib

KINDS = ("lax", "half_left_out", "answer_altered", "stale")


@contextlib.contextmanager
def broken(kind: str):
    from stellar_core_tpu_torch.ops import ed25519_kernel as ek
    from stellar_core_tpu_torch.ops.ladder import ladder_verdict

    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}")
    saved = ek.verify_kernel_msg32, ek.verify_kernel_full
    last = {}

    def entry(mode, good):
        def lax(a, r, s, mk):
            k, neg_a, _ = ek.prep(a, r, s, mk, mode)
            return ladder_verdict(s, k, neg_a, r)

        def half_left_out(a, r, s, mk):
            h = a.shape[0] // 2
            v = good(a[:h], r[:h], s[:h], mk[:h])
            return _cat(v, a.shape[0] - h)

        def answer_altered(a, r, s, mk):
            v = good(a, r, s, mk).clone()
            v[:1] = ~v[:1]
            return v

        def stale(a, r, s, mk):
            v = good(a, r, s, mk)
            prev = last.get(mode)
            last[mode] = v
            return v if prev is None or prev.shape != v.shape else prev
        return {"lax": lax, "half_left_out": half_left_out,
                "answer_altered": answer_altered, "stale": stale}[kind]

    ek.verify_kernel_msg32 = entry(ek.MODE_MSG32, saved[0])
    ek.verify_kernel_full = entry(ek.MODE_K, saved[1])
    try:
        yield
    finally:
        ek.verify_kernel_msg32, ek.verify_kernel_full = saved


def _cat(v, missing):
    import torch
    return torch.cat([v, torch.zeros(missing, dtype=torch.bool,
                                     device=v.device)])
