"""The rows a cell dispatches, made from the seed.

A row is one (public key, signature, message) tuple and its label, the
verdict it was built to have. `build(config, traffic, seed)` signs
`rows_per_dispatch` distinct rows once and makes `distinct_batches`
batches of them, each in its own seeded order (the first in signing
order) and with its own seeded rows broken, so no row repeats within a
dispatch and two batches differ in order and in labels:

- `accounts` signing keys, each from 32 seeded bytes;
- per row an account drawn from the seed and a message of
  `message_bytes` seeded bytes (the 32-byte contents hash of a
  transaction);
- the signature, made by `sign` (the host's Ed25519 signer, over the
  host's cores);
- in each batch a seeded share `invalid_share` of the rows broken, each
  by one of `invalid_kinds`: `flip_r` or `flip_s` xors one byte of R or
  S with a nonzero byte, `s_plus_l` replaces S by S + L (the malleated
  form that only a strict verifier rejects). Their label is False.

The same seed gives the same rows, batches and labels: the sizes and the
share of broken rows are fixed by the files, and the seed chooses only
the bytes, the orders and the positions.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np

L = 2**252 + 27742317777372353535851937790883648493
INVALID_KINDS = ("flip_r", "flip_s", "s_plus_l")


class Corpus:
    """Batches of rows (lists of tuples), their labels (lists of bools)
    and the kind of each row."""

    def __init__(self, batches, labels, kinds):
        self.batches = batches
        self.labels = labels
        # per batch, an (n,) int8 array: -1 valid, else an index of
        # INVALID_KINDS
        self.kinds = kinds


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator for one use of the seed (any whole number)."""
    seed = int(seed)
    return np.random.default_rng([abs(seed), int(seed < 0)]
                                 + list(stream.encode()))


def _sign_all(sign, seeds, pubs, owner, msgs, workers):
    """Signatures of every row, signed in chunks over `workers` threads
    (the signer releases the interpreter lock)."""
    n = len(msgs)
    out = [None] * n

    def chunk(lo, hi):
        for i in range(lo, hi):
            a = owner[i]
            out[i] = sign(seeds[a], pubs[a], msgs[i])

    step = max(1, -(-n // (workers * 4)))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        for f in [pool.submit(chunk, lo, min(n, lo + step))
                  for lo in range(0, n, step)]:
            f.result()
    return out


def _break(sig: bytes, kind: str, rng: np.random.Generator) -> bytes:
    b = bytearray(sig)
    if kind == "s_plus_l":
        s = int.from_bytes(sig[32:], "little") + L
        b[32:] = s.to_bytes(32, "little")
    else:
        j = int(rng.integers(0, 32)) + (32 if kind == "flip_s" else 0)
        b[j] ^= int(rng.integers(1, 256))
    return bytes(b)


def build(config: dict, traffic: dict, seed: int, signer,
          workers: int = None) -> Corpus:
    """The cell's rows. `signer` has public_from_seed(seed) and
    sign(seed, pub, msg)."""
    n = int(traffic["rows_per_dispatch"])
    nb = int(traffic["distinct_batches"])
    gen = rng(seed, "corpus." + config["name"])
    seeds = [bytes(r) for r in gen.integers(
        0, 256, (int(config["accounts"]), 32), dtype=np.uint8)]
    pubs = [signer.public_from_seed(s) for s in seeds]
    owner = gen.integers(0, len(seeds), n).tolist()
    mbytes = int(config["message_bytes"])
    blob = gen.integers(0, 256, n * mbytes, dtype=np.uint8).tobytes()
    msgs = [blob[i * mbytes:(i + 1) * mbytes] for i in range(n)]
    sigs = _sign_all(signer.sign, seeds, pubs, owner, msgs,
                     workers or min(8, os.cpu_count() or 1))
    n_bad = int(round(float(config["invalid_share"]) * n))
    names = list(config["invalid_kinds"])
    for name in names:
        if name not in INVALID_KINDS:
            raise ValueError(f"unknown invalid kind {name!r}")
    batches, labels, kind_arrays = [], [], []
    for b in range(nb):
        order = np.arange(n) if b == 0 else gen.permutation(n)
        kinds = np.full(n, -1, dtype=np.int8)
        rows = [(pubs[owner[i]], sigs[i], msgs[i]) for i in order.tolist()]
        if n_bad:
            bad = gen.choice(n, n_bad, replace=False)
            which = gen.integers(0, len(names), n_bad)
            for j, w in zip(bad.tolist(), which.tolist()):
                kinds[j] = INVALID_KINDS.index(names[w])
                pub, sig, msg = rows[j]
                rows[j] = (pub, _break(sig, names[w], gen), msg)
        batches.append(rows)
        kind_arrays.append(kinds)
        labels.append((kinds < 0).tolist())
    return Corpus(batches, labels, kind_arrays)
