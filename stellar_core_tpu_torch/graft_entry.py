"""The port's graft entry points, the counterpart of the JAX package's
__graft_entry__.py.

entry(device=None)  -> (fn, example_args): the batch Ed25519
                       verification entry, verify_kernel_full, and four
                       (128, 32) uint8 tensors (A, R, S, k) on the
                       device, made as the reference's _example_batch(128)
                       makes them.
dryrun_multichip(n_devices, device=None) -> dict: the node on the
                       sharded verifier, ShardedBatchVerifier over
                       n_devices positions, and for even n_devices >= 4
                       HybridShardedVerifier over an (n/2, 2) grid, each
                       on a small batch that must verify.

The workload is data-parallel: the batch axis shards over the positions
and no signature depends on another. The reference's dryrun shows n
virtual XLA devices to one process; a CUDA process sees the cards it
has, so here a position is the device named (the current card by
default) repeated n times, and the node boots on the cards there are.
device="cpu" runs the plain versions; the node part then does not run
(the port's Application builds its device verifier on a card or
raises), and the result says so.
"""

from __future__ import annotations

import hashlib

import numpy as np


def example_batch(n_sigs: int):
    """Deterministic rows as the reference's _example_batch: seed i =
    sha256(b"graft-entry-%d"), message i = sha256(b"graft-msg-%d"),
    signed by the native library (RFC 8032: the oracle's bytes). Returns
    (pubs (n,32), sigs (n,64), msgs, k (n,32)) as numpy uint8 arrays and
    a list; k = SHA512(R‖A‖M) mod L (ops/verifier.host_k)."""
    from .native.loader import get_lib
    from .ops.verifier import host_k
    lib = get_lib()
    pubs = np.zeros((n_sigs, 32), dtype=np.uint8)
    sigs = np.zeros((n_sigs, 64), dtype=np.uint8)
    msgs = []
    for i in range(n_sigs):
        seed = hashlib.sha256(b"graft-entry-%d" % i).digest()
        msg = hashlib.sha256(b"graft-msg-%d" % i).digest()
        pub = lib.public_from_seed(seed)
        pubs[i] = np.frombuffer(pub, dtype=np.uint8)
        sigs[i] = np.frombuffer(lib.sign(seed, pub, msg), dtype=np.uint8)
        msgs.append(msg)
    return pubs, sigs, msgs, host_k(pubs, sigs, msgs)


def entry(device=None):
    """(verify_kernel_full, (A, R, S, k)): four (128, 32) uint8 tensors on
    the device (the current card unless `device` names one)."""
    import torch
    from .ops.ed25519_kernel import verify_kernel_full
    from .ops.verifier import resolve_device
    dev = resolve_device(device)
    pubs, sigs, _, k = example_batch(128)
    args = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (pubs, sigs[:, :32], sigs[:, 32:], k))
    return verify_kernel_full, args


def _batch_size(n_devices: int) -> int:
    """The reference's b: at least 8 and n_devices, a multiple of it."""
    b = max(8, n_devices)
    return b + (-b) % n_devices


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the multi-device paths once on small batches; raises on a
    verdict that is not True. Returns what ran: the node's batch sizes
    and cards (or why it did not run), the sharded and hybrid batches."""
    import torch
    from .ops.multihost import HybridShardedVerifier, make_hybrid_mesh
    from .ops.verifier import ShardedBatchVerifier, resolve_device
    if n_devices < 1:
        raise ValueError(f"{n_devices} devices")
    dev = resolve_device(device)
    out = {"device": str(dev), "n_devices": n_devices}

    # the node-selected multi-device path: the port's Application with the
    # device backend and the sharded mesh over every visible card; a
    # ledger close verifies through it
    if dev.type == "cuda":
        from .main import Application, get_test_config
        from .simulation.drive import validate_txset_through_batch_verifier
        from .util.timer import ClockMode, VirtualClock
        cfg = get_test_config()
        cfg.SIGNATURE_VERIFY_BACKEND = "cuda"
        cfg.SIGNATURE_VERIFY_MESH = "sharded"
        # the txset's few signatures go to the card, not the host bypass
        cfg.VERIFY_DEVICE_MIN_BATCH = 1
        app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg)
        app.start()
        try:
            bv = app.batch_verifier
            if bv.ndev != torch.cuda.device_count():
                raise AssertionError(f"node's mesh has {bv.ndev} positions, "
                                     f"{torch.cuda.device_count()} cards")
            calls = validate_txset_through_batch_verifier(app)
            out["node"] = {"cards": bv.ndev, "batches": calls}
        finally:
            app.shutdown()
    else:
        out["node"] = f"not run: device {dev.type}"

    # the sharded verifier on its own, host k as the reference's (A, R,
    # S, k) arguments
    b = _batch_size(n_devices)
    pubs, sigs, msgs, _ = example_batch(b)
    res = ShardedBatchVerifier([dev] * n_devices, device_sha=False) \
        .verify_batch(pubs, sigs, msgs)
    if res.shape != (b,) or not res.all():
        raise AssertionError(f"sharded verifier over {n_devices}: {res}")
    out["sharded"] = {"positions": n_devices, "batch": b}

    # the multi-host layout folded into one process: n/2 hosts x 2 cards
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh = make_hybrid_mesh(devices=[dev] * n_devices,
                                n_hosts=n_devices // 2)
        res = HybridShardedVerifier(mesh, device_sha=False) \
            .verify_batch(pubs, sigs, msgs)
        if res.shape != (b,) or not res.all():
            raise AssertionError(f"hybrid verifier over {n_devices}: {res}")
        out["hybrid"] = {"grid": [n_devices // 2, 2], "batch": b}
    else:
        out["hybrid"] = "not run: needs an even n of at least 4"
    return out
