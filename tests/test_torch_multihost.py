"""The port's ops/multihost.py on the CPU: the (dcn, ici) grid, the hybrid
verifier in one process over a (2, 2) grid of CPU positions, and across
four gloo processes, one CPU position each, where every rank is handed the
same batch, verifies its own shard and receives the others' verdicts. The
verdicts are held against the oracle, and the collectives are watched: a
rank sends one byte per row of its own shards and the batch's tag, and
nothing else. Two more gloo processes collect two in-flight batches in
opposite orders and on two threads, and dispatch them out of step."""

import hashlib
import json
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from stellar_core_tpu_torch.crypto import ed25519_ref as tref
from stellar_core_tpu_torch.crypto.keys import SecretKey
from stellar_core_tpu_torch.ops import ed25519_kernel as EK
from stellar_core_tpu_torch.ops import multihost as MH
from stellar_core_tpu_torch.ops.shard_math import shard_shares

WORLD = 4
SHRUNK = (0, 2, 3)
SPAWN_TIMEOUT_S = 180


def _batch():
    """13 msg32 tuples, lanes 3 (signature) and 10 (message) corrupted."""
    items = []
    for i in range(13):
        sk = SecretKey.pseudo_random_for_testing(4400 + i)
        msg = hashlib.sha256(b"multihost-%d" % i).digest()
        sig = sk.sign(msg)
        if i == 3:
            sig = sig[:50] + bytes([sig[50] ^ 1]) + sig[51:]
        if i == 10:
            msg = msg[:31] + bytes([msg[31] ^ 0x80])
        items.append((sk.public_key().raw, sig, msg))
    return items


def _oracle(items):
    return [tref.verify(p, s, m) for p, s, m in items]


def test_make_hybrid_mesh_shape_and_axes(monkeypatch):
    mesh = MH.make_hybrid_mesh(["cpu"] * 8, n_hosts=2)
    assert mesh.axis_names == ("dcn", "ici")
    assert mesh.devices.shape == (2, 4)
    # one process stands in for both hosts: it owns every position
    assert {p.rank for p in mesh.devices.flat} == {0}
    assert mesh.devices[1, 3] == MH.Position(0, torch.device("cpu"))
    with pytest.raises(ValueError):
        MH.make_hybrid_mesh(["cpu"] * 5, n_hosts=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MH.make_hybrid_mesh()                 # the default: every card


def test_initialize_distributed(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    MH.initialize_distributed()
    MH.initialize_distributed("10.0.0.1:7000", 1, 0)
    assert calls == []
    MH.initialize_distributed("10.0.0.1:7000", 4, 2)
    assert calls == [(("gloo",), {"init_method": "tcp://10.0.0.1:7000",
                                  "world_size": 4, "rank": 2})]


def test_hybrid_in_one_process_matches_oracle():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        v = MH.HybridShardedVerifier(MH.make_hybrid_mesh(["cpu"] * 4,
                                                         n_hosts=2),
                                     device_min_batch=1, device_sha=True)
        assert v.ndev == 4 and v.world == 1
        assert v.mesh.devices.shape == (2, 2)
        items = _batch()
        assert v.verify_tuples(items) == _oracle(items)
    finally:
        torch.set_num_threads(prev)


def _rank_main(rank, world, init_file, out_dir):
    """One gloo process: the hybrid verifier over a (world, 1) grid of
    CPU positions, the full grid and then the shrunk set, with every
    broadcast recorded."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            world_size=world, rank=rank)
    sent, seen = [], []
    real_broadcast = dist.broadcast

    def watched(tensor, src, *a, **k):
        seen.append((src, tensor.numel(), str(tensor.dtype)))
        if src == rank:
            sent.append(tensor.numel() * tensor.element_size())
        return real_broadcast(tensor, src, *a, **k)
    dist.broadcast = watched
    forbidden = ("all_gather", "all_gather_object", "send", "isend",
                 "scatter", "all_to_all", "broadcast_object_list")
    for name in forbidden:
        def refuse(*a, _name=name, **k):
            raise AssertionError(f"{_name} carried data across ranks")
        setattr(dist, name, refuse)
    try:
        v = MH.HybridShardedVerifier(MH.make_hybrid_mesh(["cpu"] * world),
                                     device_min_batch=1, device_sha=True)
        out = {"rank": v.rank, "shape": list(v.mesh.devices.shape),
               "owners": [p.rank for p in v.positions]}
        items = _batch()
        for tag, active in (("full", tuple(range(world))),
                            ("shrunk", SHRUNK)):
            v.set_active_devices(active)
            sent.clear()
            seen.clear()
            out[tag] = {"verdicts": v.verify_tuples(items),
                        "sent": list(sent), "seen": list(seen)}
        with open(f"{out_dir}/rank{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def test_four_gloo_ranks_verify_their_shards(tmp_path):
    _spawn(_rank_main, WORLD, tmp_path)
    items = _batch()
    want = _oracle(items)
    assert sum(want) == 11 and not want[3] and not want[10]
    full, shrunk = shard_shares(13, WORLD), shard_shares(13, len(SHRUNK))
    rows = {"full": dict(enumerate(full)),
            "shrunk": dict(zip(SHRUNK, shrunk))}
    assert rows == {"full": {0: 4, 1: 3, 2: 3, 3: 3},
                    "shrunk": {0: 5, 2: 4, 3: 4}}
    for r in range(WORLD):
        with open(tmp_path / f"rank{r}.json") as f:
            out = json.load(f)
        assert out["rank"] == r and out["shape"] == [WORLD, 1]
        assert out["owners"] == list(range(WORLD))
        for tag in ("full", "shrunk"):
            got = out[tag]
            assert got["verdicts"] == want, (r, tag)
            # one bool per row of its own shard, sent once; nothing sent
            # by a rank whose position is out of the active set
            mine = rows[tag].get(r, 0)
            assert got["sent"] == ([mine + MH.TAG_BYTES] if mine else []), \
                (r, tag)
            assert got["seen"] == [[src, c + MH.TAG_BYTES, "torch.uint8"]
                                   for src, c in rows[tag].items()]


def _pair():
    """Two msg32 batches of 4 whose verdicts differ on every row: a rank
    that took one batch's verdicts for the other's would be caught."""
    a, b = [], []
    for i in range(4):
        sk = SecretKey.pseudo_random_for_testing(4500 + i)
        msg = hashlib.sha256(b"order-%d" % i).digest()
        sig = sk.sign(msg)
        bad = sig[:40] + bytes([sig[40] ^ 4]) + sig[41:]
        a.append((sk.public_key().raw, bad if i % 2 == 0 else sig, msg))
        b.append((sk.public_key().raw, sig if i % 2 == 0 else bad, msg))
    return a, b


def _oracle_entry(a, r, s, m):
    """The oracle in place of the msg32 kernels' plain versions: these
    ranks test the gather, and the plain ladder costs seconds a shard."""
    return torch.tensor([tref.verify(bytes(a[i].numpy()),
                                     bytes(r[i].numpy()) + bytes(s[i].numpy()),
                                     bytes(m[i].numpy()))
                         for i in range(a.shape[0])], dtype=torch.bool)


def _order_rank(rank, world, init_file, out_dir):
    """One gloo process of the order test: two batches in flight on a
    (world, 1) grid, collected in another order than dispatched, then
    dispatched out of step with the other rank."""
    torch.set_num_threads(1)
    EK.verify_kernel_msg32 = _oracle_entry
    dist.init_process_group("gloo", init_method="file://" + init_file,
                            world_size=world, rank=rank)
    try:
        v = MH.HybridShardedVerifier(MH.make_hybrid_mesh(["cpu"] * world),
                                     device_min_batch=1, device_sha=True)
        a, b = _pair()
        out = {}
        # rank 0 collects a then b, rank 1 b then a
        handles = {"a": v.verify_tuples_async(a),
                   "b": v.verify_tuples_async(b)}
        order = ("a", "b") if rank == 0 else ("b", "a")
        out["opposite"] = {k: handles[k]() for k in order}
        # rank 1 collects both at once on two threads
        handles = {"a": v.verify_tuples_async(a),
                   "b": v.verify_tuples_async(b)}
        got = {}
        if rank == 1:
            threads = [threading.Thread(
                target=lambda k=k: got.__setitem__(k, handles[k]()))
                for k in ("b", "a")]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        else:
            got = {k: handles[k]() for k in ("a", "b")}
        out["threads"] = got
        # out of step: rank 1 dispatches b where rank 0 dispatches a
        first, second = (a, b) if rank == 0 else (b, a)
        errors = []
        for h in (v.verify_tuples_async(first),
                  v.verify_tuples_async(second)):
            try:
                errors.append(["verdicts", h()])
            except MH.GatherMismatch as e:
                errors.append(["raised", str(e)])
        out["out_of_step"] = errors
        with open(f"{out_dir}/order{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, tmp_path):
    ctx = tmp.start_processes(
        fn, args=(world, str(tmp_path / "pg"), str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise AssertionError("gloo ranks did not finish in "
                                     f"{SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join(10)
    assert all(not p.is_alive() and p.exitcode == 0 for p in ctx.processes)


def test_gathers_follow_dispatch_order(tmp_path):
    _spawn(_order_rank, 2, tmp_path)
    a, b = _pair()
    want = {"a": _oracle(a), "b": _oracle(b)}
    assert want == {"a": [False, True] * 2, "b": [True, False] * 2}
    for r in range(2):
        with open(tmp_path / f"order{r}.json") as f:
            out = json.load(f)
        assert out["opposite"] == want, r
        assert out["threads"] == want, r
        # the first gather sees the other batch's tag; the verifier
        # stays broken, so the second raises too
        (k1, m1), (k2, m2) = out["out_of_step"]
        assert (k1, k2) == ("raised", "raised"), (r, out["out_of_step"])
        assert "another batch" in m1 and "broken" in m2


def test_grid_rows_must_follow_ranks():
    grid = np.empty((2, 1), dtype=object)
    grid[0, 0] = MH.Position(1, torch.device("cpu"))
    grid[1, 0] = MH.Position(0, torch.device("cpu"))
    with pytest.raises(ValueError):
        MH.HybridShardedVerifier(MH.Mesh(grid, ("dcn", "ici")))
