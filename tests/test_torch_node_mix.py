"""The four-validator network's flood bursts and verifies, counted by
tests/node_mix.py in the JAX package and in the port, on the CPU.

At --load 1000 --service (every node's VerifyService over the host's
verifier, as phase 15 of chip_smoke.py takes its burst from), the port
gives the same verify calls and misses by kind, envelope sizes, every
node's recv_transactions calls (their frames, in order) and LCL as the
JAX package. At --load 1000 --backend (each Application building its
own supervisor and service for the device backend over a counting host
verifier) the two packages give the same dispatches, flushes, consensus
verifies, prevalidator probes and LCL, and the port's are
chip_smoke.NODE_EXPECTED: the counts phase 16 is held to on the card.
"""

import pytest

import chip_smoke as cs
import node_mix
from torch_tx_parity import clear_caches

SAME = ("ledgers", "load", "service", "backend", "payments_admitted",
        "calls", "misses", "envelope_sizes", "recv_transactions_frames",
        "recv_transactions_calls", "lcl", "per_node_per_ledger")


@pytest.mark.parametrize("mode", ["service", "backend"])
def test_node_mix_equal_in_both_packages(mode):
    runs = []
    for port in (False, True):
        clear_caches()
        runs.append(node_mix.count(load=cs.NODE_LOAD, port=port,
                                   **{mode: True}))
    clear_caches()
    jax_run, port_run = runs
    for key in SAME + (("verifier", "prevalidator_probes")
                       if mode == "backend" else ()):
        assert port_run[key] == jax_run[key], key
    assert port_run["package"] == "stellar_core_tpu_torch"
    bursts = port_run["recv_transactions_calls"]
    assert bursts[0] == [] and all(max(b) == 200 for b in bursts[1:])
    if mode == "backend":
        assert {k: port_run[k] for k in cs.NODE_EXPECTED} == \
            cs.NODE_EXPECTED
