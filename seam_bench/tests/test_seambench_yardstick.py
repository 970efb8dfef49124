"""The yardstick against the port's own arithmetic, and what the harness
and its reference load.

The tests may import the port's tools; the harness and the reference may
not import the JAX package, and the reference nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from _seambench import CELLS, ROOT, SEED, tiny_cell

from seam_bench import bounds, corpus
from seam_bench.reference import ed25519_strict as ref

FORBIDDEN = {"jax", "jaxlib", "flax", "stellar_core_tpu"}


def _rows(n=64):
    from stellar_core_tpu_torch.native.loader import get_lib
    cell = tiny_cell(CELLS[0], rows=n, batches=1,
                     invalid_share=0.25)
    return corpus.build(cell.config, cell.traffic, SEED, get_lib())


def test_ladder_bound_equals_the_ports_tool():
    from stellar_core_tpu_torch.scripts import _kernel_timing as kt
    rows = _rows().batches[0]
    s_rows = [sig[32:] for _, sig, _ in rows]
    k_rows = [bounds.k_of(*r).to_bytes(32, "little") for r in rows]
    assert bounds.ladder_products(rows) == kt.ladder_products(s_rows, k_rows)
    assert bounds.EPILOGUE_PRODUCTS == kt.EPILOGUE_PRODUCTS
    assert (bounds.SQ_PRODUCTS, bounds.MUL_PRODUCTS, bounds.IMAD_PER_SM_CLK) \
        == (kt.SQ_PRODUCTS, kt.MUL_PRODUCTS, kt.IMAD_PER_SM_CLK)


def test_dispatch_size_follows_the_ports_fusion_rule():
    import random
    from stellar_core_tpu_torch.ops import verifier
    from seam_bench import sizing
    gen = random.Random(SEED)
    for _ in range(500):
        counts = [gen.choice([0, 1, 9, 300, 512, 16000, 64000,
                              gen.randrange(1, 70000)])
                  for _ in range(gen.randrange(1, 7))]
        ahead = gen.randrange(1, 7)
        assert sizing.coalesce(counts, ahead) \
            == verifier.prevalidate_coalesce(counts, ahead)
    conf = tiny_cell(CELLS[0]).config
    # full ledgers: two 64,000-row checkpoints fused; a quarter full:
    # two of 16,000
    assert sizing.rows_per_dispatch(conf, {"ledger_fill": 1.0}) == 128000
    assert sizing.rows_per_dispatch(conf, {"ledger_fill": 0.25}) == 32000


def test_prep_bound_equals_the_ports_count():
    from stellar_core_tpu_torch.ops import ed25519_kernel as ek
    assert bounds.prep_products(32) == ek.prep_products(ek.MODE_MSG32) \
        == 15909
    assert bounds.prep_products(64) == ek.prep_products(ek.MODE_K)


def test_k_equals_the_oracles():
    from stellar_core_tpu_torch.crypto import ed25519_ref as oracle
    for pub, sig, msg in _rows(8).batches[0]:
        assert bounds.k_of(pub, sig, msg) \
            == oracle.compute_k(sig[:32], pub, msg)


def test_reference_equals_the_oracle_on_edge_vectors():
    from stellar_core_tpu_torch.crypto import ed25519_ref as oracle
    from stellar_core_tpu_torch.ops import testvectors
    items = testvectors.make_differential_vectors(64)
    got = [ref.verify(*it) for it in items]
    assert got == [oracle.verify(*it) for it in items]
    assert 0 < sum(got) < len(got)


def test_corpus_labels_and_the_lax_witness():
    """Every label is the reference's verdict; S + L rows are the ones a
    verifier without the strict rules accepts."""
    c = _rows()
    kinds = c.kinds[0].tolist()
    assert {k for k in kinds if k >= 0} == {0, 1, 2}
    for row, label, kind in zip(c.batches[0], c.labels[0], kinds):
        assert ref.verify(*row) == label
        lax = corpus.INVALID_KINDS[kind] == "s_plus_l" if kind >= 0 else True
        assert ref.verify_lax(*row) == lax


SCAN = '''
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from _seambench import CELLS, run_tiny, tiny_cell
for trace in (False, True):
    run_tiny(tiny_cell(CELLS[0], rows=16, batches=1), 0.2, trace)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
'''


def test_a_run_loads_no_jax_and_no_jax_package():
    tests = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.run([sys.executable, "-c",
                        SCAN.format(root=ROOT, tests=tests)],
                       capture_output=True, text=True, timeout=900,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"})
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(json.loads(p.stdout.splitlines()[-1]))
    assert "stellar_core_tpu_torch" in top
    assert not top & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    path = os.path.join(ROOT, "seam_bench", "reference", "ed25519_strict.py")
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0] if not node.level
                      else ".")
    assert names <= {"__future__", "hashlib"}, names
    p = subprocess.run(
        [sys.executable, "-c",
         "import json, runpy, sys; runpy.run_path(%r); "
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
         % path], capture_output=True, text=True, timeout=120)
    top = set(json.loads(p.stdout.splitlines()[-1]))
    assert not top & (FORBIDDEN | {"stellar_core_tpu_torch", "seam_bench",
                                   "torch"})
