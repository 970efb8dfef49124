"""The benchmark of stellar_core_tpu_torch's verify seam (BENCHMARK.json)."""
