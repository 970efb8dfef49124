"""Util layer the verify path needs: copies of the JAX package's util/
modules (checks, logging, threads, timer, cache, tracing, perf, metrics,
chaos), with the same names, metric names and chaos seam names."""
