"""PyTorch/CUDA port of stellar_core_tpu, slice by slice.

The first slice is the batch Ed25519 verifier (ops/verifier.py), whose
device path runs two CUDA kernels written for sm_90a (ops/csrc/). This
package imports torch and never jax, and nothing of stellar_core_tpu.
"""
