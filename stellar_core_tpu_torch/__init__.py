"""PyTorch/CUDA port of stellar_core_tpu, slice by slice.

The batch Ed25519 verifier (ops/verifier.py) runs two CUDA kernels
written for sm_90a (ops/csrc/). The live verify path sits on it: the
coalescing VerifyService (ops/verify_service.py) over the
BackendSupervisor breaker and watchdog (ops/backend_supervisor.py),
with copies of the util layer (util/) and the host C++ verifier
(native/) under them. This package imports torch and never jax, and
nothing of stellar_core_tpu.
"""
