"""The port's device verifier on the CPU, for tests that rehearse a path
which builds it by name where there is no card.

`CudaBatchVerifier(...)` resolves the card when no device is named and
raises without one; the package keeps no CPU fallback. Inside
`cpu_device_verifier()` a module that builds it through
`stellar_core_tpu_torch.ops.verifier.CudaBatchVerifier` gets it on the
CPU (its plain versions) unless it names a device.

Processes a test starts get the same by this directory's
`sitecustomize_source()` written as `sitecustomize.py` into a directory
on their PYTHONPATH.
"""

import contextlib
import os


@contextlib.contextmanager
def cpu_device_verifier():
    from stellar_core_tpu_torch.ops import verifier
    base = verifier.CudaBatchVerifier

    class OnTheCpu(base):
        def __init__(self, *args, device="cpu", **kwargs):
            super().__init__(*args, device=device, **kwargs)
    verifier.CudaBatchVerifier = OnTheCpu
    try:
        yield
    finally:
        verifier.CudaBatchVerifier = base


def sitecustomize_source() -> str:
    """A sitecustomize module that enters cpu_device_verifier() for the
    whole life of the process that imports it at start-up."""
    here = os.path.dirname(os.path.abspath(__file__))
    return (f"import sys\nsys.path.insert(0, {here!r})\n"
            "import torch_cpu_verifier\n"
            "# held for the process's life: a dropped one undoes the swap\n"
            "_ON_THE_CPU = torch_cpu_verifier.cpu_device_verifier()\n"
            "_ON_THE_CPU.__enter__()\n")
