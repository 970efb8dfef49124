"""Smart-contract host layer (reference: src/rust + the Soroban parts of
src/transactions; SURVEY.md §7 step 8). Importing registers the contract
operation frames and the built-in SCVM interpreter."""

from . import ops as _ops        # noqa: F401 — registers op frames
from . import scvm as _scvm      # noqa: F401 — registers the builtin VM
from . import wasm_host as _wasm  # noqa: F401 — registers the wasm VM
from .fees import (compute_rent_fee, compute_transaction_resource_fee,
                   compute_write_fee_per_1kb)
from .host import Budget, HostError, SorobanHost, register_vm
from .network_config import (SorobanNetworkConfig, create_initial_settings)

__all__ = ["SorobanHost", "Budget", "HostError", "register_vm",
           "SorobanNetworkConfig", "create_initial_settings",
           "compute_transaction_resource_fee", "compute_rent_fee",
           "compute_write_fee_per_1kb"]
