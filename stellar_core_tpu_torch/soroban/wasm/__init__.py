"""Deterministic metered WebAssembly (MVP integer profile) for the
Soroban execution seam.

Reference: the reference node executes contracts through soroban-env-host's
Wasmi interpreter (src/rust/src/contract.rs:261-340, rust/Cargo.toml:27-56).
This package is a native re-implementation of that role: a wasm binary
decoder (`decode`), a spec-shaped validator (`validate`), and a
budget-metered interpreter (`interp`), plus an in-repo module builder /
assembler (`module.ModuleBuilder`) used by tests and by the scvm→wasm
compiler.

Profile: wasm core MVP restricted to the deterministic integer subset —
i32/i64 values, full control flow, linear memory, tables/call_indirect,
globals, plus the sign-extension operators. Floating point types and
opcodes are rejected at validation, exactly as the reference's host
rejects floats for consensus determinism.
"""

from .module import (I32, I64, FuncType, Module, ModuleBuilder,
                     WasmFormatError)
from .decode import decode_module
from .validate import validate_module, WasmValidationError
from .interp import Instance, WasmTrap, HostFunc

__all__ = [
    "I32", "I64", "FuncType", "Module", "ModuleBuilder",
    "WasmFormatError", "decode_module", "validate_module",
    "WasmValidationError", "Instance", "WasmTrap", "HostFunc",
]
