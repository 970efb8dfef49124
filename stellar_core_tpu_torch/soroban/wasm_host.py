"""Wasm ⇄ Soroban host ABI: the production execution seam.

Reference: soroban-env-host exposes host objects to Wasmi-run contracts
as 64-bit handles and a table of host functions (contract.rs:261-340 is
the node-side adapter).  Same shape here: contract code is a real wasm
binary (magic ``\\0asm``); every SCVal crossing the boundary is an i64
handle into a per-invocation object table; host functions live in
import module ``"x"``.  SCVal literals enter wasm via the module's data
section and ``val_from_linear(ptr, len)`` — the contract hands linear-
memory bytes to the host, which decodes the XDR (the mirror of
soroban's bytes_new_from_linear_memory).

Metering: the interpreter's fuel meter drains the invocation Budget at
COST_WASM_INSTRUCTION per executed instruction, reconciled at host-call
boundaries so storage/auth charges interleave in program order; budget
exhaustion surfaces as the same SCE_BUDGET error the scvm path raises.

Handle 0 is always SCV_VOID.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..crypto.sha import sha256
from ..xdr.contract import (ContractDataDurability, ContractDataEntry,
                            SCErrorCode, SCErrorType, SCVal, SCValType)
from ..xdr.ledger_entries import (LedgerEntry, LedgerEntryType, LedgerKey,
                                  _LedgerEntryData, _LedgerEntryExt)
from ..xdr.types import ExtensionPoint
from .host import (BudgetExceeded, HostError,
                   SorobanHost, register_vm)
from .wasm import (HostFunc, I32, I64, Instance, WasmFormatError, WasmTrap,
                   WasmValidationError, decode_module, validate_module)

WASM_MAGIC = b"\x00asm"

# one metered wasm instruction ≈ 1/20 of an scvm expression node
COST_WASM_INSTRUCTION = 5
# flat charge per host call (the scvm interpreter charges one node)

MAX_WASM_ARGS = 16

# decoded+validated module cache (pure function of the code bytes)
_MODULE_CACHE: Dict[bytes, object] = {}
_MODULE_CACHE_MAX = 64


def _load_module(code: bytes):
    h = sha256(code)
    mod = _MODULE_CACHE.get(h)
    if mod is None:
        mod = decode_module(code)
        validate_module(mod)
        if len(_MODULE_CACHE) >= _MODULE_CACHE_MAX:
            _MODULE_CACHE.clear()
        _MODULE_CACHE[h] = mod
    return mod


class _BudgetMeter:
    """Adapts the Soroban Budget to the interpreter's fuel protocol."""

    def __init__(self, budget):
        self.budget = budget

    def flush(self, executed: int) -> int:
        if executed:
            self.budget.charge(executed * COST_WASM_INSTRUCTION)
        remaining = self.budget.limit - self.budget.used
        return max(0, remaining // COST_WASM_INSTRUCTION)


class _Ctx:
    """Per-invocation state shared by the host functions."""

    def __init__(self, host: SorobanHost, contract, args: List[SCVal]):
        self.host = host
        self.contract = contract
        self.args = args
        self.objs: List[SCVal] = [SCVal(SCValType.SCV_VOID)]

    def put(self, v: SCVal) -> int:
        self.objs.append(v)
        return len(self.objs) - 1

    def get(self, h: int) -> SCVal:
        if not 0 <= h < len(self.objs):
            raise HostError(SCErrorType.SCE_VALUE, f"bad handle {h}",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        return self.objs[h]


def _durability(code: int) -> ContractDataDurability:
    return (ContractDataDurability.TEMPORARY if code == 1
            else ContractDataDurability.PERSISTENT)


def _truthy(v: SCVal) -> int:
    if v.disc == SCValType.SCV_BOOL:
        return 1 if v.value else 0
    return 0 if v.disc == SCValType.SCV_VOID else 1


# each entry: name -> (params, results, fn(ctx, instance, *args))
def _host_table(ctx: _Ctx) -> Dict[Tuple[str, str], HostFunc]:
    host = ctx.host

    def charged(fn):
        def wrapper(inst, *a):
            host.budget.charge(host.COST_BASE_INSTRUCTION)
            return fn(inst, *a)
        return wrapper

    def val_from_linear(inst, ptr, ln):
        host.budget.charge(ln)  # per-byte decode charge
        if ptr + ln > len(inst.memory):
            raise WasmTrap("oob", "val_from_linear")
        try:
            v = SCVal.from_bytes(bytes(inst.memory[ptr:ptr + ln]))
        except Exception:
            raise HostError(SCErrorType.SCE_VALUE, "bad SCVal bytes",
                            SCErrorCode.SCEC_INVALID_INPUT)
        return ctx.put(v)

    def obj_arg(inst, i):
        if i >= len(ctx.args):
            raise HostError(SCErrorType.SCE_VALUE, "missing argument",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        return ctx.put(ctx.args[i])

    def storage_get(inst, kh, dur):
        key = ctx.get(kh)
        lk = LedgerKey.contract_data(ctx.contract, key, _durability(dur))
        le = host.load_entry(lk)
        if le is None:
            return 0
        return ctx.put(le.data.value.val)

    def storage_put(inst, kh, vh, dur):
        key = ctx.get(kh)
        val = ctx.get(vh)
        d = _durability(dur)
        lk = LedgerKey.contract_data(ctx.contract, key, d)
        host.put_entry(lk, LedgerEntry(
            lastModifiedLedgerSeq=host.header.ledgerSeq,
            data=_LedgerEntryData(
                LedgerEntryType.CONTRACT_DATA,
                ContractDataEntry(ext=ExtensionPoint(0),
                                  contract=ctx.contract, key=key,
                                  durability=d, val=val)),
            ext=_LedgerEntryExt(0)), durability=d)

    def storage_del(inst, kh, dur):
        key = ctx.get(kh)
        host.erase_entry(LedgerKey.contract_data(
            ctx.contract, key, _durability(dur)))

    def self_address(inst):
        return ctx.put(SCVal(SCValType.SCV_ADDRESS, ctx.contract))

    def ledger_seq(inst):
        return ctx.put(SCVal(SCValType.SCV_U32, host.header.ledgerSeq))

    def require_auth(inst, ah):
        v = ctx.get(ah)
        if v.disc != SCValType.SCV_ADDRESS:
            raise HostError(SCErrorType.SCE_VALUE,
                            "require_auth expects an address")
        host.require_auth(v.value)

    def event(inst, th, dh):
        host.emit_event(bytes(ctx.contract.value),
                        [ctx.get(th)], ctx.get(dh))

    def vec_new(inst):
        return ctx.put(SCVal(SCValType.SCV_VEC, []))

    def vec_push(inst, vh, xh):
        v = ctx.get(vh)
        if v.disc != SCValType.SCV_VEC:
            raise HostError(SCErrorType.SCE_VALUE, "vec_push on non-vec")
        return ctx.put(SCVal(SCValType.SCV_VEC,
                             list(v.value or []) + [ctx.get(xh)]))

    def vec_get(inst, vh, i):
        v = ctx.get(vh)
        if v.disc != SCValType.SCV_VEC or not v.value or i >= len(v.value):
            raise HostError(SCErrorType.SCE_VALUE, "vec_get out of range",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        return ctx.put(v.value[i])

    def vec_len(inst, vh):
        v = ctx.get(vh)
        if v.disc != SCValType.SCV_VEC:
            raise HostError(SCErrorType.SCE_VALUE, "vec_len on non-vec")
        return len(v.value or [])

    def cross_call(inst, th, fh, avh):
        target = ctx.get(th)
        fname = ctx.get(fh)
        argv = ctx.get(avh)
        if target.disc != SCValType.SCV_ADDRESS or \
                fname.disc != SCValType.SCV_SYMBOL:
            raise HostError(SCErrorType.SCE_VALUE, "bad call operands")
        res = host.call_contract(target.value, bytes(fname.value),
                                 list(argv.value or []))
        return ctx.put(res)

    def u64_new(inst, v):
        return ctx.put(SCVal(SCValType.SCV_U64, v))

    def u64_get(inst, h):
        v = ctx.get(h)
        if v.disc not in (SCValType.SCV_U64, SCValType.SCV_U32):
            raise HostError(SCErrorType.SCE_VALUE, "not a u64",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)
        return int(v.value)

    def bool_new(inst, v):
        return ctx.put(SCVal(SCValType.SCV_BOOL, bool(v)))

    def obj_eq(inst, a, b):
        return 1 if ctx.get(a) == ctx.get(b) else 0

    def obj_lt(inst, a, b):
        va, vb = ctx.get(a), ctx.get(b)
        try:
            return 1 if va.value < vb.value else 0
        except TypeError:
            raise HostError(SCErrorType.SCE_VALUE, "incomparable values",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)

    def obj_truthy(inst, h):
        return _truthy(ctx.get(h))

    def fail(inst):
        raise HostError(SCErrorType.SCE_CONTRACT, "contract trap")

    def trap_arith(inst):
        raise HostError(SCErrorType.SCE_VALUE, "u64 overflow",
                        SCErrorCode.SCEC_ARITH_DOMAIN)

    table = {
        "val_from_linear": ([I32, I32], [I64], val_from_linear),
        "arg": ([I64], [I64], obj_arg),
        "get": ([I64, I64], [I64], storage_get),
        "put": ([I64, I64, I64], [], storage_put),
        "del": ([I64, I64], [], storage_del),
        "self": ([], [I64], self_address),
        "ledger_seq": ([], [I64], ledger_seq),
        "require_auth": ([I64], [], require_auth),
        "event": ([I64, I64], [], event),
        "vec_new": ([], [I64], vec_new),
        "vec_push": ([I64, I64], [I64], vec_push),
        "vec_get": ([I64, I64], [I64], vec_get),
        "vec_len": ([I64], [I64], vec_len),
        "call": ([I64, I64, I64], [I64], cross_call),
        "u64_new": ([I64], [I64], u64_new),
        "u64_get": ([I64], [I64], u64_get),
        "bool_new": ([I64], [I64], bool_new),
        "obj_eq": ([I64, I64], [I64], obj_eq),
        "obj_lt": ([I64, I64], [I64], obj_lt),
        "obj_truthy": ([I64], [I64], obj_truthy),
        "fail": ([], [], fail),
        "trap_arith": ([], [], trap_arith),
    }
    return {("x", name): HostFunc(p, r, charged(fn))
            for name, (p, r, fn) in table.items()}


@register_vm(WASM_MAGIC)
def run_wasm(host: SorobanHost, contract, code: bytes, fn: bytes,
             args: List[SCVal]) -> SCVal:
    """Execute exported `fn` of a wasm contract; returns its SCVal.

    Two ABIs share the VM: the real env ABI (single-letter modules,
    tagged i64 Vals — what SDK-built contracts import; see env_abi.py)
    and the bespoke long-name "x" module used by the in-repo scvm_wasm
    compiler. The import table carries both; the module's own imports
    decide which calling convention its exports use."""
    from .env_abi import EnvCtx, env_host_table, is_env_abi_module

    try:
        module = _load_module(code)
    except (WasmFormatError, WasmValidationError) as e:
        raise HostError(SCErrorType.SCE_WASM_VM, f"invalid module: {e}")
    ctx = _Ctx(host, contract, list(args))
    meter = _BudgetMeter(host.budget)
    env_mode = is_env_abi_module(module)

    ectx = EnvCtx(host, contract, ctx.objs)
    if env_mode:
        def charged(f):
            def wrapper(inst, *a):
                host.budget.charge(host.COST_BASE_INSTRUCTION)
                return f(inst, *a)
            return wrapper
        imports = env_host_table(ectx, charged)
    else:
        imports = _host_table(ctx)
    try:
        inst = Instance(module, imports=imports, meter=meter)
        name = fn.decode("utf-8", "replace")
        exp = module.export_map().get(name)
        if exp is None or exp.kind != 0:
            raise HostError(SCErrorType.SCE_CONTEXT,
                            f"no function {fn!r}",
                            SCErrorCode.SCEC_MISSING_VALUE)
        ft = module.func_type(exp.index)
        if env_mode:
            # env ABI: every export parameter/result is a tagged Val
            if len(ft.params) != len(args) or len(args) > MAX_WASM_ARGS:
                raise HostError(SCErrorType.SCE_CONTEXT,
                                "argument count mismatch",
                                SCErrorCode.SCEC_UNEXPECTED_SIZE)
            wargs = [ectx.to_val(a) for a in args]
        elif len(ft.params) == 0:
            wargs = []       # args reached via the `arg` host fn
        elif len(ft.params) == len(args) and len(args) <= MAX_WASM_ARGS:
            wargs = [ctx.put(a) for a in args]
        else:
            raise HostError(SCErrorType.SCE_CONTEXT,
                            "argument count mismatch",
                            SCErrorCode.SCEC_UNEXPECTED_SIZE)
        res = inst.invoke(name, wargs)
    except WasmTrap as t:
        if t.kind == "fuel":
            raise BudgetExceeded()
        raise HostError(SCErrorType.SCE_WASM_VM, str(t))
    if not res:
        return SCVal(SCValType.SCV_VOID)
    return ectx.from_val(res[0]) if env_mode else ctx.get(res[0])
