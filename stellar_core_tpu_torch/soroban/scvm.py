"""Built-in deterministic contract interpreter (the execution seam's
reference implementation).

Contract code = b"SCVM" ‖ XDR(SCVal map: symbol → expression). Each
exported function is one expression tree; expressions are SCVal vecs
whose head is an opcode symbol. Every node charges the budget, so
resource-limit semantics are exercised exactly like a metered wasm VM.

Opcodes:
  (lit v)                    literal
  (arg i)                    i-th invocation argument
  (seq e...)                 evaluate in order, yield last
  (add|sub|mul a b)          u64 arithmetic (traps on over/underflow)
  (eq a b) (lt a b)          comparisons → bool
  (if c t e)                 conditional
  (get k dur) (put k v dur) (del k dur)   contract storage
  (self)                     this contract's address
  (ledger_seq)               current ledger → u32
  (require_auth a)           host auth check
  (event topic data)         emit contract event
  (call c fn a...)           cross-contract call
  (fail)                     trap with a contract error
"""

from __future__ import annotations

from typing import List

from ..xdr.contract import (ContractDataDurability, ContractDataEntry,
                            SCError, SCErrorCode, SCErrorType, SCVal,
                            SCValType)
from ..xdr.ledger_entries import (LedgerEntry, LedgerEntryType, LedgerKey,
                                  _LedgerEntryData, _LedgerEntryExt)
from ..xdr.types import ExtensionPoint
from .host import (COST_BASE_INSTRUCTION, HostError, SorobanHost,
                   register_vm)

SCVM_MAGIC = b"SCVM"

U64_MAX = 2**64 - 1


def make_code(functions: dict) -> bytes:
    """Assemble {name: expression SCVal} into deployable code bytes."""
    entries = [
        {"key": SCVal(SCValType.SCV_SYMBOL, name.encode()
                      if isinstance(name, str) else name),
         "val": expr}
        for name, expr in sorted(functions.items())
    ]
    from ..xdr.contract import SCMapEntry
    m = SCVal(SCValType.SCV_MAP,
              [SCMapEntry(key=e["key"], val=e["val"]) for e in entries])
    return SCVM_MAGIC + m.to_bytes()


def sym(s: str) -> SCVal:
    return SCVal(SCValType.SCV_SYMBOL, s.encode())


def u64(v: int) -> SCVal:
    return SCVal(SCValType.SCV_U64, v)


def op(*parts) -> SCVal:
    return SCVal(SCValType.SCV_VEC, list(parts))


def _durability(v: SCVal) -> ContractDataDurability:
    if v.disc == SCValType.SCV_SYMBOL and bytes(v.value) == b"temp":
        return ContractDataDurability.TEMPORARY
    return ContractDataDurability.PERSISTENT


class _Frame:
    def __init__(self, host: SorobanHost, contract, functions: dict,
                 args: List[SCVal]):
        self.host = host
        self.contract = contract
        self.functions = functions
        self.args = args


def _eval(fr: _Frame, expr: SCVal) -> SCVal:
    host = fr.host
    host.budget.charge(host.COST_BASE_INSTRUCTION)
    if expr.disc != SCValType.SCV_VEC or not expr.value:
        return expr  # self-evaluating
    items = list(expr.value)
    head = items[0]
    if head.disc != SCValType.SCV_SYMBOL:
        return expr
    opname = bytes(head.value)
    a = items[1:]

    if opname == b"lit":
        return a[0]
    if opname == b"arg":
        i = _eval(fr, a[0]).value
        if i >= len(fr.args):
            raise HostError(SCErrorType.SCE_VALUE, "missing argument",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        return fr.args[i]
    if opname == b"seq":
        out = SCVal(SCValType.SCV_VOID)
        for e in a:
            out = _eval(fr, e)
        return out
    if opname in (b"add", b"sub", b"mul"):
        x = _eval(fr, a[0]).value
        y = _eval(fr, a[1]).value
        if opname == b"add":
            r = x + y
        elif opname == b"sub":
            r = x - y
        else:
            r = x * y
        if r < 0 or r > U64_MAX:
            raise HostError(SCErrorType.SCE_VALUE, "u64 overflow",
                            SCErrorCode.SCEC_ARITH_DOMAIN)
        return u64(r)
    if opname == b"eq":
        return SCVal(SCValType.SCV_BOOL,
                     _eval(fr, a[0]) == _eval(fr, a[1]))
    if opname == b"lt":
        return SCVal(SCValType.SCV_BOOL,
                     _eval(fr, a[0]).value < _eval(fr, a[1]).value)
    if opname == b"if":
        cond = _eval(fr, a[0])
        truthy = bool(cond.value) if cond.disc == SCValType.SCV_BOOL \
            else cond.disc != SCValType.SCV_VOID
        return _eval(fr, a[1] if truthy else a[2])
    if opname == b"get":
        key = _eval(fr, a[0])
        dur = _durability(a[1]) if len(a) > 1 else \
            ContractDataDurability.PERSISTENT
        lk = LedgerKey.contract_data(fr.contract, key, dur)
        le = host.load_entry(lk)
        if le is None:
            return SCVal(SCValType.SCV_VOID)
        return le.data.value.val
    if opname == b"put":
        key = _eval(fr, a[0])
        val = _eval(fr, a[1])
        dur = _durability(a[2]) if len(a) > 2 else \
            ContractDataDurability.PERSISTENT
        lk = LedgerKey.contract_data(fr.contract, key, dur)
        host.put_entry(lk, LedgerEntry(
            lastModifiedLedgerSeq=host.header.ledgerSeq,
            data=_LedgerEntryData(
                LedgerEntryType.CONTRACT_DATA,
                ContractDataEntry(ext=ExtensionPoint(0),
                                  contract=fr.contract, key=key,
                                  durability=dur, val=val)),
            ext=_LedgerEntryExt(0)), durability=dur)
        return SCVal(SCValType.SCV_VOID)
    if opname == b"del":
        key = _eval(fr, a[0])
        dur = _durability(a[1]) if len(a) > 1 else \
            ContractDataDurability.PERSISTENT
        host.erase_entry(LedgerKey.contract_data(fr.contract, key, dur))
        return SCVal(SCValType.SCV_VOID)
    if opname == b"self":
        return SCVal(SCValType.SCV_ADDRESS, fr.contract)
    if opname == b"ledger_seq":
        return SCVal(SCValType.SCV_U32, host.header.ledgerSeq)
    if opname == b"require_auth":
        addr = _eval(fr, a[0])
        host.require_auth(addr.value)
        return SCVal(SCValType.SCV_VOID)
    if opname == b"log":
        msg = _eval(fr, a[0])
        if msg.disc not in (SCValType.SCV_SYMBOL, SCValType.SCV_STRING,
                            SCValType.SCV_BYTES):
            raise HostError(SCErrorType.SCE_VALUE,
                            "log expects a bytes-like value")
        host.log_diagnostic(bytes(msg.value), [])
        return SCVal(SCValType.SCV_VOID)
    if opname == b"event":
        topic = _eval(fr, a[0])
        data = _eval(fr, a[1])
        host.emit_event(bytes(fr.contract.value), [topic], data)
        return SCVal(SCValType.SCV_VOID)
    if opname == b"call":
        target = _eval(fr, a[0])
        fname = _eval(fr, a[1])
        call_args = [_eval(fr, x) for x in a[2:]]
        return host.call_contract(target.value, bytes(fname.value),
                                  call_args)
    if opname == b"fail":
        raise HostError(SCErrorType.SCE_CONTRACT, "contract trap")
    raise HostError(SCErrorType.SCE_WASM_VM,
                    f"unknown opcode {opname!r}")


@register_vm(SCVM_MAGIC)
def run_scvm(host: SorobanHost, contract, code: bytes, fn: bytes,
             args: List[SCVal]):
    table = SCVal.from_bytes(code[len(SCVM_MAGIC):])
    functions = {}
    if table.value:
        for me in table.value:
            functions[bytes(me.key.value)] = me.val
    expr = functions.get(fn)
    if expr is None:
        raise HostError(SCErrorType.SCE_CONTEXT,
                        f"no function {fn!r}",
                        SCErrorCode.SCEC_MISSING_VALUE)
    return _eval(_Frame(host, contract, functions, args), expr)
