"""Wasm validation: the core-spec type-checking algorithm (appendix
"Validation Algorithm": value/control stacks with unreachable
polymorphism), restricted to the deterministic integer profile.

Rejections beyond the spec (profile restrictions, mirroring the
reference host's determinism requirements — soroban-env rejects float
code the same way):
  - any float value type or opcode (F32/F64);
  - memory/table limits above hard caps (hostile-module resource guard);
  - multi-value block/function results (MVP arity).
"""

from __future__ import annotations

from typing import List, Optional

from .module import (BLOCK, BLOCK_EMPTY, BR, BR_IF, BR_TABLE, CALL,
                     CALL_INDIRECT, DROP, ELSE, END, F32, F64, FLOAT_OPS,
                     FuncType, GLOBAL_GET, GLOBAL_SET, I32, I32_CONST,
                     I32_EQZ, I32_EXTEND8_S, I32_EXTEND16_S, I32_WRAP_I64,
                     I32_ARITH, I32_CMP, I64, I64_CONST, I64_EQZ,
                     I64_EXTEND_I32_S, I64_EXTEND_I32_U, I64_EXTEND8_S,
                     I64_EXTEND16_S, I64_EXTEND32_S, I64_ARITH, I64_CMP,
                     IF, LOCAL_GET, LOCAL_SET, LOCAL_TEE, LOOP,
                     DATA_DROP, MEMORY_COPY, MEMORY_FILL, MEMORY_INIT,
                     MEMORY_GROW, MEMORY_SIZE, Module, NOP, RETURN,
                     SELECT, UNREACHABLE,
                     I32_LOAD, I64_LOAD, I32_LOAD8_S, I32_LOAD8_U,
                     I32_LOAD16_S, I32_LOAD16_U, I64_LOAD8_S, I64_LOAD8_U,
                     I64_LOAD16_S, I64_LOAD16_U, I64_LOAD32_S,
                     I64_LOAD32_U, I32_STORE, I64_STORE, I32_STORE8,
                     I32_STORE16, I64_STORE8, I64_STORE16, I64_STORE32)

MAX_MEMORY_PAGES = 64          # 4 MiB — contract-scale cap
MAX_TABLE_SIZE = 4096
MAX_CALL_PARAMS = 32

UNKNOWN = 0  # bottom type for unreachable polymorphism


class WasmValidationError(Exception):
    pass


_LOADS = {
    I32_LOAD: (I32, 4), I64_LOAD: (I64, 8),
    I32_LOAD8_S: (I32, 1), I32_LOAD8_U: (I32, 1),
    I32_LOAD16_S: (I32, 2), I32_LOAD16_U: (I32, 2),
    I64_LOAD8_S: (I64, 1), I64_LOAD8_U: (I64, 1),
    I64_LOAD16_S: (I64, 2), I64_LOAD16_U: (I64, 2),
    I64_LOAD32_S: (I64, 4), I64_LOAD32_U: (I64, 4),
}
_STORES = {
    I32_STORE: (I32, 4), I64_STORE: (I64, 8),
    I32_STORE8: (I32, 1), I32_STORE16: (I32, 2),
    I64_STORE8: (I64, 1), I64_STORE16: (I64, 2), I64_STORE32: (I64, 4),
}


class _Ctrl:
    __slots__ = ("opcode", "start_types", "end_types", "height",
                 "unreachable")

    def __init__(self, opcode, start_types, end_types, height):
        self.opcode = opcode
        self.start_types = start_types
        self.end_types = end_types
        self.height = height
        self.unreachable = False


class _Checker:
    def __init__(self, module: Module, func_type: FuncType,
                 locals_: List[int]):
        self.m = module
        self.ft = func_type
        self.locals = list(func_type.params) + list(locals_)
        self.vals: List[int] = []
        self.ctrls: List[_Ctrl] = []

    # --- stack ops (spec algorithm) --------------------------------------
    def push(self, t: int):
        self.vals.append(t)

    def pop(self, expect: Optional[int] = None) -> int:
        frame = self.ctrls[-1]
        if len(self.vals) == frame.height:
            if frame.unreachable:
                return expect if expect is not None else UNKNOWN
            raise WasmValidationError("value stack underflow")
        t = self.vals.pop()
        if expect is not None and t != UNKNOWN and t != expect:
            raise WasmValidationError(
                f"type mismatch: expected {expect:#x} got {t:#x}")
        return t

    def push_ctrl(self, opcode: int, start, end):
        self.ctrls.append(_Ctrl(opcode, start, end, len(self.vals)))
        for t in start:
            self.push(t)

    def pop_ctrl(self) -> _Ctrl:
        if not self.ctrls:
            raise WasmValidationError("control stack underflow")
        frame = self.ctrls[-1]
        for t in reversed(frame.end_types):
            self.pop(t)
        if len(self.vals) != frame.height:
            raise WasmValidationError("values left on stack at block end")
        self.ctrls.pop()
        return frame

    def label_types(self, frame: _Ctrl):
        return frame.start_types if frame.opcode == LOOP else frame.end_types

    def unreachable_(self):
        frame = self.ctrls[-1]
        del self.vals[frame.height:]
        frame.unreachable = True

    # --- block types ------------------------------------------------------
    def blocktype(self, bt) -> FuncType:
        if bt == BLOCK_EMPTY:
            return FuncType([], [])
        if bt in (I32, I64):
            return FuncType([], [bt])
        if bt in (F32, F64):
            raise WasmValidationError("float block type")
        if not isinstance(bt, int) or bt >= len(self.m.types):
            raise WasmValidationError("bad block type index")
        ft = self.m.types[bt]
        if ft.params:
            # MVP arity: blocks take no parameters (the interpreter's
            # label-height model assumes it; multi-value is post-MVP)
            raise WasmValidationError("block parameters not supported")
        return ft

    # --- main loop --------------------------------------------------------
    def check(self, instrs) -> None:
        self.push_ctrl(BLOCK, [], list(self.ft.results))
        for op, imm in instrs:
            self.instr(op, imm)
        if self.ctrls:
            raise WasmValidationError("unterminated control structure")

    def instr(self, op: int, imm) -> None:
        if op in FLOAT_OPS:
            raise WasmValidationError(
                f"float opcode 0x{op:02x} rejected (deterministic profile)")
        if op == UNREACHABLE:
            self.unreachable_()
        elif op == NOP:
            pass
        elif op in (BLOCK, LOOP):
            ft = self.blocktype(imm)
            for t in reversed(ft.params):
                self.pop(t)
            self.push_ctrl(op, list(ft.params), list(ft.results))
        elif op == IF:
            ft = self.blocktype(imm)
            self.pop(I32)
            for t in reversed(ft.params):
                self.pop(t)
            self.push_ctrl(IF, list(ft.params), list(ft.results))
        elif op == ELSE:
            frame = self.pop_ctrl()
            if frame.opcode != IF:
                raise WasmValidationError("else without if")
            self.push_ctrl(ELSE, frame.start_types, frame.end_types)
        elif op == END:
            frame = self.pop_ctrl()
            if frame.opcode == IF and frame.start_types != frame.end_types:
                raise WasmValidationError(
                    "if without else must have matching param/result types")
            for t in frame.end_types:
                self.push(t)
        elif op == BR:
            frame = self._label(imm)
            for t in reversed(self.label_types(frame)):
                self.pop(t)
            self.unreachable_()
        elif op == BR_IF:
            frame = self._label(imm)
            self.pop(I32)
            lts = self.label_types(frame)
            for t in reversed(lts):
                self.pop(t)
            for t in lts:
                self.push(t)
        elif op == BR_TABLE:
            targets, default = imm
            self.pop(I32)
            dts = self.label_types(self._label(default))
            for d in targets:
                ts = self.label_types(self._label(d))
                if len(ts) != len(dts):
                    raise WasmValidationError("br_table arity mismatch")
            for t in reversed(dts):
                self.pop(t)
            self.unreachable_()
        elif op == RETURN:
            for t in reversed(self.ft.results):
                self.pop(t)
            self.unreachable_()
        elif op == CALL:
            nfuncs = self.m.num_imported_funcs() + len(self.m.funcs)
            if imm >= nfuncs:
                raise WasmValidationError(f"call to unknown function {imm}")
            ft = self.m.func_type(imm)
            for t in reversed(ft.params):
                self.pop(t)
            for t in ft.results:
                self.push(t)
        elif op == CALL_INDIRECT:
            if self.m.table_limits is None:
                raise WasmValidationError("call_indirect without a table")
            if imm >= len(self.m.types):
                raise WasmValidationError("call_indirect: bad type index")
            ft = self.m.types[imm]
            self.pop(I32)
            for t in reversed(ft.params):
                self.pop(t)
            for t in ft.results:
                self.push(t)
        elif op == DROP:
            self.pop()
        elif op == SELECT:
            self.pop(I32)
            t1 = self.pop()
            t2 = self.pop()
            if t1 != UNKNOWN and t2 != UNKNOWN and t1 != t2:
                raise WasmValidationError("select operand type mismatch")
            self.push(t1 if t1 != UNKNOWN else t2)
        elif op in (LOCAL_GET, LOCAL_SET, LOCAL_TEE):
            if imm >= len(self.locals):
                raise WasmValidationError(f"unknown local {imm}")
            t = self.locals[imm]
            if op == LOCAL_GET:
                self.push(t)
            elif op == LOCAL_SET:
                self.pop(t)
            else:
                self.pop(t)
                self.push(t)
        elif op in (GLOBAL_GET, GLOBAL_SET):
            g = self._global(imm)
            if op == GLOBAL_GET:
                self.push(g[0])
            else:
                if not g[1]:
                    raise WasmValidationError(
                        f"global {imm} is immutable")
                self.pop(g[0])
        elif op in _LOADS:
            self._need_memory()
            t, width = _LOADS[op]
            self._check_align(imm, width)
            self.pop(I32)
            self.push(t)
        elif op in _STORES:
            self._need_memory()
            t, width = _STORES[op]
            self._check_align(imm, width)
            self.pop(t)
            self.pop(I32)
        elif op == MEMORY_SIZE:
            self._need_memory()
            self.push(I32)
        elif op == MEMORY_GROW:
            self._need_memory()
            self.pop(I32)
            self.push(I32)
        elif op == I32_CONST:
            self.push(I32)
        elif op == I64_CONST:
            self.push(I64)
        elif op == I32_EQZ:
            self.pop(I32)
            self.push(I32)
        elif op == I64_EQZ:
            self.pop(I64)
            self.push(I32)
        elif op in I32_CMP:
            self.pop(I32)
            self.pop(I32)
            self.push(I32)
        elif op in I64_CMP:
            self.pop(I64)
            self.pop(I64)
            self.push(I32)
        elif op in I32_ARITH:
            if op in range(0x67, 0x6A):          # clz/ctz/popcnt: unary
                self.pop(I32)
            else:
                self.pop(I32)
                self.pop(I32)
            self.push(I32)
        elif op in I64_ARITH:
            if op in range(0x79, 0x7C):
                self.pop(I64)
            else:
                self.pop(I64)
                self.pop(I64)
            self.push(I64)
        elif op == I32_WRAP_I64:
            self.pop(I64)
            self.push(I32)
        elif op in (I64_EXTEND_I32_S, I64_EXTEND_I32_U):
            self.pop(I32)
            self.push(I64)
        elif op in (I32_EXTEND8_S, I32_EXTEND16_S):
            self.pop(I32)
            self.push(I32)
        elif op in (I64_EXTEND8_S, I64_EXTEND16_S, I64_EXTEND32_S):
            self.pop(I64)
            self.push(I64)
        elif op in (MEMORY_COPY, MEMORY_FILL):
            self._need_memory()
            self.pop(I32)
            self.pop(I32)
            self.pop(I32)
        elif op in (MEMORY_INIT, DATA_DROP):
            # spec: these require the data-count section so single-pass
            # validators can bound the data index space
            if self.m.data_count is None:
                raise WasmValidationError(
                    "memory.init/data.drop without data count section")
            if imm >= self.m.data_count:
                raise WasmValidationError(
                    f"data segment index {imm} out of range")
            if op == MEMORY_INIT:
                self._need_memory()
                self.pop(I32)
                self.pop(I32)
                self.pop(I32)
        else:
            raise WasmValidationError(f"unsupported opcode 0x{op:02x}")

    def _label(self, depth: int) -> _Ctrl:
        if depth >= len(self.ctrls):
            raise WasmValidationError(f"branch depth {depth} out of range")
        return self.ctrls[-1 - depth]

    def _global(self, idx: int):
        gi = [im.desc for im in self.m.imports if im.kind == 3]
        n_imported = len(gi)
        if idx < n_imported:
            return gi[idx]
        idx -= n_imported
        if idx >= len(self.m.globals):
            raise WasmValidationError("unknown global")
        g = self.m.globals[idx]
        return (g.valtype, g.mutable)

    def _need_memory(self):
        has_mem = self.m.mem_limits is not None or any(
            im.kind == 2 for im in self.m.imports)
        if not has_mem:
            raise WasmValidationError("memory instruction without memory")

    @staticmethod
    def _check_align(memarg, width: int):
        align, _offset = memarg
        # compare exponents — never materialize 1 << attacker_align
        if align > width.bit_length() - 1:
            raise WasmValidationError("alignment larger than natural")


def validate_module(m: Module) -> None:
    """Whole-module validation; raises WasmValidationError."""
    # types: reject floats anywhere
    for ft in m.types:
        for t in list(ft.params) + list(ft.results):
            if t in (F32, F64):
                raise WasmValidationError(
                    "float value type rejected (deterministic profile)")
        if len(ft.results) > 1:
            raise WasmValidationError("multi-value results not supported")
        if len(ft.params) > MAX_CALL_PARAMS:
            raise WasmValidationError("too many parameters")
    for im in m.imports:
        if im.kind == 0 and im.desc >= len(m.types):
            raise WasmValidationError("import type index out of range")
        if im.kind == 3 and im.desc[0] in (F32, F64):
            raise WasmValidationError("float global rejected")
    for t in m.funcs:
        if t >= len(m.types):
            raise WasmValidationError("function type index out of range")
    if len(m.codes) != len(m.funcs):
        raise WasmValidationError("code/function section size mismatch")
    if m.mem_limits is not None:
        mn, mx = m.mem_limits
        if mn > MAX_MEMORY_PAGES or (mx or 0) > MAX_MEMORY_PAGES:
            raise WasmValidationError(
                f"memory limits exceed cap of {MAX_MEMORY_PAGES} pages")
    if m.table_limits is not None:
        mn, mx = m.table_limits
        if mn > MAX_TABLE_SIZE or (mx or 0) > MAX_TABLE_SIZE:
            raise WasmValidationError("table limits exceed cap")
    for g in m.globals:
        if g.valtype in (F32, F64):
            raise WasmValidationError("float global rejected")
    nfuncs = m.num_imported_funcs() + len(m.funcs)
    for e in m.exports:
        if e.kind == 0 and e.index >= nfuncs:
            raise WasmValidationError(f"export {e.name!r}: bad func index")
        if e.kind == 2 and m.mem_limits is None and not any(
                im.kind == 2 for im in m.imports):
            raise WasmValidationError("export of missing memory")
        if e.kind == 3 and e.index >= len(m.globals) + sum(
                1 for im in m.imports if im.kind == 3):
            raise WasmValidationError("export of missing global")
    if m.start is not None:
        if m.start >= nfuncs:
            raise WasmValidationError("start function index out of range")
        ft = m.func_type(m.start)
        if ft.params or ft.results:
            raise WasmValidationError("start function must be [] -> []")
    for _off, idxs in m.elements:
        if m.table_limits is None:
            raise WasmValidationError("element segment without table")
        for i in idxs:
            if i >= nfuncs:
                raise WasmValidationError("element func index out of range")
    if any(off is not None for off, _ in m.data) \
            and m.mem_limits is None and not any(
            im.kind == 2 for im in m.imports):
        raise WasmValidationError("data segment without memory")
    # function bodies
    for i, code in enumerate(m.codes):
        for vt in code.locals:
            if vt in (F32, F64):
                raise WasmValidationError("float local rejected")
        ft = m.types[m.funcs[i]]
        _Checker(m, ft, code.locals).check(code.instrs)
