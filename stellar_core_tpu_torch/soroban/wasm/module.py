"""Wasm module model, binary encoder, and builder (the in-repo assembler).

The binary format implemented here is the WebAssembly core spec's (magic
``\\0asm`` + version 1, LEB128-coded sections).  `ModuleBuilder` is how
this repo authors wasm: tests and the scvm→wasm compiler construct
modules through it and `encode()` emits a spec-conformant binary that
`decode.decode_module` (and any other wasm engine) can load.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple


class WasmFormatError(Exception):
    """Malformed wasm binary (decode-time)."""


# value types (spec byte encodings)
I32 = 0x7F
I64 = 0x7E
F32 = 0x7D   # recognised for rejection
F64 = 0x7C
FUNCREF = 0x70
VALTYPE_NAMES = {I32: "i32", I64: "i64", F32: "f32", F64: "f64"}

# block type sentinel
BLOCK_EMPTY = 0x40

PAGE_SIZE = 65536


def leb_u(n: int) -> bytes:
    """Unsigned LEB128."""
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def leb_s(n: int) -> bytes:
    """Signed LEB128."""
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        done = (n == 0 and not (b & 0x40)) or (n == -1 and (b & 0x40))
        if done:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


class FuncType:
    __slots__ = ("params", "results")

    def __init__(self, params: List[int], results: List[int]):
        self.params = list(params)
        self.results = list(results)

    def __eq__(self, other):
        return (isinstance(other, FuncType)
                and self.params == other.params
                and self.results == other.results)

    def __hash__(self):
        return hash((tuple(self.params), tuple(self.results)))

    def __repr__(self):
        p = ",".join(VALTYPE_NAMES.get(t, hex(t)) for t in self.params)
        r = ",".join(VALTYPE_NAMES.get(t, hex(t)) for t in self.results)
        return f"({p})->({r})"


class Import:
    __slots__ = ("module", "name", "kind", "desc")

    def __init__(self, module: str, name: str, kind: int, desc):
        self.module = module
        self.name = name
        self.kind = kind      # 0 func, 1 table, 2 mem, 3 global
        self.desc = desc      # func: typeidx; mem/table: limits; global: (vt, mut)


class Export:
    __slots__ = ("name", "kind", "index")

    def __init__(self, name: str, kind: int, index: int):
        self.name = name
        self.kind = kind
        self.index = index


class Global:
    __slots__ = ("valtype", "mutable", "init")

    def __init__(self, valtype: int, mutable: bool, init: int):
        self.valtype = valtype
        self.mutable = mutable
        self.init = init      # constant initial value (int)


class Code:
    """One function body: declared locals + decoded instruction list.

    `instrs` is a flat list of (opcode:int, imm) tuples produced by the
    decoder or builder; structured control (block/loop/if/else/end) stays
    inline, with branch targets resolved once into `jumps` (lazily, by
    the first Instance) and cached here — modules are cached per code
    hash, so hot contracts never re-scan their bodies.
    """
    __slots__ = ("locals", "instrs", "jumps")

    def __init__(self, locals_: List[int], instrs: List[Tuple[int, object]]):
        self.locals = list(locals_)
        self.instrs = instrs
        self.jumps = None


class Module:
    def __init__(self):
        self.types: List[FuncType] = []
        self.imports: List[Import] = []
        self.funcs: List[int] = []          # typeidx per local function
        self.table_limits: Optional[Tuple[int, Optional[int]]] = None
        self.mem_limits: Optional[Tuple[int, Optional[int]]] = None
        self.globals: List[Global] = []
        self.exports: List[Export] = []
        self.start: Optional[int] = None
        self.elements: List[Tuple[int, List[int]]] = []  # (offset, funcidxs)
        self.codes: List[Code] = []
        # (offset, bytes) for active segments; (None, bytes) for passive
        # (bulk-memory) segments consumed by memory.init / data.drop
        self.data: List[Tuple[Optional[int], bytes]] = []
        self.data_count: Optional[int] = None            # section 12

    # --- derived index spaces (imports come first, per spec) -----------------
    def imported_funcs(self) -> List[Import]:
        return [im for im in self.imports if im.kind == 0]

    def num_imported_funcs(self) -> int:
        return sum(1 for im in self.imports if im.kind == 0)

    def func_type(self, funcidx: int) -> FuncType:
        nimp = self.num_imported_funcs()
        if funcidx < nimp:
            return self.types[self.imported_funcs()[funcidx].desc]
        return self.types[self.funcs[funcidx - nimp]]

    def export_map(self) -> Dict[str, Export]:
        return {e.name: e for e in self.exports}


# --------------------------------------------------------------------------
# opcodes (shared with decode/interp)
# --------------------------------------------------------------------------
UNREACHABLE, NOP = 0x00, 0x01
BLOCK, LOOP, IF, ELSE = 0x02, 0x03, 0x04, 0x05
END = 0x0B
BR, BR_IF, BR_TABLE, RETURN = 0x0C, 0x0D, 0x0E, 0x0F
CALL, CALL_INDIRECT = 0x10, 0x11
DROP, SELECT = 0x1A, 0x1B
LOCAL_GET, LOCAL_SET, LOCAL_TEE = 0x20, 0x21, 0x22
GLOBAL_GET, GLOBAL_SET = 0x23, 0x24
I32_LOAD, I64_LOAD = 0x28, 0x29
F32_LOAD, F64_LOAD = 0x2A, 0x2B
I32_LOAD8_S, I32_LOAD8_U, I32_LOAD16_S, I32_LOAD16_U = 0x2C, 0x2D, 0x2E, 0x2F
I64_LOAD8_S, I64_LOAD8_U, I64_LOAD16_S, I64_LOAD16_U = 0x30, 0x31, 0x32, 0x33
I64_LOAD32_S, I64_LOAD32_U = 0x34, 0x35
I32_STORE, I64_STORE = 0x36, 0x37
F32_STORE, F64_STORE = 0x38, 0x39
I32_STORE8, I32_STORE16 = 0x3A, 0x3B
I64_STORE8, I64_STORE16, I64_STORE32 = 0x3C, 0x3D, 0x3E
MEMORY_SIZE, MEMORY_GROW = 0x3F, 0x40
I32_CONST, I64_CONST, F32_CONST, F64_CONST = 0x41, 0x42, 0x43, 0x44
I32_EQZ = 0x45
I64_EQZ = 0x50
I32_WRAP_I64 = 0xA7
I64_EXTEND_I32_S, I64_EXTEND_I32_U = 0xAC, 0xAD
I32_EXTEND8_S, I32_EXTEND16_S = 0xC0, 0xC1
I64_EXTEND8_S, I64_EXTEND16_S, I64_EXTEND32_S = 0xC2, 0xC3, 0xC4

# ranges
I32_CMP = range(0x46, 0x50)      # eq..ge_u
I64_CMP = range(0x51, 0x5B)
FLOAT_CMP = range(0x5B, 0x67)
I32_ARITH = range(0x67, 0x79)    # clz..rotr
I64_ARITH = range(0x79, 0x8B)
FLOAT_ARITH = range(0x8B, 0xA7)
FLOAT_CONV = list(range(0xA8, 0xAC)) + list(range(0xAE, 0xC0))

MEMARG_OPS = set(range(I32_LOAD, MEMORY_SIZE))

# bulk-memory proposal (0xFC-prefixed): decoded to synthetic opcodes
# 0xFC00 | sub so the flat (op, imm) instruction form stays uniform.
# Subs 0-7 are the saturating float→int truncations — float ops, so the
# validator rejects them under the deterministic profile exactly like
# every other float opcode (soroban-env's wasmi config does the same).
FC_PREFIX = 0xFC
TRUNC_SAT_OPS = set(range(0xFC00, 0xFC08))
MEMORY_INIT, DATA_DROP = 0xFC08, 0xFC09
MEMORY_COPY, MEMORY_FILL = 0xFC0A, 0xFC0B

FLOAT_OPS = ({F32_LOAD, F64_LOAD, F32_STORE, F64_STORE, F32_CONST,
              F64_CONST}
             | set(FLOAT_CMP) | set(FLOAT_ARITH) | set(FLOAT_CONV)
             | TRUNC_SAT_OPS)


# --------------------------------------------------------------------------
# builder / assembler
# --------------------------------------------------------------------------
class FuncBuilder:
    """Writes one function body as decoded-form instrs (kept symbolic so
    the encoder and direct `Module` consumers share one representation)."""

    def __init__(self, builder: "ModuleBuilder", typeidx: int,
                 locals_: List[int]):
        self.builder = builder
        self.typeidx = typeidx
        self.locals = list(locals_)
        self.instrs: List[Tuple[int, object]] = []

    # raw emit
    def op(self, opcode: int, imm=None) -> "FuncBuilder":
        self.instrs.append((opcode, imm))
        return self

    # ---- convenience mnemonics (the assembler surface) ----
    def i32_const(self, v: int): return self.op(I32_CONST, v)
    def i64_const(self, v: int): return self.op(I64_CONST, v)
    def local_get(self, i: int): return self.op(LOCAL_GET, i)
    def local_set(self, i: int): return self.op(LOCAL_SET, i)
    def local_tee(self, i: int): return self.op(LOCAL_TEE, i)
    def global_get(self, i: int): return self.op(GLOBAL_GET, i)
    def global_set(self, i: int): return self.op(GLOBAL_SET, i)
    def call(self, f: int): return self.op(CALL, f)

    def call_indirect(self, typeidx: int):
        return self.op(CALL_INDIRECT, typeidx)

    def block(self, bt: int = BLOCK_EMPTY): return self.op(BLOCK, bt)
    def loop(self, bt: int = BLOCK_EMPTY): return self.op(LOOP, bt)
    def if_(self, bt: int = BLOCK_EMPTY): return self.op(IF, bt)
    def else_(self): return self.op(ELSE)
    def end(self): return self.op(END)
    def br(self, d: int): return self.op(BR, d)
    def br_if(self, d: int): return self.op(BR_IF, d)

    def br_table(self, targets: List[int], default: int):
        return self.op(BR_TABLE, (list(targets), default))

    def ret(self): return self.op(RETURN)
    def drop(self): return self.op(DROP)
    def select(self): return self.op(SELECT)
    def unreachable(self): return self.op(UNREACHABLE)
    def nop(self): return self.op(NOP)

    def load(self, opcode: int, offset: int = 0, align: int = 0):
        return self.op(opcode, (align, offset))

    def store(self, opcode: int, offset: int = 0, align: int = 0):
        return self.op(opcode, (align, offset))

    def memory_size(self): return self.op(MEMORY_SIZE, 0)
    def memory_grow(self): return self.op(MEMORY_GROW, 0)

    # bulk-memory (0xFC-prefixed)
    def memory_copy(self): return self.op(MEMORY_COPY)
    def memory_fill(self): return self.op(MEMORY_FILL)
    def memory_init(self, dataidx: int): return self.op(MEMORY_INIT, dataidx)
    def data_drop(self, dataidx: int): return self.op(DATA_DROP, dataidx)


class ModuleBuilder:
    """Authoring API: declare imports/memories/tables/globals/functions,
    then `build()` → Module or `encode()` → binary bytes."""

    def __init__(self):
        self.module = Module()
        self._type_idx: Dict[FuncType, int] = {}
        self._funcs: List[FuncBuilder] = []
        self._imports_closed = False

    def functype(self, params: List[int], results: List[int]) -> int:
        ft = FuncType(params, results)
        if ft in self._type_idx:
            return self._type_idx[ft]
        self.module.types.append(ft)
        self._type_idx[ft] = len(self.module.types) - 1
        return self._type_idx[ft]

    def import_func(self, module: str, name: str, params: List[int],
                    results: List[int]) -> int:
        assert not self._imports_closed, \
            "all imports must be declared before local functions"
        t = self.functype(params, results)
        self.module.imports.append(Import(module, name, 0, t))
        return self.module.num_imported_funcs() - 1

    def add_memory(self, min_pages: int, max_pages: Optional[int] = None):
        self.module.mem_limits = (min_pages, max_pages)

    def add_table(self, min_sz: int, max_sz: Optional[int] = None):
        self.module.table_limits = (min_sz, max_sz)

    def add_global(self, valtype: int, mutable: bool, init: int) -> int:
        self.module.globals.append(Global(valtype, mutable, init))
        return len(self.module.globals) - 1

    def add_func(self, params: List[int], results: List[int],
                 locals_: Optional[List[int]] = None) -> Tuple[int, FuncBuilder]:
        """Returns (funcidx, body writer)."""
        self._imports_closed = True
        t = self.functype(params, results)
        fb = FuncBuilder(self, t, locals_ or [])
        self._funcs.append(fb)
        funcidx = self.module.num_imported_funcs() + len(self._funcs) - 1
        return funcidx, fb

    def export_func(self, name: str, funcidx: int):
        self.module.exports.append(Export(name, 0, funcidx))

    def export_memory(self, name: str):
        self.module.exports.append(Export(name, 2, 0))

    def set_start(self, funcidx: int):
        self.module.start = funcidx

    def add_element(self, offset: int, funcidxs: List[int]):
        self.module.elements.append((offset, list(funcidxs)))

    def add_data(self, offset: int, payload: bytes):
        self.module.data.append((offset, bytes(payload)))

    def add_passive_data(self, payload: bytes) -> int:
        """Bulk-memory passive segment; returns its data index for
        memory.init / data.drop."""
        self.module.data.append((None, bytes(payload)))
        self.module.data_count = len(self.module.data)
        return len(self.module.data) - 1

    def data_segment(self, payload: bytes) -> Tuple[int, int]:
        """Append `payload` after existing segments; returns (offset, len)."""
        off = 8
        for o, b in self.module.data:
            off = max(off, o + len(b))
        self.module.data.append((off, bytes(payload)))
        return off, len(payload)

    def require_data_count(self) -> None:
        """Emit a data-count section even with only active segments —
        needed when memory.init/data.drop reference them (spec allows
        it; such segments count as dropped after instantiation)."""
        self.module.data_count = len(self.module.data)

    def build(self) -> Module:
        m = self.module
        if m.data_count is not None or \
                any(off is None for off, _ in m.data):
            m.data_count = len(m.data)
        m.funcs = [fb.typeidx for fb in self._funcs]
        m.codes = []
        for fb in self._funcs:
            # the function-terminating END is always implicit: bodies
            # author only their own block-closing `end()`s
            instrs = list(fb.instrs) + [(END, None)]
            m.codes.append(Code(fb.locals, instrs))
        return m

    def encode(self) -> bytes:
        return encode_module(self.build())


# --------------------------------------------------------------------------
# binary encoder
# --------------------------------------------------------------------------
def _enc_name(s: str) -> bytes:
    b = s.encode("utf-8")
    return leb_u(len(b)) + b


def _enc_limits(limits: Tuple[int, Optional[int]]) -> bytes:
    mn, mx = limits
    if mx is None:
        return b"\x00" + leb_u(mn)
    return b"\x01" + leb_u(mn) + leb_u(mx)


def _enc_instr(opcode: int, imm) -> bytes:
    if opcode >= 0xFC00:        # bulk-memory: 0xFC prefix + sub-opcode
        out = bytearray([FC_PREFIX]) + leb_u(opcode & 0xFF)
        if opcode == MEMORY_INIT:
            out += leb_u(imm) + b"\x00"
        elif opcode == DATA_DROP:
            out += leb_u(imm)
        elif opcode == MEMORY_COPY:
            out += b"\x00\x00"
        elif opcode == MEMORY_FILL:
            out += b"\x00"
        return bytes(out)
    out = bytearray([opcode])
    if opcode in (BLOCK, LOOP, IF):
        if imm == BLOCK_EMPTY or imm in (I32, I64, F32, F64):
            out.append(imm)
        else:
            out += leb_s(imm)          # type-index form (s33)
    elif opcode in (BR, BR_IF, CALL, LOCAL_GET, LOCAL_SET, LOCAL_TEE,
                    GLOBAL_GET, GLOBAL_SET):
        out += leb_u(imm)
    elif opcode == CALL_INDIRECT:
        out += leb_u(imm) + b"\x00"    # typeidx + table 0
    elif opcode == BR_TABLE:
        targets, default = imm
        out += leb_u(len(targets))
        for t in targets:
            out += leb_u(t)
        out += leb_u(default)
    elif opcode in MEMARG_OPS:
        align, offset = imm
        out += leb_u(align) + leb_u(offset)
    elif opcode in (MEMORY_SIZE, MEMORY_GROW):
        out.append(0x00)
    elif opcode == I32_CONST:
        v = imm & 0xFFFFFFFF
        if v >= 1 << 31:
            v -= 1 << 32
        out += leb_s(v)
    elif opcode == I64_CONST:
        v = imm & 0xFFFFFFFFFFFFFFFF
        if v >= 1 << 63:
            v -= 1 << 64
        out += leb_s(v)
    elif opcode in (F32_CONST, F64_CONST):
        out += bytes(imm)       # raw IEEE bytes (only used by tests that
    return bytes(out)           # prove the validator rejects floats)


def _section(sid: int, payload: bytes) -> bytes:
    return bytes([sid]) + leb_u(len(payload)) + payload


def _vec(items: List[bytes]) -> bytes:
    return leb_u(len(items)) + b"".join(items)


def encode_module(m: Module) -> bytes:
    out = bytearray(b"\x00asm\x01\x00\x00\x00")
    if m.types:
        out += _section(1, _vec([
            b"\x60" + _vec([bytes([t]) for t in ft.params])
            + _vec([bytes([t]) for t in ft.results]) for ft in m.types]))
    if m.imports:
        items = []
        for im in m.imports:
            d = _enc_name(im.module) + _enc_name(im.name) + bytes([im.kind])
            if im.kind == 0:
                d += leb_u(im.desc)
            elif im.kind == 2:
                d += _enc_limits(im.desc)
            elif im.kind == 1:
                d += bytes([FUNCREF]) + _enc_limits(im.desc)
            else:
                vt, mut = im.desc
                d += bytes([vt, 1 if mut else 0])
            items.append(d)
        out += _section(2, _vec(items))
    if m.funcs:
        out += _section(3, _vec([leb_u(t) for t in m.funcs]))
    if m.table_limits is not None:
        out += _section(4, _vec([bytes([FUNCREF])
                                 + _enc_limits(m.table_limits)]))
    if m.mem_limits is not None:
        out += _section(5, _vec([_enc_limits(m.mem_limits)]))
    if m.globals:
        items = []
        for g in m.globals:
            const_op = I32_CONST if g.valtype == I32 else I64_CONST
            items.append(bytes([g.valtype, 1 if g.mutable else 0])
                         + _enc_instr(const_op, g.init) + bytes([END]))
        out += _section(6, _vec(items))
    if m.exports:
        out += _section(7, _vec([
            _enc_name(e.name) + bytes([e.kind]) + leb_u(e.index)
            for e in m.exports]))
    if m.start is not None:
        out += _section(8, leb_u(m.start))
    if m.elements:
        items = []
        for off, idxs in m.elements:
            items.append(b"\x00" + _enc_instr(I32_CONST, off) + bytes([END])
                         + _vec([leb_u(i) for i in idxs]))
        out += _section(9, _vec(items))
    if m.data_count is not None or any(off is None for off, _ in m.data):
        out += _section(12, leb_u(len(m.data)))
    if m.codes:
        items = []
        for code in m.codes:
            # compress locals run-length by type, per spec
            runs: List[Tuple[int, int]] = []
            for vt in code.locals:
                if runs and runs[-1][1] == vt:
                    runs[-1] = (runs[-1][0] + 1, vt)
                else:
                    runs.append((1, vt))
            body = _vec([leb_u(n) + bytes([vt]) for n, vt in runs])
            for op_, imm in code.instrs:
                body += _enc_instr(op_, imm)
            items.append(leb_u(len(body)) + body)
        out += _section(10, _vec(items))
    if m.data:
        # a data-count section (12) precedes code when passive segments
        # or memory.init/data.drop are in play — emit it whenever any
        # segment is passive so single-pass validators are satisfied.
        # (it was inserted before section 10 below)
        items = []
        for off, payload in m.data:
            if off is None:
                items.append(b"\x01" + leb_u(len(payload)) + payload)
            else:
                items.append(b"\x00" + _enc_instr(I32_CONST, off)
                             + bytes([END])
                             + leb_u(len(payload)) + payload)
        out += _section(11, _vec(items))
    return bytes(out)
