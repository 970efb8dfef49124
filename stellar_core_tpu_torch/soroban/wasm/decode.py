"""Wasm binary decoder: bytes → `module.Module`.

Follows the core-spec binary grammar (sections 1–11, LEB128 integers).
Instruction bodies are decoded eagerly into flat (opcode, imm) lists —
the same representation `ModuleBuilder` emits — so validation and
execution never re-touch raw bytes.  Unknown opcodes, truncated
sections, and malformed LEB encodings raise `WasmFormatError`
deterministically (a hostile module must fail identically on every
node; reference analogue: Wasmi's parse errors surfacing as
SCE_WASM_VM errors via rust/src/contract.rs).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .module import (BLOCK, BLOCK_EMPTY, BR, BR_IF, BR_TABLE, CALL,
                     CALL_INDIRECT, Code, DATA_DROP, ELSE, END, F32, F64,
                     F32_CONST, F64_CONST, FC_PREFIX, FUNCREF, FuncType,
                     GLOBAL_GET, GLOBAL_SET, Global, I32, I32_CONST, I64,
                     I64_CONST, IF, Import, Export, LOCAL_GET, LOCAL_SET,
                     LOCAL_TEE, LOOP, MEMARG_OPS, MEMORY_COPY, MEMORY_FILL,
                     MEMORY_GROW, MEMORY_INIT, MEMORY_SIZE, Module,
                     WasmFormatError)

_KNOWN_OPS = set()
_KNOWN_OPS.update([0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x0B, 0x0C, 0x0D,
                   0x0E, 0x0F, 0x10, 0x11, 0x1A, 0x1B])
_KNOWN_OPS.update(range(0x20, 0x25))         # variable
_KNOWN_OPS.update(range(0x28, 0x41))         # memory + size/grow
_KNOWN_OPS.update(range(0x41, 0x45))         # consts
_KNOWN_OPS.update(range(0x45, 0xC5))         # numeric + conversions + extN
_KNOWN_OPS.add(FC_PREFIX)                    # bulk-memory / trunc_sat


class Reader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf: bytes, pos: int = 0, end: Optional[int] = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def eof(self) -> bool:
        return self.pos >= self.end

    def byte(self) -> int:
        if self.pos >= self.end:
            raise WasmFormatError("unexpected end of section")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def bytes(self, n: int) -> bytes:
        if self.pos + n > self.end:
            raise WasmFormatError("unexpected end of section")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def u32(self) -> int:
        return self._leb_u(32)

    def u64(self) -> int:
        return self._leb_u(64)

    def _leb_u(self, bits: int) -> int:
        result = shift = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            shift += 7
            if not (b & 0x80):
                break
            if shift >= bits + 7:
                raise WasmFormatError("LEB128 too long")
        if result >= 1 << bits:
            raise WasmFormatError("LEB128 out of range")
        return result

    def s_leb(self, bits: int) -> int:
        result = shift = 0
        while True:
            b = self.byte()
            result |= (b & 0x7F) << shift
            shift += 7
            if not (b & 0x80):
                if b & 0x40 and shift < bits + 7:
                    result -= 1 << shift
                break
            if shift >= bits + 7:
                raise WasmFormatError("LEB128 too long")
        if not (-(1 << (bits - 1)) <= result < 1 << bits):
            # s33 blocktype / i32 / i64 ranges checked by caller context
            raise WasmFormatError("signed LEB128 out of range")
        return result

    def name(self) -> str:
        n = self.u32()
        try:
            return self.bytes(n).decode("utf-8")
        except UnicodeDecodeError as e:
            raise WasmFormatError(f"bad utf-8 name: {e}")

    def valtype(self) -> int:
        t = self.byte()
        if t not in (I32, I64, F32, F64):
            raise WasmFormatError(f"bad value type 0x{t:02x}")
        return t

    def limits(self) -> Tuple[int, Optional[int]]:
        flag = self.byte()
        if flag == 0x00:
            return self.u32(), None
        if flag == 0x01:
            mn = self.u32()
            mx = self.u32()
            if mx < mn:
                raise WasmFormatError("limits max < min")
            return mn, mx
        raise WasmFormatError(f"bad limits flag 0x{flag:02x}")


def _decode_blocktype(r: Reader) -> int:
    """Empty (0x40), valtype, or s33 type index."""
    if r.pos >= r.end:
        raise WasmFormatError("unexpected end of section")
    b = r.buf[r.pos]
    if b in (BLOCK_EMPTY, I32, I64, F32, F64):
        r.pos += 1
        return b
    idx = r.s_leb(33)
    if idx < 0:
        raise WasmFormatError("bad block type")
    return idx


def decode_expr(r: Reader, stop_at_else: bool = False
                ) -> List[Tuple[int, object]]:
    """Decode instructions until the matching END (depth-tracked)."""
    instrs: List[Tuple[int, object]] = []
    depth = 0
    while True:
        op = r.byte()
        if op not in _KNOWN_OPS:
            raise WasmFormatError(f"unknown opcode 0x{op:02x}")
        imm: object = None
        if op in (BLOCK, LOOP, IF):
            imm = _decode_blocktype(r)
            depth += 1
        elif op == ELSE:
            pass
        elif op == END:
            if depth == 0:
                instrs.append((op, None))
                return instrs
            depth -= 1
        elif op in (BR, BR_IF, CALL, LOCAL_GET, LOCAL_SET, LOCAL_TEE,
                    GLOBAL_GET, GLOBAL_SET):
            imm = r.u32()
        elif op == CALL_INDIRECT:
            imm = r.u32()
            if r.byte() != 0x00:
                raise WasmFormatError("call_indirect: table index must be 0")
        elif op == BR_TABLE:
            n = r.u32()
            targets = [r.u32() for _ in range(n)]
            imm = (targets, r.u32())
        elif op in MEMARG_OPS:
            imm = (r.u32(), r.u32())        # align, offset
        elif op in (MEMORY_SIZE, MEMORY_GROW):
            if r.byte() != 0x00:
                raise WasmFormatError("memory index must be 0")
        elif op == I32_CONST:
            imm = r.s_leb(32) & 0xFFFFFFFF
        elif op == I64_CONST:
            imm = r.s_leb(64) & 0xFFFFFFFFFFFFFFFF
        elif op == F32_CONST:
            imm = r.bytes(4)
        elif op == F64_CONST:
            imm = r.bytes(8)
        elif op == FC_PREFIX:
            sub = r.u32()
            if sub > 0x0B:      # OR-ing larger subs would alias onto
                raise WasmFormatError(   # valid opcodes (e.g. 0x408)
                    f"unknown 0xFC opcode {sub}")
            op = 0xFC00 | sub
            if sub <= 7:                     # trunc_sat: float family;
                imm = None                   # validator rejects it
            elif op == MEMORY_INIT:
                imm = r.u32()                # data segment index
                if r.byte() != 0x00:
                    raise WasmFormatError("memory.init: memidx must be 0")
            elif op == DATA_DROP:
                imm = r.u32()
            elif op == MEMORY_COPY:
                if r.byte() != 0x00 or r.byte() != 0x00:
                    raise WasmFormatError("memory.copy: memidx must be 0")
            elif op == MEMORY_FILL:
                if r.byte() != 0x00:
                    raise WasmFormatError("memory.fill: memidx must be 0")
            else:
                raise WasmFormatError(f"unknown 0xFC opcode {sub}")
        instrs.append((op, imm))


def _decode_const_expr(r: Reader, want: int = I32) -> int:
    """Constant initializer: a single iNN.const (of type `want`) + END."""
    op = r.byte()
    if op == I32_CONST:
        v = r.s_leb(32) & 0xFFFFFFFF
    elif op == I64_CONST:
        v = r.s_leb(64) & 0xFFFFFFFFFFFFFFFF
    else:
        raise WasmFormatError(
            f"unsupported constant initializer opcode 0x{op:02x}")
    if r.byte() != END:
        raise WasmFormatError("constant expression must be a single const")
    if (I32_CONST if want == I32 else I64_CONST) != op:
        raise WasmFormatError("constant initializer type mismatch")
    return v


def decode_module(data: bytes) -> Module:
    if data[:4] != b"\x00asm":
        raise WasmFormatError("bad magic")
    if data[4:8] != b"\x01\x00\x00\x00":
        raise WasmFormatError("unsupported wasm version")
    m = Module()
    r = Reader(data, 8)
    last_sid = 0
    func_count = 0
    while not r.eof():
        sid = r.byte()
        size = r.u32()
        body = Reader(data, r.pos, r.pos + size)
        if body.end > len(data):
            raise WasmFormatError("section extends past end of module")
        r.pos += size
        if sid == 0:                       # custom section: skipped
            continue
        if sid > 12:
            raise WasmFormatError(f"unknown section id {sid}")
        # bulk-memory's data-count section (12) sorts between element (9)
        # and code (10) in the spec's required ordering
        order = sid if sid != 12 else 9.5
        last_order = last_sid if last_sid != 12 else 9.5
        if order <= last_order:
            raise WasmFormatError(f"out-of-order section id {sid}")
        last_sid = sid

        if sid == 1:
            for _ in range(body.u32()):
                if body.byte() != 0x60:
                    raise WasmFormatError("bad functype tag")
                params = [body.valtype() for _ in range(body.u32())]
                results = [body.valtype() for _ in range(body.u32())]
                m.types.append(FuncType(params, results))
        elif sid == 2:
            for _ in range(body.u32()):
                mod = body.name()
                name = body.name()
                kind = body.byte()
                if kind == 0x00:
                    desc: object = body.u32()
                elif kind == 0x01:
                    if body.byte() != FUNCREF:
                        raise WasmFormatError("bad table elemtype")
                    desc = body.limits()
                elif kind == 0x02:
                    desc = body.limits()
                elif kind == 0x03:
                    desc = (body.valtype(), body.byte() == 1)
                else:
                    raise WasmFormatError(f"bad import kind {kind}")
                m.imports.append(Import(mod, name, kind, desc))
        elif sid == 3:
            func_count = body.u32()
            m.funcs = [body.u32() for _ in range(func_count)]
        elif sid == 4:
            n = body.u32()
            if n > 1:
                raise WasmFormatError("at most one table")
            if n:
                if body.byte() != FUNCREF:
                    raise WasmFormatError("bad table elemtype")
                m.table_limits = body.limits()
        elif sid == 5:
            n = body.u32()
            if n > 1:
                raise WasmFormatError("at most one memory")
            if n:
                m.mem_limits = body.limits()
        elif sid == 6:
            for _ in range(body.u32()):
                vt = body.valtype()
                mut = body.byte() == 1
                init = _decode_const_expr(body, want=vt)
                m.globals.append(Global(vt, mut, init))
        elif sid == 7:
            seen = set()
            for _ in range(body.u32()):
                name = body.name()
                if name in seen:
                    raise WasmFormatError(f"duplicate export {name!r}")
                seen.add(name)
                kind = body.byte()
                if kind > 3:
                    raise WasmFormatError(f"bad export kind {kind}")
                m.exports.append(Export(name, kind, body.u32()))
        elif sid == 8:
            m.start = body.u32()
        elif sid == 9:
            for _ in range(body.u32()):
                if body.u32() != 0:
                    raise WasmFormatError("table index must be 0")
                off = _decode_const_expr(body)
                m.elements.append(
                    (off, [body.u32() for _ in range(body.u32())]))
        elif sid == 10:
            n = body.u32()
            if n != func_count:
                raise WasmFormatError(
                    "code section count != function section count")
            for _ in range(n):
                sz = body.u32()
                fr = Reader(data, body.pos, body.pos + sz)
                body.pos += sz
                locals_: List[int] = []
                for _ in range(fr.u32()):
                    cnt = fr.u32()
                    vt = fr.valtype()
                    if cnt > 100_000 or len(locals_) + cnt > 100_000:
                        raise WasmFormatError("too many locals")
                    locals_.extend([vt] * cnt)
                instrs = decode_expr(fr)
                if not fr.eof():
                    raise WasmFormatError("trailing bytes in function body")
                m.codes.append(Code(locals_, instrs))
        elif sid == 11:
            for _ in range(body.u32()):
                flag = body.u32()
                if flag == 0:              # active, memory 0
                    off: Optional[int] = _decode_const_expr(body)
                elif flag == 1:            # passive (bulk-memory)
                    off = None
                elif flag == 2:            # active with explicit memidx
                    if body.u32() != 0:
                        raise WasmFormatError("memory index must be 0")
                    off = _decode_const_expr(body)
                else:
                    raise WasmFormatError(f"bad data segment flag {flag}")
                payload = body.bytes(body.u32())
                m.data.append((off, payload))
        elif sid == 12:
            m.data_count = body.u32()
        if not body.eof():
            raise WasmFormatError(f"trailing bytes in section {sid}")
    if func_count and len(m.codes) != func_count:
        raise WasmFormatError("missing code section")
    if m.data_count is not None and len(m.data) != m.data_count:
        raise WasmFormatError(
            "data count section disagrees with data section")
    return m
