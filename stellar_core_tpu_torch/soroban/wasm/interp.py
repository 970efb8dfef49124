"""Metered wasm interpreter.

Execution model: each function body (already decoded to flat
(opcode, imm) lists) gets a one-time jump-map pass resolving
block/loop/if→else/end targets; the run loop then uses a label stack
(target pc, arity, operand-stack height) for branches — the standard
structured-control interpretation, no bytecode re-scanning at branch
time.

Determinism & metering: every instruction consumes one fuel unit
against a `meter` (the Soroban budget adapter); fuel is reconciled at
host-call boundaries so the budget observes instruction costs and host
costs in program order.  Exhaustion, div-by-zero, OOB memory access,
indirect-call mismatch, unreachable, and call-depth overflow all raise
`WasmTrap` with a stable kind string — hostile or buggy contract code
must fail identically on every node (reference analogue: Wasmi traps
mapped to SCE_WASM_VM / SCE_BUDGET in soroban-env-host).

Values are Python ints held in unsigned canonical form (i32 in
[0,2^32), i64 in [0,2^64)); signed operators reinterpret at use.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from .module import (BLOCK, BR, BR_IF, BR_TABLE, CALL, CALL_INDIRECT,
                     Code, DATA_DROP, DROP, ELSE, END, GLOBAL_GET,
                     GLOBAL_SET, I32, I32_CONST, I64, I64_CONST, IF,
                     LOCAL_GET, LOCAL_SET, LOCAL_TEE, LOOP, MEMORY_COPY,
                     MEMORY_FILL, MEMORY_GROW, MEMORY_INIT, MEMORY_SIZE,
                     Module, NOP, PAGE_SIZE, RETURN, SELECT, UNREACHABLE,
                     FuncType)
from .validate import MAX_MEMORY_PAGES

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


class WasmTrap(Exception):
    """Deterministic runtime trap."""

    def __init__(self, kind: str, msg: str = ""):
        super().__init__(f"wasm trap: {kind}" + (f" ({msg})" if msg else ""))
        self.kind = kind


class HostFunc:
    """An imported function provided by the embedder."""
    __slots__ = ("params", "results", "fn")

    def __init__(self, params: List[int], results: List[int], fn: Callable):
        self.params = list(params)
        self.results = list(results)
        self.fn = fn

    @property
    def type(self) -> FuncType:
        return FuncType(self.params, self.results)


class _NullMeter:
    def flush(self, executed: int) -> int:
        return 1 << 30


def _s32(v: int) -> int:
    return v - 0x100000000 if v & 0x80000000 else v


def _s64(v: int) -> int:
    return v - 0x10000000000000000 if v & 0x8000000000000000 else v


def _clz(v: int, bits: int) -> int:
    return bits - v.bit_length() if v else bits


def _ctz(v: int, bits: int) -> int:
    return (v & -v).bit_length() - 1 if v else bits


def _jump_map(code: Code) -> Dict[int, Tuple[Optional[int], int]]:
    """instr index of BLOCK/LOOP/IF → (else_idx or None, end_idx)."""
    jumps: Dict[int, Tuple[Optional[int], int]] = {}
    stack: List[int] = []
    elses: Dict[int, int] = {}
    for i, (op, _imm) in enumerate(code.instrs):
        if op in (BLOCK, LOOP, IF):
            stack.append(i)
        elif op == ELSE:
            elses[stack[-1]] = i
        elif op == END and stack:
            start = stack.pop()
            jumps[start] = (elses.get(start), i)
    return jumps


class _Label:
    __slots__ = ("target", "arity", "height", "is_loop")

    def __init__(self, target: int, arity: int, height: int, is_loop: bool):
        self.target = target
        self.arity = arity
        self.height = height
        self.is_loop = is_loop


class Instance:
    """One instantiated module.

    imports: {(module, name): HostFunc}; only function imports are
    supported (memory/table/global imports are outside the profile —
    contracts own their memory, as in the reference host).
    meter: object with flush(executed:int) -> remaining:int; called with
    the instruction count executed since the previous flush, returns how
    many more instructions may run (0 → out-of-fuel trap).
    """

    def __init__(self, module: Module,
                 imports: Optional[Dict[Tuple[str, str], HostFunc]] = None,
                 meter=None, max_call_depth: int = 64):
        self.m = module
        self.meter = meter or _NullMeter()
        self.max_call_depth = max_call_depth
        self._depth = 0
        self._allow = 0          # instructions allowed before next flush
        self._pending = 0        # instructions executed since last flush

        self.host_funcs: List[HostFunc] = []
        imports = imports or {}
        for im in module.imports:
            if im.kind != 0:
                raise WasmTrap("link", f"unsupported import kind {im.kind}")
            hf = imports.get((im.module, im.name))
            if hf is None:
                raise WasmTrap(
                    "link", f"missing import {im.module}.{im.name}")
            if hf.type != module.types[im.desc]:
                raise WasmTrap(
                    "link", f"import type mismatch {im.module}.{im.name}")
            self.host_funcs.append(hf)

        self.memory = bytearray()
        self.mem_max = 0
        if module.mem_limits is not None:
            mn, mx = module.mem_limits
            self.memory = bytearray(mn * PAGE_SIZE)
            self.mem_max = min(mx if mx is not None else MAX_MEMORY_PAGES,
                               MAX_MEMORY_PAGES)
        # active segments initialize memory then drop; passive segments
        # stay live for memory.init until data.drop empties them
        self.data_segs: List[bytes] = []
        for off, payload in module.data:
            if off is None:
                self.data_segs.append(payload)
                continue
            if off + len(payload) > len(self.memory):
                raise WasmTrap("oob", "data segment out of bounds")
            self.memory[off:off + len(payload)] = payload
            self.data_segs.append(b"")

        self.globals: List[int] = [g.init for g in module.globals]

        self.table: List[Optional[int]] = []
        if module.table_limits is not None:
            self.table = [None] * module.table_limits[0]
        for off, idxs in module.elements:
            if off + len(idxs) > len(self.table):
                raise WasmTrap("oob", "element segment out of bounds")
            for j, fidx in enumerate(idxs):
                self.table[off + j] = fidx

        for c in module.codes:        # resolved once, cached on the Module
            if c.jumps is None:
                c.jumps = _jump_map(c)
        self._jumps: List[Dict[int, Tuple[Optional[int], int]]] = [
            c.jumps for c in module.codes]
        self._exports = module.export_map()

        if module.start is not None:
            self._enter()
            try:
                self._call(module.start, [])
            finally:
                self._exit()

    # ------------------------------------------------------------- metering --
    def _enter(self):
        self._allow = self.meter.flush(0)
        self._pending = 0

    def _exit(self):
        self.meter.flush(self._pending)
        self._pending = 0

    def _refuel(self):
        self._allow = self.meter.flush(self._pending)
        self._pending = 0
        if self._allow <= 0:
            raise WasmTrap("fuel", "instruction budget exhausted")

    # -------------------------------------------------------------- invoke --
    def invoke(self, name: str, args: List[int]) -> List[int]:
        exp = self._exports.get(name)
        if exp is None or exp.kind != 0:
            raise WasmTrap("link", f"no exported function {name!r}")
        ft = self.m.func_type(exp.index)
        if len(args) != len(ft.params):
            raise WasmTrap("type", f"{name} expects {len(ft.params)} args")
        self._enter()
        try:
            return self._call(exp.index, list(args))
        finally:
            self._exit()

    # ---------------------------------------------------------- the engine --
    def _call(self, funcidx: int, args: List[int]) -> List[int]:
        nimp = len(self.host_funcs)
        if funcidx < nimp:
            hf = self.host_funcs[funcidx]
            # reconcile fuel so the budget sees costs in program order
            self.meter.flush(self._pending)
            self._pending = 0
            res = hf.fn(self, *args)
            self._allow = self.meter.flush(0)
            if self._allow <= 0:
                raise WasmTrap("fuel", "instruction budget exhausted")
            if not hf.results:
                return []
            return [res & (M32 if hf.results[0] == I32 else M64)]

        self._depth += 1
        if self._depth > self.max_call_depth:
            self._depth -= 1
            raise WasmTrap("stack", "call depth exceeded")
        try:
            lidx = funcidx - nimp
            code = self.m.codes[lidx]
            ft = self.m.types[self.m.funcs[lidx]]
            locals_ = args + [0] * len(code.locals)
            return self._run(code, self._jumps[lidx], locals_,
                             len(ft.results))
        finally:
            self._depth -= 1

    def _run(self, code: Code, jumps, locals_: List[int],
             result_arity: int) -> List[int]:
        instrs = code.instrs
        n = len(instrs)
        stack: List[int] = []
        labels: List[_Label] = [_Label(n, result_arity, 0, False)]
        allow = self._allow
        pending = self._pending
        mem = self.memory
        pc = 0
        while pc < n:
            if pending >= allow:
                self._pending = pending
                self._refuel()
                allow = self._allow
                pending = 0
            pending += 1

            op, imm = instrs[pc]
            pc += 1

            if op == LOCAL_GET:
                stack.append(locals_[imm])
            elif op == I32_CONST or op == I64_CONST:
                stack.append(imm)
            elif op == LOCAL_SET:
                locals_[imm] = stack.pop()
            elif op == LOCAL_TEE:
                locals_[imm] = stack[-1]
            elif 0x45 <= op <= 0xC4:
                try:
                    self._numeric(op, stack)
                except WasmTrap:
                    # in-frame trap: charge the instructions executed in
                    # this stretch before propagating (callee frames and
                    # _refuel account for themselves)
                    self._allow, self._pending = allow, pending
                    raise
            elif op == BLOCK or op == LOOP:
                arity = self._block_arity(imm, op == LOOP)
                _else, endi = jumps[pc - 1]
                if op == LOOP:
                    labels.append(_Label(pc, arity, len(stack), True))
                else:
                    labels.append(_Label(endi + 1, arity,
                                         len(stack), False))
            elif op == IF:
                cond = stack.pop()
                arity = self._block_arity(imm, False)
                elsei, endi = jumps[pc - 1]
                labels.append(_Label(endi + 1, arity, len(stack), False))
                if not cond:
                    pc = (elsei + 1) if elsei is not None else endi
                    if elsei is None:
                        pass  # run END: pops the label
            elif op == ELSE:
                # end of the taken then-branch: jump to the matching END
                lab = labels[-1]
                pc = lab.target - 1        # the END instruction
            elif op == END:
                labels.pop()
            elif op == BR or op == BR_IF or op == BR_TABLE:
                if op == BR_IF:
                    if not stack.pop():
                        continue
                    depth = imm
                elif op == BR:
                    depth = imm
                else:
                    targets, default = imm
                    i = stack.pop()
                    depth = targets[i] if i < len(targets) else default
                idx = len(labels) - 1 - depth
                lab = labels[idx]
                if lab.arity:
                    vals = stack[-lab.arity:]
                    del stack[lab.height:]
                    stack.extend(vals)
                else:
                    del stack[lab.height:]
                if lab.is_loop:
                    del labels[idx + 1:]
                else:
                    del labels[idx:]
                pc = lab.target
            elif op == RETURN:
                break
            elif op == CALL:
                self._allow, self._pending = allow, pending
                ft = self.m.func_type(imm)
                nargs = len(ft.params)
                args = stack[len(stack) - nargs:] if nargs else []
                if nargs:
                    del stack[len(stack) - nargs:]
                stack.extend(self._call(imm, args))
                allow, pending = self._allow, self._pending
                mem = self.memory
            elif op == CALL_INDIRECT:
                self._allow, self._pending = allow, pending
                elem = stack.pop()
                if elem >= len(self.table) or self.table[elem] is None:
                    raise WasmTrap("indirect", "undefined table element")
                fidx = self.table[elem]
                if self.m.func_type(fidx) != self.m.types[imm]:
                    raise WasmTrap("indirect", "signature mismatch")
                ft = self.m.types[imm]
                nargs = len(ft.params)
                args = stack[len(stack) - nargs:] if nargs else []
                if nargs:
                    del stack[len(stack) - nargs:]
                stack.extend(self._call(fidx, args))
                allow, pending = self._allow, self._pending
                mem = self.memory
            elif op == DROP:
                stack.pop()
            elif op == SELECT:
                c = stack.pop()
                b = stack.pop()
                a = stack.pop()
                stack.append(a if c else b)
            elif op == GLOBAL_GET:
                stack.append(self.globals[imm])
            elif op == GLOBAL_SET:
                self.globals[imm] = stack.pop()
            elif 0x28 <= op <= 0x3E:
                try:
                    self._memop(op, imm, stack, mem)
                except WasmTrap:
                    self._allow, self._pending = allow, pending
                    raise
            elif op == MEMORY_SIZE:
                stack.append(len(mem) // PAGE_SIZE)
            elif op == MEMORY_GROW:
                delta = stack.pop()
                cur = len(mem) // PAGE_SIZE
                if delta > self.mem_max or cur + delta > self.mem_max:
                    stack.append(M32)
                else:
                    self.memory.extend(bytes(delta * PAGE_SIZE))
                    mem = self.memory
                    stack.append(cur)
            elif op == NOP:
                pass
            elif op >= 0xFC00:               # bulk-memory family
                cnt = 0                      # byte count (top of stack)
                if op != DATA_DROP:
                    cnt = stack.pop()
                if op == MEMORY_COPY:
                    s = stack.pop()
                    d = stack.pop()
                    if d + cnt > len(mem) or s + cnt > len(mem):
                        self._allow, self._pending = allow, pending
                        raise WasmTrap("oob", "memory.copy")
                    if cnt:
                        # snapshot source: memmove semantics on overlap
                        mem[d:d + cnt] = bytes(mem[s:s + cnt])
                elif op == MEMORY_FILL:
                    v = stack.pop()
                    d = stack.pop()
                    if d + cnt > len(mem):
                        self._allow, self._pending = allow, pending
                        raise WasmTrap("oob", "memory.fill")
                    if cnt:
                        mem[d:d + cnt] = bytes((v & 0xFF,)) * cnt
                elif op == MEMORY_INIT:
                    s = stack.pop()
                    d = stack.pop()
                    seg = self.data_segs[imm]
                    if s + cnt > len(seg) or d + cnt > len(mem):
                        self._allow, self._pending = allow, pending
                        raise WasmTrap("oob", "memory.init")
                    if cnt:
                        mem[d:d + cnt] = seg[s:s + cnt]
                elif op == DATA_DROP:
                    self.data_segs[imm] = b""
                else:   # pragma: no cover - validator excludes the rest
                    self._allow, self._pending = allow, pending
                    raise WasmTrap("type", f"unexecutable 0x{op:04x}")
                # bulk ops move cnt bytes for one opcode: meter the work
                pending += cnt >> 3
            elif op == UNREACHABLE:
                self._allow, self._pending = allow, pending
                raise WasmTrap("unreachable")
            else:  # pragma: no cover - validator excludes anything else
                self._allow, self._pending = allow, pending
                raise WasmTrap("type", f"unexecutable opcode 0x{op:02x}")

        self._allow, self._pending = allow, pending
        if result_arity:
            return stack[-result_arity:]
        return []

    def _block_arity(self, bt, is_loop: bool) -> int:
        if bt == 0x40:
            return 0
        if bt in (I32, I64):
            return 0 if is_loop else 1
        ft = self.m.types[bt]
        return len(ft.params) if is_loop else len(ft.results)

    # ------------------------------------------------------------- numeric --
    def _numeric(self, op: int, stack: List[int]) -> None:
        if op == 0x45:                       # i32.eqz
            stack[-1] = 1 if stack[-1] == 0 else 0
            return
        if op == 0x50:                       # i64.eqz
            stack[-1] = 1 if stack[-1] == 0 else 0
            return
        if 0x46 <= op <= 0x4F:               # i32 comparisons
            b = stack.pop()
            a = stack[-1]
            if op == 0x46:
                r = a == b
            elif op == 0x47:
                r = a != b
            elif op == 0x48:
                r = _s32(a) < _s32(b)
            elif op == 0x49:
                r = a < b
            elif op == 0x4A:
                r = _s32(a) > _s32(b)
            elif op == 0x4B:
                r = a > b
            elif op == 0x4C:
                r = _s32(a) <= _s32(b)
            elif op == 0x4D:
                r = a <= b
            elif op == 0x4E:
                r = _s32(a) >= _s32(b)
            else:
                r = a >= b
            stack[-1] = 1 if r else 0
            return
        if 0x51 <= op <= 0x5A:               # i64 comparisons
            b = stack.pop()
            a = stack[-1]
            if op == 0x51:
                r = a == b
            elif op == 0x52:
                r = a != b
            elif op == 0x53:
                r = _s64(a) < _s64(b)
            elif op == 0x54:
                r = a < b
            elif op == 0x55:
                r = _s64(a) > _s64(b)
            elif op == 0x56:
                r = a > b
            elif op == 0x57:
                r = _s64(a) <= _s64(b)
            elif op == 0x58:
                r = a <= b
            elif op == 0x59:
                r = _s64(a) >= _s64(b)
            else:
                r = a >= b
            stack[-1] = 1 if r else 0
            return
        if 0x67 <= op <= 0x78:               # i32 arithmetic
            if op == 0x67:
                stack[-1] = _clz(stack[-1], 32)
                return
            if op == 0x68:
                stack[-1] = _ctz(stack[-1], 32)
                return
            if op == 0x69:
                stack[-1] = bin(stack[-1]).count("1")
                return
            b = stack.pop()
            a = stack[-1]
            if op == 0x6A:
                r = (a + b) & M32
            elif op == 0x6B:
                r = (a - b) & M32
            elif op == 0x6C:
                r = (a * b) & M32
            elif op == 0x6D:                 # div_s
                if b == 0:
                    raise WasmTrap("div0", "i32.div_s")
                sa, sb = _s32(a), _s32(b)
                q = abs(sa) // abs(sb)
                if (sa < 0) != (sb < 0):
                    q = -q
                if q > 0x7FFFFFFF:
                    raise WasmTrap("overflow", "i32.div_s")
                r = q & M32
            elif op == 0x6E:                 # div_u
                if b == 0:
                    raise WasmTrap("div0", "i32.div_u")
                r = a // b
            elif op == 0x6F:                 # rem_s
                if b == 0:
                    raise WasmTrap("div0", "i32.rem_s")
                sa, sb = _s32(a), _s32(b)
                r = (abs(sa) % abs(sb))
                if sa < 0:
                    r = -r
                r &= M32
            elif op == 0x70:                 # rem_u
                if b == 0:
                    raise WasmTrap("div0", "i32.rem_u")
                r = a % b
            elif op == 0x71:
                r = a & b
            elif op == 0x72:
                r = a | b
            elif op == 0x73:
                r = a ^ b
            elif op == 0x74:
                r = (a << (b % 32)) & M32
            elif op == 0x75:
                r = (_s32(a) >> (b % 32)) & M32
            elif op == 0x76:
                r = a >> (b % 32)
            elif op == 0x77:
                k = b % 32
                r = ((a << k) | (a >> (32 - k))) & M32 if k else a
            else:                            # rotr
                k = b % 32
                r = ((a >> k) | (a << (32 - k))) & M32 if k else a
            stack[-1] = r
            return
        if 0x79 <= op <= 0x8A:               # i64 arithmetic
            if op == 0x79:
                stack[-1] = _clz(stack[-1], 64)
                return
            if op == 0x7A:
                stack[-1] = _ctz(stack[-1], 64)
                return
            if op == 0x7B:
                stack[-1] = bin(stack[-1]).count("1")
                return
            b = stack.pop()
            a = stack[-1]
            if op == 0x7C:
                r = (a + b) & M64
            elif op == 0x7D:
                r = (a - b) & M64
            elif op == 0x7E:
                r = (a * b) & M64
            elif op == 0x7F:                 # div_s
                if b == 0:
                    raise WasmTrap("div0", "i64.div_s")
                sa, sb = _s64(a), _s64(b)
                q = abs(sa) // abs(sb)
                if (sa < 0) != (sb < 0):
                    q = -q
                if q > 0x7FFFFFFFFFFFFFFF:
                    raise WasmTrap("overflow", "i64.div_s")
                r = q & M64
            elif op == 0x80:
                if b == 0:
                    raise WasmTrap("div0", "i64.div_u")
                r = a // b
            elif op == 0x81:
                if b == 0:
                    raise WasmTrap("div0", "i64.rem_s")
                sa, sb = _s64(a), _s64(b)
                r = (abs(sa) % abs(sb))
                if sa < 0:
                    r = -r
                r &= M64
            elif op == 0x82:
                if b == 0:
                    raise WasmTrap("div0", "i64.rem_u")
                r = a % b
            elif op == 0x83:
                r = a & b
            elif op == 0x84:
                r = a | b
            elif op == 0x85:
                r = a ^ b
            elif op == 0x86:
                r = (a << (b % 64)) & M64
            elif op == 0x87:
                r = (_s64(a) >> (b % 64)) & M64
            elif op == 0x88:
                r = a >> (b % 64)
            elif op == 0x89:
                k = b % 64
                r = ((a << k) | (a >> (64 - k))) & M64 if k else a
            else:
                k = b % 64
                r = ((a >> k) | (a << (64 - k))) & M64 if k else a
            stack[-1] = r
            return
        if op == 0xA7:                       # i32.wrap_i64
            stack[-1] &= M32
            return
        if op == 0xAC:                       # i64.extend_i32_s
            stack[-1] = _s32(stack[-1]) & M64
            return
        if op == 0xAD:                       # i64.extend_i32_u
            return
        if op == 0xC0:                       # i32.extend8_s
            v = stack[-1] & 0xFF
            stack[-1] = (v - 0x100 if v & 0x80 else v) & M32
            return
        if op == 0xC1:
            v = stack[-1] & 0xFFFF
            stack[-1] = (v - 0x10000 if v & 0x8000 else v) & M32
            return
        if op == 0xC2:
            v = stack[-1] & 0xFF
            stack[-1] = (v - 0x100 if v & 0x80 else v) & M64
            return
        if op == 0xC3:
            v = stack[-1] & 0xFFFF
            stack[-1] = (v - 0x10000 if v & 0x8000 else v) & M64
            return
        if op == 0xC4:
            v = stack[-1] & M32
            stack[-1] = (v - 0x100000000 if v & 0x80000000 else v) & M64
            return
        raise WasmTrap("type", f"unexecutable opcode 0x{op:02x}")

    # -------------------------------------------------------------- memory --
    def _memop(self, op: int, imm, stack: List[int], mem: bytearray) -> None:
        offset = imm[1]
        if 0x28 <= op <= 0x35:               # loads
            addr = stack.pop() + offset
            if op == 0x28:
                w, signed, mask = 4, False, M32
            elif op == 0x29:
                w, signed, mask = 8, False, M64
            elif op == 0x2C:
                w, signed, mask = 1, True, M32
            elif op == 0x2D:
                w, signed, mask = 1, False, M32
            elif op == 0x2E:
                w, signed, mask = 2, True, M32
            elif op == 0x2F:
                w, signed, mask = 2, False, M32
            elif op == 0x30:
                w, signed, mask = 1, True, M64
            elif op == 0x31:
                w, signed, mask = 1, False, M64
            elif op == 0x32:
                w, signed, mask = 2, True, M64
            elif op == 0x33:
                w, signed, mask = 2, False, M64
            elif op == 0x34:
                w, signed, mask = 4, True, M64
            else:
                w, signed, mask = 4, False, M64
            if addr + w > len(mem):
                raise WasmTrap("oob", "memory load")
            v = int.from_bytes(mem[addr:addr + w], "little")
            if signed and v & (1 << (w * 8 - 1)):
                v -= 1 << (w * 8)
            stack.append(v & mask)
        else:                                # stores
            v = stack.pop()
            addr = stack.pop() + offset
            if op == 0x36:
                w = 4
            elif op == 0x37:
                w = 8
            elif op == 0x3A:
                w = 1
            elif op == 0x3B:
                w = 2
            elif op == 0x3C:
                w = 1
            elif op == 0x3D:
                w = 2
            else:
                w = 4 if op == 0x3E else 8
            if addr + w > len(mem):
                raise WasmTrap("oob", "memory store")
            mem[addr:addr + w] = (v & ((1 << (w * 8)) - 1)).to_bytes(
                w, "little")
