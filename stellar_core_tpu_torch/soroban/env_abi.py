"""The real soroban-env-host wasm ABI: single-letter modules, tagged
64-bit Vals.

Ground truth recovered from the reference's vendored SDK-built
contracts (read, not copied: the reference tree's src/testdata/
example_add_i32.wasm, example_contract_data.wasm — the binaries the
reference's own InvokeHostFunction tests execute through
soroban-env-host, rust/src/lib.rs test-wasm getters):

- host imports live in single-letter modules with positional function
  names "_", "0", "1", ...; every parameter and result is an i64
  (``example_contract_data`` imports ("l","_") put_contract_data with
  type [i64,i64]→[i64] and ("l","2") del_contract_data [i64]→[i64] —
  fixing the ledger-module order as put/has/get/del);
- a Val's tag is its LOW 4 BITS and the payload sits in the high 60
  (``example_add_i32``'s decode helper computes ``tag = v & 15`` and
  ``payload = v >> 4``; U32's tag is 3; on add overflow the contract
  itself executes ``unreachable``);
- symbols carry tag 9 (``example_contract_data`` requires it of both
  key and value before storing);
- void results are encoded as the constant 5 (both reference contracts
  ``return i64.const 5``) — tag 5 with payload 0, the first of the
  static values.

Tags not observable from those binaries (I32, object handles, the
true/false statics, status) are FRAMEWORK-PINNED below and documented
as such; everything observable matches the reference bit-for-bit.

The bespoke long-name "x" module (wasm_host.py) remains available —
names never collide (("x","arg") vs ("x","2")) so one import table can
serve both ABIs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..crypto.sha import sha256
from ..xdr.contract import (ContractDataDurability, ContractDataEntry,
                            Int128Parts, Int256Parts, SCAddress,
                            SCErrorCode, SCErrorType, SCMapEntry, SCVal,
                            SCValType, UInt128Parts, UInt256Parts)
from ..xdr.ledger_entries import (LedgerEntry, LedgerEntryType, LedgerKey,
                                  _LedgerEntryData, _LedgerEntryExt)
from ..xdr.types import ExtensionPoint
from .host import HostError
from .wasm import HostFunc, I64, WasmTrap

# ---------------------------------------------------------------- tags ----
TAG_MASK = 0xF
TAG_I32 = 3          # observed: example_add_i32 — the reference invokes
                     # it with makeI32 and overflows at INT32_MAX
                     # (InvokeHostFunctionTests.cpp:2290-2320), and the
                     # contract's own guard is a SIGNED-overflow test
TAG_U32 = 4          # framework-pinned
TAG_STATIC = 5       # observed payload 0 = void (the "return 5" idiom)
TAG_STATUS = 6       # framework-pinned: error/status values
TAG_OBJECT = 7       # framework-pinned: payload = host object handle
TAG_SYMBOL = 9       # observed: example_contract_data

STATIC_VOID = 0
STATIC_TRUE = 1
STATIC_FALSE = 2

VAL_VOID = (STATIC_VOID << 4) | TAG_STATIC      # == 5, as the SDK emits
VAL_TRUE = (STATIC_TRUE << 4) | TAG_STATIC
VAL_FALSE = (STATIC_FALSE << 4) | TAG_STATIC

# 6-bit symbol code space: 1='_', 2-11='0'-'9', 12-37='A'-'Z', 38-63='a'-'z'
_SYM_CHARS = "_0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ" \
             "abcdefghijklmnopqrstuvwxyz"
_SYM_CODE = {c: i + 1 for i, c in enumerate(_SYM_CHARS)}
_SYM_CHAR = {i + 1: c for i, c in enumerate(_SYM_CHARS)}
MAX_INLINE_SYMBOL = 10   # 10 × 6 bits fills the 60-bit payload

# positional host-function names: index 0 → "_", 1 → "0", ...
FN_NAME_SEQ = "_" + "0123456789" + \
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"


def fn_name(index: int) -> str:
    return FN_NAME_SEQ[index]


def symbol_to_val(name: bytes) -> Optional[int]:
    """Inline-encode a short symbol; None if it doesn't fit (then it
    must travel as an object handle). First character ends up in the
    highest bits, matching left-to-right packing."""
    try:
        s = name.decode("ascii")
    except UnicodeDecodeError:
        return None
    if not 0 < len(s) <= MAX_INLINE_SYMBOL:
        return None
    body = 0
    for ch in s:
        code = _SYM_CODE.get(ch)
        if code is None:
            return None
        body = (body << 6) | code
    return (body << 4) | TAG_SYMBOL


def val_to_symbol(v: int) -> bytes:
    body = v >> 4
    out: List[str] = []
    while body:
        code = body & 0x3F
        body >>= 6
        ch = _SYM_CHAR.get(code)
        if ch is None:
            raise HostError(SCErrorType.SCE_VALUE, "bad symbol code",
                            SCErrorCode.SCEC_INVALID_INPUT)
        out.append(ch)
    return "".join(reversed(out)).encode()


class EnvCtx:
    """Val ⇄ SCVal bridge over a per-invocation object table (handle 0
    is reserved; objects are Vals with TAG_OBJECT)."""

    def __init__(self, host, contract, ctx_objs: List[SCVal]):
        self.host = host
        self.contract = contract
        self.objs = ctx_objs      # shared with the bespoke ABI's _Ctx

    # -- handles --
    def put_obj(self, v: SCVal) -> int:
        self.objs.append(v)
        return ((len(self.objs) - 1) << 4) | TAG_OBJECT

    def get_obj(self, val: int) -> SCVal:
        if val & TAG_MASK != TAG_OBJECT:
            raise HostError(SCErrorType.SCE_VALUE,
                            f"expected object, got tag {val & TAG_MASK}",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)
        h = val >> 4
        if not 0 <= h < len(self.objs):
            raise HostError(SCErrorType.SCE_VALUE, f"bad handle {h}",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        return self.objs[h]

    # -- SCVal -> Val --
    def to_val(self, v: SCVal) -> int:
        t = v.disc
        if t == SCValType.SCV_VOID:
            return VAL_VOID
        if t == SCValType.SCV_BOOL:
            return VAL_TRUE if v.value else VAL_FALSE
        if t == SCValType.SCV_I32:
            return ((int(v.value) & 0xFFFFFFFF) << 4) | TAG_I32
        if t == SCValType.SCV_U32:
            return (int(v.value) << 4) | TAG_U32
        if t == SCValType.SCV_SYMBOL:
            inline = symbol_to_val(bytes(v.value))
            if inline is not None:
                return inline
        return self.put_obj(v)

    # -- Val -> SCVal --
    def from_val(self, val: int) -> SCVal:
        val &= (1 << 64) - 1
        tag = val & TAG_MASK
        body = val >> 4
        if tag == TAG_STATIC:
            if body == STATIC_VOID:
                return SCVal(SCValType.SCV_VOID)
            if body == STATIC_TRUE:
                return SCVal(SCValType.SCV_BOOL, True)
            if body == STATIC_FALSE:
                return SCVal(SCValType.SCV_BOOL, False)
            raise HostError(SCErrorType.SCE_VALUE,
                            f"bad static value {body}",
                            SCErrorCode.SCEC_INVALID_INPUT)
        if tag == TAG_U32:
            return SCVal(SCValType.SCV_U32, body & 0xFFFFFFFF)
        if tag == TAG_I32:
            x = body & 0xFFFFFFFF
            return SCVal(SCValType.SCV_I32,
                         x - (1 << 32) if x >> 31 else x)
        if tag == TAG_SYMBOL:
            return SCVal(SCValType.SCV_SYMBOL, val_to_symbol(val))
        if tag == TAG_OBJECT:
            return self.get_obj(val)
        raise HostError(SCErrorType.SCE_VALUE, f"unsupported tag {tag}",
                        SCErrorCode.SCEC_UNEXPECTED_TYPE)

    def u32_arg(self, val: int, what: str) -> int:
        if val & TAG_MASK != TAG_U32:
            raise HostError(SCErrorType.SCE_VALUE, f"{what}: want U32Val",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)
        return (val >> 4) & 0xFFFFFFFF

    def obj_arg(self, val: int, disc: SCValType, what: str) -> SCVal:
        v = self.get_obj(val)
        if v.disc != disc:
            raise HostError(SCErrorType.SCE_VALUE,
                            f"{what}: want {disc.name}, got {v.disc.name}",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)
        return v


def order_key(v: SCVal):
    """The host's total value order: value-type rank, then canonical XDR
    bytes — shared by obj_cmp and the sorted-map invariant (the real
    env's maps are ordered; this framework pins THIS order and applies
    it consistently everywhere values are compared)."""
    return (int(v.disc), v.to_bytes())


# ------------------------------------------------------------ functions ----
def env_host_table(ectx: EnvCtx, charge) -> Dict[Tuple[str, str], HostFunc]:
    """The env-ABI import table. `charge` wraps each fn with the flat
    host-call budget charge (shared with the bespoke table)."""
    host = ectx.host

    def data_key(kval: int) -> LedgerKey:
        key = ectx.from_val(kval)
        # the observed old-ABI storage fns carry no durability parameter:
        # contract data is PERSISTENT
        return LedgerKey.contract_data(
            ectx.contract, key, ContractDataDurability.PERSISTENT)

    # ledger module "l": put / has / get / del — order fixed by the
    # reference contracts' import names ("_" and "2")
    def put_contract_data(inst, kval, vval):
        key = ectx.from_val(kval)
        val = ectx.from_val(vval)
        lk = LedgerKey.contract_data(ectx.contract, key,
                                     ContractDataDurability.PERSISTENT)
        host.put_entry(lk, LedgerEntry(
            lastModifiedLedgerSeq=host.header.ledgerSeq,
            data=_LedgerEntryData(
                LedgerEntryType.CONTRACT_DATA,
                ContractDataEntry(
                    ext=ExtensionPoint(0), contract=ectx.contract,
                    key=key,
                    durability=ContractDataDurability.PERSISTENT,
                    val=val)),
            ext=_LedgerEntryExt(0)),
            durability=ContractDataDurability.PERSISTENT)
        return VAL_VOID

    def has_contract_data(inst, kval):
        return (VAL_TRUE if host.load_entry(data_key(kval)) is not None
                else VAL_FALSE)

    def get_contract_data(inst, kval):
        le = host.load_entry(data_key(kval))
        if le is None:
            raise HostError(SCErrorType.SCE_STORAGE, "missing entry",
                            SCErrorCode.SCEC_MISSING_VALUE)
        return ectx.to_val(le.data.value.val)

    def del_contract_data(inst, kval):
        host.erase_entry(data_key(kval))
        return VAL_VOID

    # context module "x" (short names — the bespoke module uses long ones)
    def obj_cmp(inst, a, b):
        # total, antisymmetric order: value-type rank first (the real
        # obj_cmp orders by tag first), then canonical XDR bytes —
        # deterministic for every SCVal pair
        va, vb = ectx.from_val(a), ectx.from_val(b)
        if va == vb:
            return 0
        return (1 << 64) - 1 if order_key(va) < order_key(vb) else 1

    def contract_event(inst, tval, dval):
        topics = ectx.from_val(tval)
        host.emit_event(bytes(ectx.contract.value),
                        list(topics.value or [])
                        if topics.disc == SCValType.SCV_VEC else [topics],
                        ectx.from_val(dval))
        return VAL_VOID

    def current_address(inst):
        return ectx.put_obj(SCVal(SCValType.SCV_ADDRESS, ectx.contract))

    def ledger_seq(inst):
        return (int(host.header.ledgerSeq) << 4) | TAG_U32

    def fail_with_error(inst, err):
        raise HostError(SCErrorType.SCE_CONTRACT, "fail_with_error",
                        SCErrorCode.SCEC_INVALID_INPUT)

    # vec module "v"
    def vec_new(inst):
        return ectx.put_obj(SCVal(SCValType.SCV_VEC, []))

    def vec_push_back(inst, vh, xval):
        v = ectx.get_obj(vh)
        if v.disc != SCValType.SCV_VEC:
            raise HostError(SCErrorType.SCE_VALUE, "not a vec",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)
        return ectx.put_obj(SCVal(
            SCValType.SCV_VEC,
            list(v.value or []) + [ectx.from_val(xval)]))

    def vec_get(inst, vh, ival):
        v = ectx.get_obj(vh)
        i = ectx.u32_arg(ival, "vec_get")
        if v.disc != SCValType.SCV_VEC or not v.value or i >= len(v.value):
            raise HostError(SCErrorType.SCE_VALUE, "vec_get oob",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        return ectx.to_val(v.value[i])

    def vec_len(inst, vh):
        v = ectx.get_obj(vh)
        if v.disc != SCValType.SCV_VEC:
            raise HostError(SCErrorType.SCE_VALUE, "not a vec",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)
        return (len(v.value or []) << 4) | TAG_U32

    # bytes module "b"
    def bytes_new_from_linear_memory(inst, pval, lval):
        ptr = ectx.u32_arg(pval, "bytes_new")
        ln = ectx.u32_arg(lval, "bytes_new")
        host.budget.charge(ln)
        if ptr + ln > len(inst.memory):
            raise WasmTrap("oob", "bytes_new_from_linear_memory")
        return ectx.put_obj(SCVal(SCValType.SCV_BYTES,
                                  bytes(inst.memory[ptr:ptr + ln])))

    def bytes_len(inst, bh):
        b = ectx.get_obj(bh)
        if b.disc != SCValType.SCV_BYTES:
            raise HostError(SCErrorType.SCE_VALUE, "not bytes",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)
        return (len(b.value) << 4) | TAG_U32

    def bytes_copy_to_linear_memory(inst, bh, bpos, mpos, lval):
        b = ectx.get_obj(bh)
        if b.disc != SCValType.SCV_BYTES:
            raise HostError(SCErrorType.SCE_VALUE, "not bytes",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)
        bp = ectx.u32_arg(bpos, "bytes_copy")
        mp = ectx.u32_arg(mpos, "bytes_copy")
        ln = ectx.u32_arg(lval, "bytes_copy")
        host.budget.charge(ln)
        if bp + ln > len(b.value) or mp + ln > len(inst.memory):
            raise WasmTrap("oob", "bytes_copy_to_linear_memory")
        inst.memory[mp:mp + ln] = b.value[bp:bp + ln]
        return VAL_VOID

    # int module "i": raw u64 in/out (the one place the ABI passes raw)
    def obj_from_u64(inst, raw):
        return ectx.put_obj(SCVal(SCValType.SCV_U64,
                                  raw & ((1 << 64) - 1)))

    def obj_to_u64(inst, oh):
        v = ectx.get_obj(oh)
        if v.disc not in (SCValType.SCV_U64, SCValType.SCV_U32):
            raise HostError(SCErrorType.SCE_VALUE, "not a u64",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)
        return int(v.value)

    # address module "a"
    def require_auth(inst, ah):
        v = ectx.get_obj(ah)
        if v.disc != SCValType.SCV_ADDRESS:
            raise HostError(SCErrorType.SCE_VALUE,
                            "require_auth expects address",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)
        host.require_auth(v.value)
        return VAL_VOID

    # call module "d"
    def call(inst, th, fval, avh):
        target = ectx.get_obj(th)
        fname = ectx.from_val(fval)
        argv = ectx.get_obj(avh)
        if target.disc != SCValType.SCV_ADDRESS or \
                fname.disc != SCValType.SCV_SYMBOL:
            raise HostError(SCErrorType.SCE_VALUE, "bad call operands",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)
        res = host.call_contract(target.value, bytes(fname.value),
                                 list(argv.value or []))
        return ectx.to_val(res)

    # crypto module "c"
    def compute_hash_sha256(inst, bh):
        b = ectx.get_obj(bh)
        if b.disc != SCValType.SCV_BYTES:
            raise HostError(SCErrorType.SCE_VALUE, "not bytes",
                            SCErrorCode.SCEC_UNEXPECTED_TYPE)
        host.budget.charge(len(b.value))
        return ectx.put_obj(SCVal(SCValType.SCV_BYTES,
                                  sha256(bytes(b.value))))

    def verify_sig_ed25519(inst, kh, mh, sh):
        """Void on success, SCE_CRYPTO error (→ trap) on a bad
        signature — routed through the same verifier seam as auth
        (north-star config #4: Soroban host sig checks batch with
        everything else when prevalidated)."""
        pub = ectx.obj_arg(kh, SCValType.SCV_BYTES, "verify_sig")
        msg = ectx.obj_arg(mh, SCValType.SCV_BYTES, "verify_sig")
        sig = ectx.obj_arg(sh, SCValType.SCV_BYTES, "verify_sig")
        if len(pub.value) != 32 or len(sig.value) != 64:
            raise HostError(SCErrorType.SCE_CRYPTO, "bad key/sig length",
                            SCErrorCode.SCEC_INVALID_INPUT)
        host.budget.charge(host.COST_VERIFY_SIG)
        if not host.get_verify()(bytes(pub.value), bytes(sig.value),
                                 bytes(msg.value)):
            raise HostError(SCErrorType.SCE_CRYPTO,
                            "signature verification failed",
                            SCErrorCode.SCEC_INVALID_INPUT)
        return VAL_VOID

    # ----- map module "m": sorted entry lists (order_key), immutable -----
    def map_entries(mh, what):
        m = ectx.obj_arg(mh, SCValType.SCV_MAP, what)
        entries = list(m.value or [])
        # maps built by these host fns are sorted by construction, but an
        # SCV_MAP can also arrive from invocation args or storage —
        # validate the order invariant binary search depends on, exactly
        # as the real env rejects unsorted/duplicate-key maps at the
        # host boundary
        host.budget.charge(len(entries))
        for i in range(1, len(entries)):
            if not order_key(entries[i - 1].key) < order_key(entries[i].key):
                raise HostError(SCErrorType.SCE_OBJECT,
                                f"{what}: map not sorted/deduped",
                                SCErrorCode.SCEC_INVALID_INPUT)
        return entries

    def map_find(entries, key: SCVal):
        ko = order_key(key)
        lo, hi = 0, len(entries)
        while lo < hi:                      # binary search on the order
            mid = (lo + hi) // 2
            if order_key(entries[mid].key) < ko:
                lo = mid + 1
            else:
                hi = mid
        found = lo < len(entries) and entries[lo].key == key
        return lo, found

    def map_new(inst):
        return ectx.put_obj(SCVal(SCValType.SCV_MAP, []))

    def map_put(inst, mh, kval, vval):
        entries = map_entries(mh, "map_put")
        key, val = ectx.from_val(kval), ectx.from_val(vval)
        i, found = map_find(entries, key)
        entry = SCMapEntry(key=key, val=val)
        if found:
            entries[i] = entry
        else:
            entries.insert(i, entry)
        host.budget.charge(len(entries))
        return ectx.put_obj(SCVal(SCValType.SCV_MAP, entries))

    def map_get(inst, mh, kval):
        entries = map_entries(mh, "map_get")
        i, found = map_find(entries, ectx.from_val(kval))
        if not found:
            raise HostError(SCErrorType.SCE_OBJECT, "map key missing",
                            SCErrorCode.SCEC_MISSING_VALUE)
        return ectx.to_val(entries[i].val)

    def map_has(inst, mh, kval):
        _, found = map_find(map_entries(mh, "map_has"),
                            ectx.from_val(kval))
        return VAL_TRUE if found else VAL_FALSE

    def map_del(inst, mh, kval):
        entries = map_entries(mh, "map_del")
        i, found = map_find(entries, ectx.from_val(kval))
        if not found:
            raise HostError(SCErrorType.SCE_OBJECT, "map key missing",
                            SCErrorCode.SCEC_MISSING_VALUE)
        del entries[i]
        return ectx.put_obj(SCVal(SCValType.SCV_MAP, entries))

    def map_len(inst, mh):
        return (len(map_entries(mh, "map_len")) << 4) | TAG_U32

    def map_keys(inst, mh):
        return ectx.put_obj(SCVal(
            SCValType.SCV_VEC,
            [e.key for e in map_entries(mh, "map_keys")]))

    def map_values(inst, mh):
        return ectx.put_obj(SCVal(
            SCValType.SCV_VEC,
            [e.val for e in map_entries(mh, "map_values")]))

    # ----- vec module "v" extensions -----
    def vec_items(vh, what):
        v = ectx.obj_arg(vh, SCValType.SCV_VEC, what)
        return list(v.value or [])

    def vec_front(inst, vh):
        items = vec_items(vh, "vec_front")
        if not items:
            raise HostError(SCErrorType.SCE_OBJECT, "empty vec",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        return ectx.to_val(items[0])

    def vec_back(inst, vh):
        items = vec_items(vh, "vec_back")
        if not items:
            raise HostError(SCErrorType.SCE_OBJECT, "empty vec",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        return ectx.to_val(items[-1])

    def vec_insert(inst, vh, ival, xval):
        items = vec_items(vh, "vec_insert")
        i = ectx.u32_arg(ival, "vec_insert")
        if i > len(items):
            raise HostError(SCErrorType.SCE_OBJECT, "vec_insert oob",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        items.insert(i, ectx.from_val(xval))
        return ectx.put_obj(SCVal(SCValType.SCV_VEC, items))

    def vec_del(inst, vh, ival):
        items = vec_items(vh, "vec_del")
        i = ectx.u32_arg(ival, "vec_del")
        if i >= len(items):
            raise HostError(SCErrorType.SCE_OBJECT, "vec_del oob",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        del items[i]
        return ectx.put_obj(SCVal(SCValType.SCV_VEC, items))

    def vec_append(inst, vh1, vh2):
        items = vec_items(vh1, "vec_append") + vec_items(vh2, "vec_append")
        host.budget.charge(len(items))
        return ectx.put_obj(SCVal(SCValType.SCV_VEC, items))

    def vec_slice(inst, vh, sval, eval_):
        items = vec_items(vh, "vec_slice")
        s = ectx.u32_arg(sval, "vec_slice")
        e = ectx.u32_arg(eval_, "vec_slice")
        if s > e or e > len(items):
            raise HostError(SCErrorType.SCE_OBJECT, "vec_slice oob",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        return ectx.put_obj(SCVal(SCValType.SCV_VEC, items[s:e]))

    # ----- bytes module "b" extensions -----
    def bytes_arg(bh, what):
        return ectx.obj_arg(bh, SCValType.SCV_BYTES, what)

    def bytes_new(inst):
        return ectx.put_obj(SCVal(SCValType.SCV_BYTES, b""))

    def bytes_append(inst, bh1, bh2):
        data = bytes(bytes_arg(bh1, "bytes_append").value) + \
            bytes(bytes_arg(bh2, "bytes_append").value)
        host.budget.charge(len(data))
        return ectx.put_obj(SCVal(SCValType.SCV_BYTES, data))

    def bytes_slice(inst, bh, sval, eval_):
        data = bytes(bytes_arg(bh, "bytes_slice").value)
        s = ectx.u32_arg(sval, "bytes_slice")
        e = ectx.u32_arg(eval_, "bytes_slice")
        if s > e or e > len(data):
            raise HostError(SCErrorType.SCE_OBJECT, "bytes_slice oob",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        return ectx.put_obj(SCVal(SCValType.SCV_BYTES, data[s:e]))

    def bytes_push(inst, bh, xval):
        data = bytes(bytes_arg(bh, "bytes_push").value)
        x = ectx.u32_arg(xval, "bytes_push")
        if x > 0xFF:
            raise HostError(SCErrorType.SCE_VALUE, "bytes_push: not a byte",
                            SCErrorCode.SCEC_INVALID_INPUT)
        return ectx.put_obj(SCVal(SCValType.SCV_BYTES,
                                  data + bytes([x])))

    def bytes_get(inst, bh, ival):
        data = bytes(bytes_arg(bh, "bytes_get").value)
        i = ectx.u32_arg(ival, "bytes_get")
        if i >= len(data):
            raise HostError(SCErrorType.SCE_OBJECT, "bytes_get oob",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        return (data[i] << 4) | TAG_U32

    def bytes_put(inst, bh, ival, xval):
        data = bytearray(bytes_arg(bh, "bytes_put").value)
        i = ectx.u32_arg(ival, "bytes_put")
        x = ectx.u32_arg(xval, "bytes_put")
        if i >= len(data):
            raise HostError(SCErrorType.SCE_OBJECT, "bytes_put oob",
                            SCErrorCode.SCEC_INDEX_BOUNDS)
        if x > 0xFF:
            raise HostError(SCErrorType.SCE_VALUE,
                            "bytes_put: not a byte",
                            SCErrorCode.SCEC_INVALID_INPUT)
        data[i] = x
        return ectx.put_obj(SCVal(SCValType.SCV_BYTES, bytes(data)))

    def bytes_copy_from_linear_memory(inst, bh, bpos, mpos, lval):
        data = bytearray(bytes_arg(bh, "bytes_copy_from").value)
        bp = ectx.u32_arg(bpos, "bytes_copy_from")
        mp = ectx.u32_arg(mpos, "bytes_copy_from")
        ln = ectx.u32_arg(lval, "bytes_copy_from")
        host.budget.charge(ln)
        if mp + ln > len(inst.memory):
            raise WasmTrap("oob", "bytes_copy_from_linear_memory")
        if bp + ln > len(data):
            data.extend(b"\x00" * (bp + ln - len(data)))
        data[bp:bp + ln] = inst.memory[mp:mp + ln]
        return ectx.put_obj(SCVal(SCValType.SCV_BYTES, bytes(data)))

    # ----- int module "i" extensions: i64 / i128 / u128 pieces -----
    def obj_from_i64(inst, raw):
        x = raw & ((1 << 64) - 1)
        return ectx.put_obj(SCVal(SCValType.SCV_I64,
                                  x - (1 << 64) if x >> 63 else x))

    def obj_to_i64(inst, oh):
        v = ectx.obj_arg(oh, SCValType.SCV_I64, "obj_to_i64")
        return int(v.value) & ((1 << 64) - 1)

    def obj_from_i128_pieces(inst, hi, lo):
        h = hi & ((1 << 64) - 1)
        return ectx.put_obj(SCVal(
            SCValType.SCV_I128,
            Int128Parts(hi=h - (1 << 64) if h >> 63 else h,
                        lo=lo & ((1 << 64) - 1))))

    def obj_to_i128_lo64(inst, oh):
        v = ectx.obj_arg(oh, SCValType.SCV_I128, "obj_to_i128_lo64")
        return int(v.value.lo) & ((1 << 64) - 1)

    def obj_to_i128_hi64(inst, oh):
        v = ectx.obj_arg(oh, SCValType.SCV_I128, "obj_to_i128_hi64")
        return int(v.value.hi) & ((1 << 64) - 1)

    def obj_from_u128_pieces(inst, hi, lo):
        return ectx.put_obj(SCVal(
            SCValType.SCV_U128,
            UInt128Parts(hi=hi & ((1 << 64) - 1),
                         lo=lo & ((1 << 64) - 1))))

    def obj_to_u128_lo64(inst, oh):
        v = ectx.obj_arg(oh, SCValType.SCV_U128, "obj_to_u128_lo64")
        return int(v.value.lo) & ((1 << 64) - 1)

    def obj_to_u128_hi64(inst, oh):
        v = ectx.obj_arg(oh, SCValType.SCV_U128, "obj_to_u128_hi64")
        return int(v.value.hi) & ((1 << 64) - 1)

    def timepoint_obj_from_u64(inst, raw):
        return ectx.put_obj(SCVal(SCValType.SCV_TIMEPOINT,
                                  raw & ((1 << 64) - 1)))

    def timepoint_obj_to_u64(inst, oh):
        v = ectx.obj_arg(oh, SCValType.SCV_TIMEPOINT, "timepoint_to_u64")
        return int(v.value) & ((1 << 64) - 1)

    def duration_obj_from_u64(inst, raw):
        return ectx.put_obj(SCVal(SCValType.SCV_DURATION,
                                  raw & ((1 << 64) - 1)))

    def duration_obj_to_u64(inst, oh):
        v = ectx.obj_arg(oh, SCValType.SCV_DURATION, "duration_to_u64")
        return int(v.value) & ((1 << 64) - 1)

    # ----- int module "i": the 256-bit families (reference embeds the
    # full soroban-env interface incl. these via the bridge,
    # rust/src/contract.rs + Cargo.toml:27-56; checked semantics —
    # add/sub/mul/div/rem/pow error on overflow, shifts error at >=256)
    M64 = (1 << 64) - 1
    U256_MAX = (1 << 256) - 1
    I256_MIN, I256_MAX = -(1 << 255), (1 << 255) - 1

    def _arith_err(what):
        return HostError(SCErrorType.SCE_VALUE, f"{what}: out of range",
                         SCErrorCode.SCEC_ARITH_DOMAIN)

    def _u256_int(v: SCVal) -> int:
        p = v.value
        return (int(p.hi_hi) << 192) | (int(p.hi_lo) << 128) | \
            (int(p.lo_hi) << 64) | int(p.lo_lo)

    def _i256_int(v: SCVal) -> int:
        p = v.value
        x = ((int(p.hi_hi) & M64) << 192) | (int(p.hi_lo) << 128) | \
            (int(p.lo_hi) << 64) | int(p.lo_lo)
        return x - (1 << 256) if x >> 255 else x

    def _mk_u256(x: int) -> SCVal:
        return SCVal(SCValType.SCV_U256, UInt256Parts(
            hi_hi=(x >> 192) & M64, hi_lo=(x >> 128) & M64,
            lo_hi=(x >> 64) & M64, lo_lo=x & M64))

    def _mk_i256(x: int) -> SCVal:
        u = x & ((1 << 256) - 1)
        hi_hi = (u >> 192) & M64
        return SCVal(SCValType.SCV_I256, Int256Parts(
            hi_hi=hi_hi - (1 << 64) if hi_hi >> 63 else hi_hi,
            hi_lo=(u >> 128) & M64,
            lo_hi=(u >> 64) & M64, lo_lo=u & M64))

    def _u256_arg(vh, what) -> int:
        return _u256_int(ectx.obj_arg(vh, SCValType.SCV_U256, what))

    def _i256_arg(vh, what) -> int:
        return _i256_int(ectx.obj_arg(vh, SCValType.SCV_I256, what))

    def obj_from_u256_pieces(inst, hi_hi, hi_lo, lo_hi, lo_lo):
        return ectx.put_obj(SCVal(SCValType.SCV_U256, UInt256Parts(
            hi_hi=hi_hi & M64, hi_lo=hi_lo & M64,
            lo_hi=lo_hi & M64, lo_lo=lo_lo & M64)))

    def u256_val_from_be_bytes(inst, bh):
        raw = bytes(bytes_arg(bh, "u256_from_be_bytes").value)
        if len(raw) != 32:
            raise HostError(SCErrorType.SCE_VALUE,
                            "u256 bytes must be 32 long",
                            SCErrorCode.SCEC_INVALID_INPUT)
        return ectx.put_obj(_mk_u256(int.from_bytes(raw, "big")))

    def u256_val_to_be_bytes(inst, vh):
        x = _u256_arg(vh, "u256_to_be_bytes")
        return ectx.put_obj(SCVal(SCValType.SCV_BYTES,
                                  x.to_bytes(32, "big")))

    def _u256_piece(which, shift):
        def get(inst, vh):
            return (_u256_arg(vh, which) >> shift) & M64
        return get

    def obj_from_i256_pieces(inst, hi_hi, hi_lo, lo_hi, lo_lo):
        h = hi_hi & M64
        return ectx.put_obj(SCVal(SCValType.SCV_I256, Int256Parts(
            hi_hi=h - (1 << 64) if h >> 63 else h, hi_lo=hi_lo & M64,
            lo_hi=lo_hi & M64, lo_lo=lo_lo & M64)))

    def i256_val_from_be_bytes(inst, bh):
        raw = bytes(bytes_arg(bh, "i256_from_be_bytes").value)
        if len(raw) != 32:
            raise HostError(SCErrorType.SCE_VALUE,
                            "i256 bytes must be 32 long",
                            SCErrorCode.SCEC_INVALID_INPUT)
        return ectx.put_obj(_mk_i256(
            int.from_bytes(raw, "big", signed=True)))

    def i256_val_to_be_bytes(inst, vh):
        x = _i256_arg(vh, "i256_to_be_bytes")
        return ectx.put_obj(SCVal(
            SCValType.SCV_BYTES, x.to_bytes(32, "big", signed=True)))

    def _i256_piece(which, shift):
        def get(inst, vh):
            u = _i256_arg(vh, which) & ((1 << 256) - 1)
            return (u >> shift) & M64
        return get

    def _u256_binop(name, op):
        def fn(inst, ah, bh):
            r = op(_u256_arg(ah, name), _u256_arg(bh, name))
            if r is None or not 0 <= r <= U256_MAX:
                raise _arith_err(name)
            return ectx.put_obj(_mk_u256(r))
        return fn

    def _i256_binop(name, op):
        def fn(inst, ah, bh):
            r = op(_i256_arg(ah, name), _i256_arg(bh, name))
            if r is None or not I256_MIN <= r <= I256_MAX:
                raise _arith_err(name)
            return ectx.put_obj(_mk_i256(r))
        return fn

    def _div(a, b):
        if b == 0:
            return None
        q = abs(a) // abs(b)          # truncated division, Rust-style
        return -q if (a < 0) != (b < 0) else q

    def _rem_euclid(a, b):
        # always in [0, |b|): python % with a positive modulus is
        # already Euclidean
        return None if b == 0 else a % abs(b)

    def _u256_shiftop(name, is_left):
        def fn(inst, vh, bits_val):
            bits = ectx.u32_arg(bits_val, name)
            if bits >= 256:
                raise _arith_err(name)
            x = _u256_arg(vh, name)
            r = (x << bits) & U256_MAX if is_left else x >> bits
            return ectx.put_obj(_mk_u256(r))
        return fn

    def _i256_shiftop(name, is_left):
        def fn(inst, vh, bits_val):
            bits = ectx.u32_arg(bits_val, name)
            if bits >= 256:
                raise _arith_err(name)
            x = _i256_arg(vh, name)
            if is_left:
                u = (x << bits) & ((1 << 256) - 1)
                r = u - (1 << 256) if u >> 255 else u
            else:
                r = x >> bits              # arithmetic: sign-extends
            return ectx.put_obj(_mk_i256(r))
        return fn

    def _checked_pow(x: int, p: int, name: str) -> int:
        """x ** p with the overflow check BEFORE evaluation: the
        exponent is attacker-chosen u32, and python would happily
        materialize a multi-hundred-MB integer first (checked_pow in
        the Rust host rejects at the first overflowing multiply)."""
        if p == 0:
            return 1
        ax = abs(x)
        if ax <= 1:
            return x ** (1 + (p - 1) % 2) if x < 0 else x
        # ax >= 2: result bit length >= (bit_length-1)*p + 1 > 256
        # guarantees overflow without computing the power
        if (ax.bit_length() - 1) * p + 1 > 257:
            raise _arith_err(name)
        return x ** p

    def _u256_pow(inst, vh, pow_val):
        p = ectx.u32_arg(pow_val, "u256_pow")
        r = _checked_pow(_u256_arg(vh, "u256_pow"), p, "u256_pow")
        if r > U256_MAX:
            raise _arith_err("u256_pow")
        return ectx.put_obj(_mk_u256(r))

    def _i256_pow(inst, vh, pow_val):
        p = ectx.u32_arg(pow_val, "i256_pow")
        r = _checked_pow(_i256_arg(vh, "i256_pow"), p, "i256_pow")
        if not I256_MIN <= r <= I256_MAX:
            raise _arith_err("i256_pow")
        return ectx.put_obj(_mk_i256(r))

    u256_add = _u256_binop("u256_add", lambda a, b: a + b)
    u256_sub = _u256_binop("u256_sub", lambda a, b: a - b)
    u256_mul = _u256_binop("u256_mul", lambda a, b: a * b)
    u256_div = _u256_binop("u256_div", _div)
    u256_rem_euclid = _u256_binop("u256_rem_euclid", _rem_euclid)
    u256_shl = _u256_shiftop("u256_shl", True)
    u256_shr = _u256_shiftop("u256_shr", False)
    i256_add = _i256_binop("i256_add", lambda a, b: a + b)
    i256_sub = _i256_binop("i256_sub", lambda a, b: a - b)
    i256_mul = _i256_binop("i256_mul", lambda a, b: a * b)
    i256_div = _i256_binop("i256_div", _div)
    i256_rem_euclid = _i256_binop("i256_rem_euclid", _rem_euclid)
    i256_shl = _i256_shiftop("i256_shl", True)
    i256_shr = _i256_shiftop("i256_shr", False)

    # ----- string module "s" -----
    def string_new_from_linear_memory(inst, pval, lval):
        ptr = ectx.u32_arg(pval, "string_new")
        ln = ectx.u32_arg(lval, "string_new")
        host.budget.charge(ln)
        if ptr + ln > len(inst.memory):
            raise WasmTrap("oob", "string_new_from_linear_memory")
        return ectx.put_obj(SCVal(SCValType.SCV_STRING,
                                  bytes(inst.memory[ptr:ptr + ln])))

    def string_len(inst, sh):
        v = ectx.obj_arg(sh, SCValType.SCV_STRING, "string_len")
        return (len(v.value) << 4) | TAG_U32

    def string_copy_to_linear_memory(inst, sh, spos, mpos, lval):
        v = ectx.obj_arg(sh, SCValType.SCV_STRING, "string_copy")
        sp = ectx.u32_arg(spos, "string_copy")
        mp = ectx.u32_arg(mpos, "string_copy")
        ln = ectx.u32_arg(lval, "string_copy")
        host.budget.charge(ln)
        data = bytes(v.value)
        if sp + ln > len(data) or mp + ln > len(inst.memory):
            raise WasmTrap("oob", "string_copy_to_linear_memory")
        inst.memory[mp:mp + ln] = data[sp:sp + ln]
        return VAL_VOID

    # ----- ledger module "l" extensions: TTL -----
    def extend_contract_data_ttl(inst, kval, tval, eval_):
        host.extend_entry_ttl(data_key(kval),
                              ectx.u32_arg(tval, "extend_ttl"),
                              ectx.u32_arg(eval_, "extend_ttl"))
        return VAL_VOID

    def extend_instance_ttl(inst, tval, eval_):
        from .host import instance_key
        host.extend_entry_ttl(instance_key(ectx.contract),
                              ectx.u32_arg(tval, "extend_instance_ttl"),
                              ectx.u32_arg(eval_, "extend_instance_ttl"))
        return VAL_VOID

    # 3-arg put with an explicit StorageType (the CURRENT env interface
    # shape — the vendored example binaries predate it, so the 2-arg
    # persistent put keeps position "_"; this one is appended):
    # storage 0=temporary, 1=persistent
    def put_contract_data_t(inst, kval, vval, tval):
        t = ectx.u32_arg(tval, "put_contract_data_t")
        if t not in (0, 1):
            raise HostError(SCErrorType.SCE_VALUE, "bad storage type",
                            SCErrorCode.SCEC_INVALID_INPUT)
        dur = ContractDataDurability.TEMPORARY if t == 0 \
            else ContractDataDurability.PERSISTENT
        key = ectx.from_val(kval)
        val = ectx.from_val(vval)
        lk = LedgerKey.contract_data(ectx.contract, key, dur)
        host.put_entry(lk, LedgerEntry(
            lastModifiedLedgerSeq=host.header.ledgerSeq,
            data=_LedgerEntryData(
                LedgerEntryType.CONTRACT_DATA,
                ContractDataEntry(
                    ext=ExtensionPoint(0), contract=ectx.contract,
                    key=key, durability=dur, val=val)),
            ext=_LedgerEntryExt(0)), durability=dur)
        return VAL_VOID

    # ----- context module "x" extensions -----
    def get_ledger_timestamp(inst):
        return ectx.put_obj(SCVal(SCValType.SCV_TIMEPOINT,
                                  int(host.header.scpValue.closeTime)))

    def get_ledger_network_id(inst):
        return ectx.put_obj(SCVal(SCValType.SCV_BYTES, host.network_id))

    def log_from_linear_memory(inst, mpval, mlval, vpval, vlval):
        mp = ectx.u32_arg(mpval, "log")
        ml = ectx.u32_arg(mlval, "log")
        vp = ectx.u32_arg(vpval, "log")
        vl = ectx.u32_arg(vlval, "log")
        if mp + ml > len(inst.memory) or vp + 8 * vl > len(inst.memory):
            raise WasmTrap("oob", "log_from_linear_memory")
        vals = []
        for i in range(vl):
            raw = int.from_bytes(
                inst.memory[vp + 8 * i:vp + 8 * i + 8], "little")
            vals.append(ectx.from_val(raw))
        host.log_diagnostic(bytes(inst.memory[mp:mp + ml]), vals)
        return VAL_VOID

    # ----- prng module "p": deterministic per-FRAME DRBG -----
    # host.prng_frame_seed mixes a per-host frame counter, the source
    # account, ledger seq and contract, so repeated invocations (two
    # cross-contract calls in one tx, two txs in one ledger) draw
    # distinct — but validator-reproducible — streams
    prng_state = {"seed": host.prng_frame_seed(ectx.contract.to_bytes()),
                  "ctr": 0}

    def prng_next_u64():
        block = sha256(prng_state["seed"] +
                       prng_state["ctr"].to_bytes(8, "big"))
        prng_state["ctr"] += 1
        return int.from_bytes(block[:8], "big")

    def prng_draw(span: int) -> int:
        """Unbiased draw in [0, span) by rejection sampling."""
        limit = ((1 << 64) // span) * span
        x = prng_next_u64()
        while x >= limit:
            x = prng_next_u64()
        return x % span

    def prng_reseed(inst, bh):
        prng_state["seed"] = sha256(bytes(bytes_arg(bh, "reseed").value))
        prng_state["ctr"] = 0
        return VAL_VOID

    def prng_u64_in_inclusive_range(inst, lo, hi):
        lo &= (1 << 64) - 1
        hi &= (1 << 64) - 1
        if lo > hi:
            raise HostError(SCErrorType.SCE_VALUE, "empty prng range",
                            SCErrorCode.SCEC_INVALID_INPUT)
        return ectx.put_obj(SCVal(SCValType.SCV_U64,
                                  lo + prng_draw(hi - lo + 1)))

    def prng_vec_shuffle(inst, vh):
        items = vec_items(vh, "prng_vec_shuffle")
        # Fisher-Yates; unbiased index draws (same rejection sampler
        # as the range fn — a plain modulo skews permutations)
        for i in range(len(items) - 1, 0, -1):
            j = prng_draw(i + 1)
            items[i], items[j] = items[j], items[i]
        return ectx.put_obj(SCVal(SCValType.SCV_VEC, items))

    modules: Dict[str, List[Tuple[int, object]]] = {
        # (n_params, fn) in positional order; name = FN_NAME_SEQ[i]
        # observed positions (env_contract.py + the reference binaries
        # link against these) come FIRST and never move; the extensions
        # behind them are framework-pinned in this order
        "l": [(2, put_contract_data), (1, has_contract_data),
              (1, get_contract_data), (1, del_contract_data),
              (3, extend_contract_data_ttl), (2, extend_instance_ttl),
              (3, put_contract_data_t)],
        "x": [(2, obj_cmp), (2, contract_event), (0, current_address),
              (0, ledger_seq), (1, fail_with_error),
              (0, get_ledger_timestamp), (0, get_ledger_network_id),
              (4, log_from_linear_memory)],
        "v": [(0, vec_new), (2, vec_push_back), (2, vec_get),
              (1, vec_len), (1, vec_front), (1, vec_back),
              (3, vec_insert), (2, vec_del), (2, vec_append),
              (3, vec_slice)],
        "b": [(2, bytes_new_from_linear_memory), (1, bytes_len),
              (4, bytes_copy_to_linear_memory), (0, bytes_new),
              (2, bytes_append), (3, bytes_slice), (2, bytes_push),
              (2, bytes_get), (3, bytes_put),
              (4, bytes_copy_from_linear_memory)],
        "i": [(1, obj_from_u64), (1, obj_to_u64), (1, obj_from_i64),
              (1, obj_to_i64), (2, obj_from_i128_pieces),
              (1, obj_to_i128_lo64), (1, obj_to_i128_hi64),
              (2, obj_from_u128_pieces), (1, obj_to_u128_lo64),
              (1, obj_to_u128_hi64), (1, timepoint_obj_from_u64),
              (1, timepoint_obj_to_u64),
              # 256-bit families (positions 12..41, framework-pinned)
              (4, obj_from_u256_pieces),
              (1, u256_val_from_be_bytes), (1, u256_val_to_be_bytes),
              (1, _u256_piece("obj_to_u256_hi_hi", 192)),
              (1, _u256_piece("obj_to_u256_hi_lo", 128)),
              (1, _u256_piece("obj_to_u256_lo_hi", 64)),
              (1, _u256_piece("obj_to_u256_lo_lo", 0)),
              (4, obj_from_i256_pieces),
              (1, i256_val_from_be_bytes), (1, i256_val_to_be_bytes),
              (1, _i256_piece("obj_to_i256_hi_hi", 192)),
              (1, _i256_piece("obj_to_i256_hi_lo", 128)),
              (1, _i256_piece("obj_to_i256_lo_hi", 64)),
              (1, _i256_piece("obj_to_i256_lo_lo", 0)),
              (2, u256_add), (2, u256_sub), (2, u256_mul),
              (2, u256_div), (2, u256_rem_euclid), (2, _u256_pow),
              (2, u256_shl), (2, u256_shr),
              (2, i256_add), (2, i256_sub), (2, i256_mul),
              (2, i256_div), (2, i256_rem_euclid), (2, _i256_pow),
              (2, i256_shl), (2, i256_shr),
              (1, duration_obj_from_u64), (1, duration_obj_to_u64)],
        "a": [(1, require_auth)],
        "d": [(3, call)],
        "c": [(1, compute_hash_sha256), (3, verify_sig_ed25519)],
        "m": [(0, map_new), (3, map_put), (2, map_get), (2, map_has),
              (2, map_del), (1, map_len), (1, map_keys),
              (1, map_values)],
        "s": [(2, string_new_from_linear_memory), (1, string_len),
              (4, string_copy_to_linear_memory)],
        "p": [(1, prng_reseed), (2, prng_u64_in_inclusive_range),
              (1, prng_vec_shuffle)],
    }
    table: Dict[Tuple[str, str], HostFunc] = {}
    for mod, fns in modules.items():
        for i, (nparams, fn) in enumerate(fns):
            table[(mod, fn_name(i))] = HostFunc(
                [I64] * nparams, [I64], charge(fn))
    return table


ENV_MODULES = frozenset("lxvbiadcmsp")


def is_env_abi_module(module) -> bool:
    """True when the contract targets the real env ABI: every function
    import is a single-letter env module with a positional short name.
    Import-free modules count as env-ABI when they carry the SDK's
    ``"_"`` interface-marker export (both reference contracts do);
    contracts built by the in-repo scvm_wasm compiler import the
    long-name bespoke functions instead and fall through to that ABI.
    """
    func_imports = [im for im in module.imports if im.kind == 0]
    if func_imports:
        return all(im.module in ENV_MODULES and len(im.name) == 1
                   and im.name in FN_NAME_SEQ
                   for im in func_imports)
    exp = module.export_map().get("_")
    return exp is not None and exp.kind == 0
