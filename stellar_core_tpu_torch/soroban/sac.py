"""Built-in Stellar Asset Contract (SAC).

Reference: the host the node embeds ships a native token contract for
`CONTRACT_EXECUTABLE_STELLAR_ASSET` (rust/src/contract.rs:261-340 wraps
that host; driven from transactions/InvokeHostFunctionOpFrame.cpp:364).
It exposes the SEP-41 token interface over *classic* state: balances of
account addresses live in trustlines (or the native account balance),
balances of contract addresses live in contract-data entries; transfers
respect classic authorization flags, limits, liabilities and reserves,
and the issuer account mints on send / burns on receive exactly like a
classic payment. This module is that contract, built natively over
LedgerTxn through the host's footprint/budget discipline.

Interface (SEP-41 + the admin surface of the reference SAC):
  balance, transfer, transfer_from, approve, allowance, burn, burn_from,
  decimals, name, symbol, mint, admin, set_admin, authorized,
  set_authorized, clawback.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..crypto.strkey import StrKey
from ..tx import tx_utils
from ..xdr.contract import (ContractDataDurability, ContractDataEntry,
                            Int128Parts, SCAddress, SCAddressType,
                            SCErrorCode, SCErrorType, SCMapEntry, SCVal,
                            SCValType)
from ..xdr.ledger_entries import (AccountFlags, Asset, AssetType,
                                  LedgerEntry, LedgerEntryType, LedgerKey,
                                  TrustLineAsset, TrustLineFlags,
                                  _LedgerEntryData, _LedgerEntryExt)
from ..xdr.types import ExtensionPoint
from .host import HostError

INT64_MAX = 2 ** 63 - 1
I128_MAX = 2 ** 127 - 1
I128_MIN = -(2 ** 127)

DECIMALS = 7


# ----------------------------------------------------------- SCVal helpers --

def sym(s: bytes) -> SCVal:
    return SCVal(SCValType.SCV_SYMBOL, s)


def sc_i128(v: int) -> SCVal:
    if not (I128_MIN <= v <= I128_MAX):
        raise HostError(SCErrorType.SCE_VALUE, "i128 overflow",
                        SCErrorCode.SCEC_ARITH_DOMAIN)
    # hi is the signed high limb (arithmetic shift), lo the unsigned low
    return SCVal(SCValType.SCV_I128,
                 Int128Parts(hi=v >> 64, lo=v & ((1 << 64) - 1)))


def i128_of(val: SCVal) -> int:
    if val.disc != SCValType.SCV_I128:
        raise HostError(SCErrorType.SCE_VALUE, "expected i128",
                        SCErrorCode.SCEC_UNEXPECTED_TYPE)
    p = val.value
    return (p.hi << 64) | p.lo


def address_of(val: SCVal) -> SCAddress:
    if val.disc != SCValType.SCV_ADDRESS:
        raise HostError(SCErrorType.SCE_VALUE, "expected address",
                        SCErrorCode.SCEC_UNEXPECTED_TYPE)
    return val.value


def u32_of(val: SCVal) -> int:
    if val.disc != SCValType.SCV_U32:
        raise HostError(SCErrorType.SCE_VALUE, "expected u32",
                        SCErrorCode.SCEC_UNEXPECTED_TYPE)
    return int(val.value)


def bool_of(val: SCVal) -> bool:
    if val.disc != SCValType.SCV_BOOL:
        raise HostError(SCErrorType.SCE_VALUE, "expected bool",
                        SCErrorCode.SCEC_UNEXPECTED_TYPE)
    return bool(val.value)


def _addr_scval(addr: SCAddress) -> SCVal:
    return SCVal(SCValType.SCV_ADDRESS, addr)


def sep11(asset: Asset) -> str:
    """SEP-0011 asset string: 'native' or 'CODE:G...' (the reference SAC
    uses this for `name` and the asset topic of every token event)."""
    if asset.disc == AssetType.ASSET_TYPE_NATIVE:
        return "native"
    an = asset.value
    code = bytes(an.assetCode).rstrip(b"\x00").decode("ascii")
    issuer = StrKey.encode_ed25519_public(bytes(an.issuer.value))
    return f"{code}:{issuer}"


def asset_code_str(asset: Asset) -> str:
    if asset.disc == AssetType.ASSET_TYPE_NATIVE:
        return "native"
    return bytes(asset.value.assetCode).rstrip(b"\x00").decode("ascii")


# ------------------------------------------------------------ storage keys --

def balance_key(contract: SCAddress, holder: SCAddress) -> LedgerKey:
    """Contract-address balances: persistent contract-data entry keyed
    ["Balance", holder] under the SAC's own contract id (matching the
    reference SAC's DataKey::Balance shape)."""
    return LedgerKey.contract_data(
        contract,
        SCVal(SCValType.SCV_VEC, [sym(b"Balance"),
                                  SCVal(SCValType.SCV_ADDRESS, holder)]),
        ContractDataDurability.PERSISTENT)


def allowance_key(contract: SCAddress, from_a: SCAddress,
                  spender: SCAddress) -> LedgerKey:
    """Allowances are TEMPORARY entries (reference SAC
    DataKey::Allowance): their TTL *is* the expiration mechanism."""
    return LedgerKey.contract_data(
        contract,
        SCVal(SCValType.SCV_VEC, [sym(b"Allowance"),
                                  SCVal(SCValType.SCV_ADDRESS, from_a),
                                  SCVal(SCValType.SCV_ADDRESS, spender)]),
        ContractDataDurability.TEMPORARY)


def _balance_map(amount: int, authorized: bool, clawback: bool) -> SCVal:
    return SCVal(SCValType.SCV_MAP, [
        SCMapEntry(key=sym(b"amount"), val=sc_i128(amount)),
        SCMapEntry(key=sym(b"authorized"),
                   val=SCVal(SCValType.SCV_BOOL, authorized)),
        SCMapEntry(key=sym(b"clawback"),
                   val=SCVal(SCValType.SCV_BOOL, clawback)),
    ])


def _read_balance_map(val: SCVal) -> Tuple[int, bool, bool]:
    amount, authorized, clawback = 0, True, False
    for me in (val.value or []):
        k = bytes(me.key.value)
        if k == b"amount":
            amount = i128_of(me.val)
        elif k == b"authorized":
            authorized = bool(me.val.value)
        elif k == b"clawback":
            clawback = bool(me.val.value)
    return amount, authorized, clawback


# ------------------------------------------------------------ the contract --

class StellarAssetContract:
    """One invocation-scoped view of the built-in token for `asset`,
    executing against the host's footprint/budget/auth machinery."""

    def __init__(self, host, contract: SCAddress, asset: Asset,
                 admin: Optional[SCAddress]):
        self.host = host
        self.contract = contract
        self.asset = asset
        self.admin = admin          # None for the native SAC
        self.is_native = asset.disc == AssetType.ASSET_TYPE_NATIVE

    # ------------------------------------------------------------ dispatch --
    def invoke(self, fn: bytes, args: List[SCVal]) -> SCVal:
        name = fn.decode("ascii", "replace")
        handler = {
            "balance": self._fn_balance,
            "transfer": self._fn_transfer,
            "transfer_from": self._fn_transfer_from,
            "approve": self._fn_approve,
            "allowance": self._fn_allowance,
            "burn": self._fn_burn,
            "burn_from": self._fn_burn_from,
            "decimals": self._fn_decimals,
            "name": self._fn_name,
            "symbol": self._fn_symbol,
            "mint": self._fn_mint,
            "admin": self._fn_admin,
            "set_admin": self._fn_set_admin,
            "authorized": self._fn_authorized,
            "set_authorized": self._fn_set_authorized,
            "clawback": self._fn_clawback,
        }.get(name)
        if handler is None:
            raise HostError(SCErrorType.SCE_CONTEXT,
                            f"SAC has no function {name!r}",
                            SCErrorCode.SCEC_MISSING_VALUE)
        return handler(args)

    # ------------------------------------------------------------ metadata --
    def _fn_decimals(self, args) -> SCVal:
        return SCVal(SCValType.SCV_U32, DECIMALS)

    def _fn_name(self, args) -> SCVal:
        return SCVal(SCValType.SCV_STRING,
                     sep11(self.asset).encode("ascii"))

    def _fn_symbol(self, args) -> SCVal:
        return SCVal(SCValType.SCV_STRING,
                     asset_code_str(self.asset).encode("ascii"))

    # ------------------------------------------------------------- balance --
    def _fn_balance(self, args) -> SCVal:
        addr = address_of(self._arg(args, 0))
        return sc_i128(self._get_balance(addr))

    def _get_balance(self, addr: SCAddress) -> int:
        if addr.disc == SCAddressType.SC_ADDRESS_TYPE_ACCOUNT:
            if self.is_native:
                le = self._load_classic(
                    LedgerKey.account(addr.value), write=False)
                return le.data.value.balance if le is not None else 0
            if self._is_issuer(addr):
                # the issuer's balance in its own asset is unbounded;
                # the reference host reports it as i64::MAX
                return INT64_MAX
            tl = self._load_trustline(addr, write=False)
            return tl.data.value.balance if tl is not None else 0
        le = self.host.load_entry(balance_key(self.contract, addr))
        if le is None:
            return 0
        amount, _, _ = _read_balance_map(le.data.value.val)
        return amount

    # ----------------------------------------------------------- transfers --
    def _fn_transfer(self, args) -> SCVal:
        from_a = address_of(self._arg(args, 0))
        to_a = address_of(self._arg(args, 1))
        amount = self._amount(self._arg(args, 2))
        self.host.require_auth(from_a)
        self._spend(from_a, amount)
        self._receive(to_a, amount)
        self._event(b"transfer", [_addr_scval(from_a),
                                  _addr_scval(to_a)], sc_i128(amount))
        return SCVal(SCValType.SCV_VOID)

    def _fn_mint(self, args) -> SCVal:
        to_a = address_of(self._arg(args, 0))
        amount = self._amount(self._arg(args, 1))
        admin = self._require_admin()
        self._receive(to_a, amount)
        self._event(b"mint", [_addr_scval(admin),
                              _addr_scval(to_a)], sc_i128(amount))
        return SCVal(SCValType.SCV_VOID)

    def _fn_burn(self, args) -> SCVal:
        from_a = address_of(self._arg(args, 0))
        amount = self._amount(self._arg(args, 1))
        if self.is_native:
            raise HostError(SCErrorType.SCE_CONTRACT,
                            "native asset cannot be burned",
                            SCErrorCode.SCEC_INVALID_ACTION)
        self.host.require_auth(from_a)
        self._spend(from_a, amount)
        self._event(b"burn", [_addr_scval(from_a)], sc_i128(amount))
        return SCVal(SCValType.SCV_VOID)

    def _fn_clawback(self, args) -> SCVal:
        from_a = address_of(self._arg(args, 0))
        amount = self._amount(self._arg(args, 1))
        admin = self._require_admin()
        self._spend(from_a, amount, clawback=True)
        self._event(b"clawback", [_addr_scval(admin),
                                  _addr_scval(from_a)], sc_i128(amount))
        return SCVal(SCValType.SCV_VOID)

    # ---------------------------------------------------------- allowances --
    def _fn_approve(self, args) -> SCVal:
        from_a = address_of(self._arg(args, 0))
        spender = address_of(self._arg(args, 1))
        amount = self._amount(self._arg(args, 2), allow_zero=True)
        live_until = u32_of(self._arg(args, 3))
        self.host.require_auth(from_a)
        key = allowance_key(self.contract, from_a, spender)
        if amount == 0:
            self.host.erase_entry(key)
        else:
            if live_until < self.host.header.ledgerSeq:
                raise HostError(SCErrorType.SCE_CONTRACT,
                                "allowance expiration in the past",
                                SCErrorCode.SCEC_INVALID_INPUT)
            self._put_contract_data(
                key, sc_i128(amount),
                ContractDataDurability.TEMPORARY)
            # the allowance's TTL IS its expiration (reference SAC:
            # DataKey::Allowance lives exactly until live_until)
            self.host.set_ttl(key, live_until)
        self._event(b"approve", [_addr_scval(from_a),
                                 _addr_scval(spender)],
                    SCVal(SCValType.SCV_VEC,
                          [sc_i128(amount),
                           SCVal(SCValType.SCV_U32, live_until)]))
        return SCVal(SCValType.SCV_VOID)

    def _fn_allowance(self, args) -> SCVal:
        from_a = address_of(self._arg(args, 0))
        spender = address_of(self._arg(args, 1))
        le = self.host.load_entry(
            allowance_key(self.contract, from_a, spender),
            need_live=False)
        if le is None:
            return sc_i128(0)
        key = allowance_key(self.contract, from_a, spender)
        if not self.host._is_live(key):
            return sc_i128(0)       # expired allowance reads as zero
        return le.data.value.val

    def _consume_allowance(self, from_a: SCAddress, spender: SCAddress,
                           amount: int) -> None:
        key = allowance_key(self.contract, from_a, spender)
        le = self.host.load_entry(key, need_live=False)
        cur = 0
        if le is not None and self.host._is_live(key):
            cur = i128_of(le.data.value.val)
        if cur < amount:
            raise HostError(SCErrorType.SCE_CONTRACT,
                            "insufficient allowance",
                            SCErrorCode.SCEC_INVALID_ACTION)
        if cur - amount == 0:
            self.host.erase_entry(key)
        else:
            self._put_contract_data(key, sc_i128(cur - amount),
                                    ContractDataDurability.TEMPORARY)

    def _fn_transfer_from(self, args) -> SCVal:
        spender = address_of(self._arg(args, 0))
        from_a = address_of(self._arg(args, 1))
        to_a = address_of(self._arg(args, 2))
        amount = self._amount(self._arg(args, 3))
        self.host.require_auth(spender)
        self._consume_allowance(from_a, spender, amount)
        self._spend(from_a, amount)
        self._receive(to_a, amount)
        self._event(b"transfer", [_addr_scval(from_a),
                                  _addr_scval(to_a)], sc_i128(amount))
        return SCVal(SCValType.SCV_VOID)

    def _fn_burn_from(self, args) -> SCVal:
        spender = address_of(self._arg(args, 0))
        from_a = address_of(self._arg(args, 1))
        amount = self._amount(self._arg(args, 2))
        if self.is_native:
            raise HostError(SCErrorType.SCE_CONTRACT,
                            "native asset cannot be burned",
                            SCErrorCode.SCEC_INVALID_ACTION)
        self.host.require_auth(spender)
        self._consume_allowance(from_a, spender, amount)
        self._spend(from_a, amount)
        self._event(b"burn", [_addr_scval(from_a)], sc_i128(amount))
        return SCVal(SCValType.SCV_VOID)

    # ---------------------------------------------------------------- admin --
    def _fn_admin(self, args) -> SCVal:
        if self.admin is None:
            raise HostError(SCErrorType.SCE_CONTRACT,
                            "native asset has no admin",
                            SCErrorCode.SCEC_MISSING_VALUE)
        return _addr_scval(self.admin)

    def _fn_set_admin(self, args) -> SCVal:
        new_admin = address_of(self._arg(args, 0))
        old = self._require_admin()
        self.host.sac_set_admin(self.contract, new_admin)
        self._event(b"set_admin", [_addr_scval(old)],
                    _addr_scval(new_admin))
        return SCVal(SCValType.SCV_VOID)

    def _fn_authorized(self, args) -> SCVal:
        addr = address_of(self._arg(args, 0))
        return SCVal(SCValType.SCV_BOOL, self._is_authorized(addr))

    def _fn_set_authorized(self, args) -> SCVal:
        addr = address_of(self._arg(args, 0))
        authorize = bool_of(self._arg(args, 1))
        admin = self._require_admin()
        if addr.disc == SCAddressType.SC_ADDRESS_TYPE_ACCOUNT:
            if self.is_native or self._is_issuer(addr):
                raise HostError(SCErrorType.SCE_CONTRACT,
                                "cannot (de)authorize this address",
                                SCErrorCode.SCEC_INVALID_ACTION)
            if not authorize and not self._issuer_flag(
                    AccountFlags.AUTH_REVOCABLE_FLAG):
                # classic rule: revoking requires AUTH_REVOCABLE on the
                # issuer (reference: SetTrustLineFlags semantics the SAC
                # inherits)
                raise HostError(SCErrorType.SCE_CONTRACT,
                                "issuer is not AUTH_REVOCABLE",
                                SCErrorCode.SCEC_INVALID_ACTION)
            tle = self._load_trustline(addr, write=True, required=True)
            tl = tle.data.value
            if authorize:
                tl.flags |= TrustLineFlags.AUTHORIZED_FLAG
            else:
                tl.flags &= ~(TrustLineFlags.AUTHORIZED_FLAG |
                              TrustLineFlags.
                              AUTHORIZED_TO_MAINTAIN_LIABILITIES_FLAG)
        else:
            key = balance_key(self.contract, addr)
            le = self.host.load_entry(key)
            amount, _, cb = (0, True, self._issuer_flag(
                AccountFlags.AUTH_CLAWBACK_ENABLED_FLAG)) \
                if le is None else _read_balance_map(le.data.value.val)
            self._put_contract_data(
                key, _balance_map(amount, authorize, cb),
                ContractDataDurability.PERSISTENT)
        self._event(b"set_authorized", [_addr_scval(admin),
                                        _addr_scval(addr)],
                    SCVal(SCValType.SCV_BOOL, authorize))
        return SCVal(SCValType.SCV_VOID)

    # ----------------------------------------------------- classic plumbing --
    def _arg(self, args: List[SCVal], i: int) -> SCVal:
        if i >= len(args):
            raise HostError(SCErrorType.SCE_VALUE, "missing argument",
                            SCErrorCode.SCEC_MISSING_VALUE)
        return args[i]

    def _amount(self, val: SCVal, allow_zero: bool = False) -> int:
        v = i128_of(val)
        if v < 0 or (v == 0 and not allow_zero):
            raise HostError(SCErrorType.SCE_CONTRACT,
                            "amount must be positive",
                            SCErrorCode.SCEC_INVALID_INPUT)
        return v

    def _event(self, topic: bytes, addr_topics: List[SCVal],
               data: SCVal) -> None:
        """SEP-41 event shape: [fn-symbol, addresses..., sep11-string]."""
        topics = [sym(topic)] + addr_topics + [
            SCVal(SCValType.SCV_STRING, sep11(self.asset).encode("ascii"))]
        self.host.emit_event(bytes(self.contract.value), topics, data)

    def _is_issuer(self, addr: SCAddress) -> bool:
        if self.is_native or \
                addr.disc != SCAddressType.SC_ADDRESS_TYPE_ACCOUNT:
            return False
        return bytes(addr.value.value) == \
            bytes(self.asset.value.issuer.value)

    def _issuer_account(self):
        issuer = self.asset.value.issuer
        le = self._load_classic(LedgerKey.account(issuer), write=False)
        if le is None:
            raise HostError(SCErrorType.SCE_CONTRACT, "issuer missing",
                            SCErrorCode.SCEC_MISSING_VALUE)
        return le.data.value

    def _issuer_flag(self, flag: int) -> bool:
        return bool(self._issuer_account().flags & flag)

    def _require_admin(self) -> SCAddress:
        if self.admin is None:
            raise HostError(SCErrorType.SCE_CONTRACT,
                            "native asset has no admin",
                            SCErrorCode.SCEC_MISSING_VALUE)
        self.host.require_auth(self.admin)
        return self.admin

    def _load_classic(self, key: LedgerKey,
                      write: bool) -> Optional[LedgerEntry]:
        """Classic entries go through footprint + budget but carry no
        TTL (only CONTRACT_DATA/CODE are archival — reference: rent only
        meters soroban entry types)."""
        host = self.host
        host.budget.charge(5000)
        host._check_footprint(key, write=write)
        le = host.ltx.load(key) if write else \
            host.ltx.load_without_record(key)
        if le is not None:
            host.budget.charge(len(le.to_bytes()) * 10)
        return le

    def _load_trustline(self, addr: SCAddress, write: bool,
                        required: bool = False) -> Optional[LedgerEntry]:
        key = LedgerKey.trust_line(addr.value,
                                   TrustLineAsset.from_asset(self.asset))
        le = self._load_classic(key, write)
        if le is None and required:
            raise HostError(SCErrorType.SCE_CONTRACT, "no trustline",
                            SCErrorCode.SCEC_MISSING_VALUE)
        return le

    def _is_authorized(self, addr: SCAddress) -> bool:
        if addr.disc == SCAddressType.SC_ADDRESS_TYPE_ACCOUNT:
            if self.is_native or self._is_issuer(addr):
                return True
            tl = self._load_trustline(addr, write=False)
            return tl is not None and \
                tx_utils.is_authorized(tl.data.value)
        le = self.host.load_entry(balance_key(self.contract, addr))
        if le is None:
            if self.is_native:
                return True     # native balances are always authorized
            return not self._issuer_flag(AccountFlags.AUTH_REQUIRED_FLAG)
        _, authorized, _ = _read_balance_map(le.data.value.val)
        return authorized

    def _put_contract_data(self, key: LedgerKey, val: SCVal,
                           durability) -> None:
        contract = key.value.contract
        self.host.put_entry(key, LedgerEntry(
            lastModifiedLedgerSeq=self.host.header.ledgerSeq,
            data=_LedgerEntryData(
                LedgerEntryType.CONTRACT_DATA,
                ContractDataEntry(ext=ExtensionPoint(0), contract=contract,
                                  key=key.value.key, durability=durability,
                                  val=val)),
            ext=_LedgerEntryExt(0)), durability=durability)

    # ----------------------------------------------------- spend / receive --
    def _classic_amount(self, amount: int) -> int:
        if amount > INT64_MAX:
            raise HostError(SCErrorType.SCE_CONTRACT,
                            "amount exceeds classic range",
                            SCErrorCode.SCEC_ARITH_DOMAIN)
        return amount

    def _spend(self, addr: SCAddress, amount: int,
               clawback: bool = False) -> None:
        if addr.disc == SCAddressType.SC_ADDRESS_TYPE_ACCOUNT:
            amt = self._classic_amount(amount)
            if self.is_native:
                if clawback:
                    raise HostError(SCErrorType.SCE_CONTRACT,
                                    "native asset cannot be clawed back",
                                    SCErrorCode.SCEC_INVALID_ACTION)
                le = self._load_classic(LedgerKey.account(addr.value),
                                        write=True)
                if le is None or not tx_utils.add_balance_account(
                        self.host.header, le.data.value, -amt):
                    raise HostError(SCErrorType.SCE_CONTRACT,
                                    "balance is not sufficient",
                                    SCErrorCode.SCEC_INVALID_ACTION)
                return
            if self._is_issuer(addr):
                if clawback:
                    # the issuer holds no trustline in its own asset, so
                    # there is nothing to claw back
                    raise HostError(SCErrorType.SCE_CONTRACT,
                                    "cannot claw back from issuer",
                                    SCErrorCode.SCEC_INVALID_ACTION)
                return              # spending from the issuer mints
            tle = self._load_trustline(addr, write=True, required=True)
            tl = tle.data.value
            if clawback:
                if not (tl.flags &
                        TrustLineFlags.TRUSTLINE_CLAWBACK_ENABLED_FLAG):
                    raise HostError(SCErrorType.SCE_CONTRACT,
                                    "clawback not enabled",
                                    SCErrorCode.SCEC_INVALID_ACTION)
            elif not tx_utils.is_authorized(tl):
                raise HostError(SCErrorType.SCE_CONTRACT,
                                "trustline not authorized",
                                SCErrorCode.SCEC_INVALID_ACTION)
            if not tx_utils.add_balance_trustline(tl, -amt):
                raise HostError(SCErrorType.SCE_CONTRACT,
                                "balance is not sufficient",
                                SCErrorCode.SCEC_INVALID_ACTION)
            return
        # contract-address balance
        key = balance_key(self.contract, addr)
        le = self.host.load_entry(key)
        cur, authorized, cb = (0, True, False) if le is None else \
            _read_balance_map(le.data.value.val)
        if clawback:
            if not cb:
                raise HostError(SCErrorType.SCE_CONTRACT,
                                "clawback not enabled",
                                SCErrorCode.SCEC_INVALID_ACTION)
        elif not authorized:
            raise HostError(SCErrorType.SCE_CONTRACT,
                            "balance deauthorized",
                            SCErrorCode.SCEC_INVALID_ACTION)
        if cur < amount:
            raise HostError(SCErrorType.SCE_CONTRACT,
                            "balance is not sufficient",
                            SCErrorCode.SCEC_INVALID_ACTION)
        self._put_contract_data(key, _balance_map(cur - amount,
                                                  authorized, cb),
                                ContractDataDurability.PERSISTENT)

    def _receive(self, addr: SCAddress, amount: int) -> None:
        if addr.disc == SCAddressType.SC_ADDRESS_TYPE_ACCOUNT:
            amt = self._classic_amount(amount)
            if self.is_native:
                le = self._load_classic(LedgerKey.account(addr.value),
                                        write=True)
                if le is None:
                    raise HostError(SCErrorType.SCE_CONTRACT,
                                    "destination account missing",
                                    SCErrorCode.SCEC_MISSING_VALUE)
                if not tx_utils.add_balance_account(
                        self.host.header, le.data.value, amt):
                    raise HostError(SCErrorType.SCE_CONTRACT,
                                    "destination line is full",
                                    SCErrorCode.SCEC_INVALID_ACTION)
                return
            if self._is_issuer(addr):
                return              # receiving at the issuer burns
            tle = self._load_trustline(addr, write=True, required=True)
            tl = tle.data.value
            if not tx_utils.is_authorized(tl):
                raise HostError(SCErrorType.SCE_CONTRACT,
                                "trustline not authorized",
                                SCErrorCode.SCEC_INVALID_ACTION)
            if not tx_utils.add_balance_trustline(tl, amt):
                raise HostError(SCErrorType.SCE_CONTRACT,
                                "destination line is full",
                                SCErrorCode.SCEC_INVALID_ACTION)
            return
        key = balance_key(self.contract, addr)
        le = self.host.load_entry(key)
        if le is None:
            authorized = not self._issuer_flag(
                AccountFlags.AUTH_REQUIRED_FLAG) if not self.is_native \
                else True
            cb = self._issuer_flag(
                AccountFlags.AUTH_CLAWBACK_ENABLED_FLAG) \
                if not self.is_native else False
            cur = 0
        else:
            cur, authorized, cb = _read_balance_map(le.data.value.val)
        if not authorized:
            raise HostError(SCErrorType.SCE_CONTRACT,
                            "balance deauthorized",
                            SCErrorCode.SCEC_INVALID_ACTION)
        if cur + amount > I128_MAX:
            raise HostError(SCErrorType.SCE_CONTRACT, "balance overflow",
                            SCErrorCode.SCEC_ARITH_DOMAIN)
        self._put_contract_data(key, _balance_map(cur + amount,
                                                  authorized, cb),
                                ContractDataDurability.PERSISTENT)
