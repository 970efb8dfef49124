"""Network upgrade voting and application.

Reference: src/herder/Upgrades.{h,cpp} — operators schedule parameter changes
(protocol version, base fee, max tx set size, base reserve, flags) for a
given time; validators include matching LedgerUpgrade XDRs in their
StellarValue proposals; externalized upgrades are applied to the ledger
header during closeLedger (Upgrades.cpp:271-316 applyTo).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..util.logging import get_logger
from ..xdr.ledger import LedgerHeaderFlags, LedgerUpgrade, LedgerUpgradeType

log = get_logger("Herder")

# All flags an upgrade may set (reference: MASK_LEDGER_HEADER_FLAGS)
MASK_LEDGER_HEADER_FLAGS = (
    LedgerHeaderFlags.DISABLE_LIQUIDITY_POOL_TRADING_FLAG
    | LedgerHeaderFlags.DISABLE_LIQUIDITY_POOL_DEPOSIT_FLAG
    | LedgerHeaderFlags.DISABLE_LIQUIDITY_POOL_WITHDRAWAL_FLAG)


class UpgradeParameters:
    """Operator-scheduled upgrade set (reference:
    Upgrades::UpgradeParameters)."""

    def __init__(self, upgrade_time: int = 0,
                 protocol_version: Optional[int] = None,
                 base_fee: Optional[int] = None,
                 max_tx_set_size: Optional[int] = None,
                 base_reserve: Optional[int] = None,
                 flags: Optional[int] = None,
                 max_soroban_tx_set_size: Optional[int] = None,
                 config_upgrade_set_key=None):
        self.upgrade_time = upgrade_time
        self.protocol_version = protocol_version
        self.base_fee = base_fee
        self.max_tx_set_size = max_tx_set_size
        self.base_reserve = base_reserve
        self.flags = flags
        self.max_soroban_tx_set_size = max_soroban_tx_set_size
        # ConfigUpgradeSetKey pointing at a published upgrade set
        self.config_upgrade_set_key = config_upgrade_set_key


class ConfigUpgradeSetFrame:
    """A validated Soroban config upgrade set loaded from the ledger
    (reference: herder/Upgrades.cpp ConfigUpgradeSetFrame:1273-1376 —
    the key names a TEMPORARY contract-data entry whose SCV_BYTES value
    deserializes to a ConfigUpgradeSet matching contentHash)."""

    def __init__(self, upgrade_set, key):
        self.upgrade_set = upgrade_set
        self.key = key

    @staticmethod
    def ledger_key(key):
        from ..xdr.contract import (ContractDataDurability, SCAddress,
                                    SCAddressType, SCVal, SCValType)
        from ..xdr.ledger_entries import LedgerKey
        contract = SCAddress(SCAddressType.SC_ADDRESS_TYPE_CONTRACT,
                             key.contractID)
        val = SCVal(SCValType.SCV_BYTES, bytes(key.contentHash))
        return LedgerKey.contract_data(
            contract, val, ContractDataDurability.TEMPORARY)

    @classmethod
    def make_from_key(cls, ltx, key):
        """Load + validate; returns None when missing/expired/corrupt
        (reference: makeFromKey :1273)."""
        from ..crypto.sha import sha256
        from ..soroban.host import ttl_key_for
        from ..xdr.contract import ConfigUpgradeSet, SCValType
        from ..xdr.runtime import XdrError
        lk = cls.ledger_key(key)
        le = ltx.load_without_record(lk)
        if le is None:
            return None
        ttl = ltx.load_without_record(ttl_key_for(lk))
        if ttl is None or \
                ttl.data.value.liveUntilLedgerSeq < ltx.get_header().ledgerSeq:
            return None
        cd = le.data.value
        if cd.val.disc != SCValType.SCV_BYTES:
            return None
        try:
            upgrade_set = ConfigUpgradeSet.from_bytes(bytes(cd.val.value))
        except XdrError:
            return None
        if sha256(upgrade_set.to_bytes()) != bytes(key.contentHash):
            return None
        # entries must be non-empty and strictly sorted by setting id
        ids = [e.disc for e in upgrade_set.updatedEntry]
        if not ids or ids != sorted(set(ids)):
            return None
        for entry in upgrade_set.updatedEntry:
            if not _is_valid_config_entry(entry):
                return None
        return cls(upgrade_set, key)

    def upgrade_needed(self, ltx) -> bool:
        """Any updated entry differing from the live one?"""
        from ..xdr.ledger_entries import LedgerKey
        for entry in self.upgrade_set.updatedEntry:
            live = ltx.load_without_record(
                LedgerKey.config_setting(entry.disc))
            if live is None or live.data.value != entry:
                return True
        return False

    def apply_to(self, ltx) -> None:
        """Overwrite the CONFIG_SETTING entries (reference: applyTo
        :344-358)."""
        from ..xdr.ledger_entries import LedgerKey
        for entry in self.upgrade_set.updatedEntry:
            key = LedgerKey.config_setting(entry.disc)
            live = ltx.load(key)
            if live is None:
                raise RuntimeError(
                    f"config setting {entry.disc!r} missing")
            live.data.value = entry


class Upgrades:
    def __init__(self, params: Optional[UpgradeParameters] = None,
                 current_protocol_version: int = 21):
        self._params = params or UpgradeParameters()
        self.current_protocol_version = current_protocol_version

    def set_parameters(self, params: UpgradeParameters) -> None:
        self._params = params

    def get_parameters(self) -> UpgradeParameters:
        return self._params

    # ------------------------------------------------------------ proposing --
    def create_upgrades_for(self, header, close_time: int,
                            ltx=None) -> List[LedgerUpgrade]:
        """Upgrades this node votes for, given the LCL header (reference:
        Upgrades::createUpgradesFor). `ltx` (when given) enables the
        Soroban config votes, which read CONFIG_SETTING entries."""
        p = self._params
        out: List[LedgerUpgrade] = []
        if close_time < p.upgrade_time:
            return out
        if (p.protocol_version is not None
                and header.ledgerVersion != p.protocol_version):
            out.append(LedgerUpgrade(
                LedgerUpgradeType.LEDGER_UPGRADE_VERSION,
                p.protocol_version))
        if p.base_fee is not None and header.baseFee != p.base_fee:
            out.append(LedgerUpgrade(
                LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE, p.base_fee))
        if (p.max_tx_set_size is not None
                and header.maxTxSetSize != p.max_tx_set_size):
            out.append(LedgerUpgrade(
                LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE,
                p.max_tx_set_size))
        if p.base_reserve is not None and header.baseReserve != p.base_reserve:
            out.append(LedgerUpgrade(
                LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE,
                p.base_reserve))
        if p.flags is not None and _header_flags(header) != p.flags:
            out.append(LedgerUpgrade(
                LedgerUpgradeType.LEDGER_UPGRADE_FLAGS, p.flags))
        if ltx is not None and header.ledgerVersion >= 20:
            if p.max_soroban_tx_set_size is not None and \
                    _soroban_max_tx_count(ltx) != \
                    p.max_soroban_tx_set_size:
                out.append(LedgerUpgrade(
                    LedgerUpgradeType
                    .LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE,
                    p.max_soroban_tx_set_size))
            if p.config_upgrade_set_key is not None:
                frame = ConfigUpgradeSetFrame.make_from_key(
                    ltx, p.config_upgrade_set_key)
                if frame is not None and frame.upgrade_needed(ltx):
                    out.append(LedgerUpgrade(
                        LedgerUpgradeType.LEDGER_UPGRADE_CONFIG,
                        p.config_upgrade_set_key))
        return out

    # ----------------------------------------------------------- validating --
    def is_valid(self, upgrade: LedgerUpgrade, header,
                 nomination: bool, close_time: int = 0,
                 ltx=None) -> bool:
        """Would this node accept the proposed upgrade? During nomination
        the upgrade must match our scheduled parameters; after
        externalization only structural validity matters (reference:
        Upgrades::isValid / isValidForApply)."""
        ok, _ = self._validate(upgrade, header)
        if not ok:
            return False
        if upgrade.disc == LedgerUpgradeType.LEDGER_UPGRADE_CONFIG \
                and ltx is not None and \
                ConfigUpgradeSetFrame.make_from_key(
                    ltx, upgrade.value) is None:
            # reference: isValidForApply loads + validates the set via
            # the ltx; an unloadable/corrupt set is rejected at ballot
            # time so apply can't crash the close
            return False
        if not nomination:
            return True
        p = self._params
        if close_time < p.upgrade_time:
            return False
        t = upgrade.disc
        v = upgrade.value
        if t == LedgerUpgradeType.LEDGER_UPGRADE_VERSION:
            return p.protocol_version == v
        if t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE:
            return p.base_fee == v
        if t == LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            return p.max_tx_set_size == v
        if t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE:
            return p.base_reserve == v
        if t == LedgerUpgradeType.LEDGER_UPGRADE_FLAGS:
            return p.flags == v
        if t == LedgerUpgradeType.LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE:
            return p.max_soroban_tx_set_size == v
        if t == LedgerUpgradeType.LEDGER_UPGRADE_CONFIG:
            return p.config_upgrade_set_key is not None and \
                p.config_upgrade_set_key.to_bytes() == v.to_bytes()
        return False

    def _validate(self, upgrade: LedgerUpgrade, header) -> Tuple[bool, str]:
        t = upgrade.disc
        v = upgrade.value
        if t == LedgerUpgradeType.LEDGER_UPGRADE_VERSION:
            if v > self.current_protocol_version:
                return False, "version not supported"
            if v < header.ledgerVersion:
                return False, "downgrade"
            return True, ""
        if t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE:
            return (v > 0, "base fee must be positive")
        if t == LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            return (v > 0, "max tx set size must be positive")
        if t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE:
            return (v > 0, "base reserve must be positive")
        if t == LedgerUpgradeType.LEDGER_UPGRADE_FLAGS:
            if header.ledgerVersion < 18:
                return False, "flags upgrade needs protocol 18"
            return ((v & ~MASK_LEDGER_HEADER_FLAGS) == 0, "invalid flags")
        if t == LedgerUpgradeType.LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE:
            if header.ledgerVersion < 20:
                return False, "soroban upgrade needs protocol 20"
            return True, ""
        if t == LedgerUpgradeType.LEDGER_UPGRADE_CONFIG:
            if header.ledgerVersion < 20:
                return False, "config upgrade needs protocol 20"
            return True, ""
        return False, "unknown upgrade type"

    # ------------------------------------------------------------- applying --
    @staticmethod
    def apply_to(upgrade: LedgerUpgrade, header, ltx=None) -> None:
        """Mutate the in-close ledger header — and, for the Soroban
        upgrade types, the CONFIG_SETTING entries via `ltx` (reference:
        Upgrades::applyTo)."""
        t = upgrade.disc
        v = upgrade.value
        if t == LedgerUpgradeType.LEDGER_UPGRADE_VERSION:
            header.ledgerVersion = v
        elif t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_FEE:
            header.baseFee = v
        elif t == LedgerUpgradeType.LEDGER_UPGRADE_MAX_TX_SET_SIZE:
            header.maxTxSetSize = v
        elif t == LedgerUpgradeType.LEDGER_UPGRADE_BASE_RESERVE:
            header.baseReserve = v
        elif t == LedgerUpgradeType.LEDGER_UPGRADE_FLAGS:
            _set_header_flags(header, v)
        elif t == LedgerUpgradeType \
                .LEDGER_UPGRADE_MAX_SOROBAN_TX_SET_SIZE:
            if ltx is None:
                raise RuntimeError("soroban upgrade needs an ltx")
            _set_soroban_max_tx_count(ltx, v)
        elif t == LedgerUpgradeType.LEDGER_UPGRADE_CONFIG:
            if ltx is None:
                raise RuntimeError("config upgrade needs an ltx")
            frame = ConfigUpgradeSetFrame.make_from_key(ltx, v)
            if frame is None:
                raise RuntimeError(
                    "failed to retrieve valid config upgrade set")
            frame.apply_to(ltx)
        else:
            log.warning("ignoring unknown upgrade type %s", t)


def _header_flags(header) -> int:
    from ..tx.tx_utils import header_flags
    return header_flags(header)


def _set_header_flags(header, flags: int) -> None:
    from ..xdr.ledger import LedgerHeaderExtensionV1, _LedgerHeaderExt
    if flags == 0 and header.ext.disc == 0:
        return
    if header.ext.disc == 0:
        header.ext = _LedgerHeaderExt(1, LedgerHeaderExtensionV1())
    header.ext.value.flags = flags


def _soroban_max_tx_count(ltx) -> Optional[int]:
    from ..xdr.contract import ConfigSettingID
    from ..xdr.ledger_entries import LedgerKey
    le = ltx.load_without_record(LedgerKey.config_setting(
        ConfigSettingID.CONFIG_SETTING_CONTRACT_EXECUTION_LANES))
    return le.data.value.value.ledgerMaxTxCount if le is not None else None


def _set_soroban_max_tx_count(ltx, count: int) -> None:
    """reference: upgradeMaxSorobanTxSetSize (Upgrades.cpp:130-138)."""
    from ..xdr.contract import ConfigSettingID
    from ..xdr.ledger_entries import LedgerKey
    le = ltx.load(LedgerKey.config_setting(
        ConfigSettingID.CONFIG_SETTING_CONTRACT_EXECUTION_LANES))
    if le is None:
        raise RuntimeError("execution-lanes config setting missing")
    le.data.value.value.ledgerMaxTxCount = count


# non-upgradeable internal bookkeeping settings (reference:
# ConfigUpgradeSetFrame::isValid rejects these ids)
from ..xdr.contract import ConfigSettingID as _CSID
_NON_UPGRADEABLE_SETTINGS = frozenset((
    _CSID.CONFIG_SETTING_BUCKETLIST_SIZE_WINDOW,
    _CSID.CONFIG_SETTING_EVICTION_ITERATOR,
))


def _is_valid_config_entry(entry) -> bool:
    """Content sanity for one updated ConfigSettingEntry (reference:
    ConfigUpgradeSetFrame::isValid + SorobanNetworkConfig::isValid —
    internal ids rejected, core limits must stay positive)."""
    from ..xdr.contract import ConfigSettingID
    if int(entry.disc) in _NON_UPGRADEABLE_SETTINGS:
        return False
    v = entry.value
    sid = entry.disc
    if sid == ConfigSettingID.CONFIG_SETTING_CONTRACT_MAX_SIZE_BYTES:
        return v > 0
    if sid == ConfigSettingID.CONFIG_SETTING_CONTRACT_COMPUTE_V0:
        return (v.ledgerMaxInstructions > 0 and v.txMaxInstructions > 0
                and v.txMaxInstructions <= v.ledgerMaxInstructions
                and v.txMemoryLimit > 0)
    if sid == ConfigSettingID.CONFIG_SETTING_CONTRACT_LEDGER_COST_V0:
        return (v.txMaxReadLedgerEntries > 0 and v.txMaxReadBytes > 0
                and v.txMaxWriteBytes > 0)
    if sid == ConfigSettingID.CONFIG_SETTING_CONTRACT_BANDWIDTH_V0:
        return (v.txMaxSizeBytes > 0
                and v.txMaxSizeBytes <= v.ledgerMaxTxsSizeBytes)
    if sid == ConfigSettingID.CONFIG_SETTING_CONTRACT_DATA_KEY_SIZE_BYTES:
        return v > 0
    if sid == ConfigSettingID.CONFIG_SETTING_CONTRACT_DATA_ENTRY_SIZE_BYTES:
        return v > 0
    if sid == ConfigSettingID.CONFIG_SETTING_CONTRACT_EXECUTION_LANES:
        return v.ledgerMaxTxCount > 0
    return True
