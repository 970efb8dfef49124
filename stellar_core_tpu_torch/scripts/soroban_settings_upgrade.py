"""Operator tool: propose a Soroban CONFIG upgrade through a node's
HTTP admin API (reference: scripts/soroban-settings/
SorobanSettingsUpgrade.py:1 — setup_upgrade deploys the
write-upgrade-bytes contract, stores the serialized ConfigUpgradeSet as
a TEMPORARY entry, prints the ConfigUpgradeSetKey; the operator then
feeds the key to the `upgrades` endpoint).

Subcommands (all against `--node http://host:port`):

  get --id NAME                 dump a current ConfigSettingEntry
  encode --settings FILE.json   build + print the upgrade set and key
  setup --settings FILE.json --secret SEED
                                upload+create the write-bytes contract,
                                invoke write(upgrade_bytes), print key
  propose --key B64 [--upgrade-time T]
                                vote the CONFIG upgrade
  status                        show the node's pending upgrade config

Settings JSON: {"CONTRACT_MAX_SIZE_BYTES": 131072,
                "STATE_ARCHIVAL": {"maxEntriesToArchive": 50}, ...}
Scalar settings take the value directly; struct settings take a dict of
field overrides merged over the node's CURRENT entry (read via
getledgerentry), so an upgrade never silently zeroes unlisted fields.

`--secret` accepts a 64-hex-char seed or "master" (the standalone
network's root key, derived from the passphrase like the test harness).
`--manual-close` closes a MANUAL_CLOSE standalone node between txs.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import urllib.parse
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from stellar_core_tpu_torch.crypto.keys import SecretKey       # noqa: E402
from stellar_core_tpu_torch.crypto.sha import sha256           # noqa: E402
from stellar_core_tpu_torch.xdr import contract as cx          # noqa: E402
from stellar_core_tpu_torch.xdr.ledger_entries import (        # noqa: E402
    LedgerEntry, LedgerKey)


class Node:
    def __init__(self, url: str):
        self.url = url.rstrip("/")

    def cmd(self, command: str, **params) -> dict:
        qs = urllib.parse.urlencode(
            {k: v for k, v in params.items() if v is not None})
        with urllib.request.urlopen(
                f"{self.url}/{command}" + (f"?{qs}" if qs else ""),
                timeout=30) as r:
            out = json.loads(r.read())
        if "exception" in out:
            raise RuntimeError(f"{command}: {out['exception']}")
        return out

    def network_passphrase(self) -> str:
        return self.cmd("info")["info"]["network"]

    def ledger_entry(self, key: LedgerKey):
        out = self.cmd("getledgerentry",
                       key=base64.b64encode(key.to_bytes()).decode())
        if "entry" not in out:
            return None
        return LedgerEntry.from_bytes(base64.b64decode(out["entry"]))

    def account_seq(self, account_id) -> int:
        le = self.ledger_entry(LedgerKey.account(account_id))
        if le is None:
            raise RuntimeError("source account does not exist")
        return le.data.value.seqNum

    def submit(self, frame) -> None:
        blob = base64.b64encode(frame.envelope.to_bytes()).decode()
        out = self.cmd("tx", blob=blob)
        if out.get("status") != "PENDING":
            raise RuntimeError(f"tx rejected: {out}")


def _setting_id(name: str) -> cx.ConfigSettingID:
    name = name.upper()
    if not name.startswith("CONFIG_SETTING_"):
        name = "CONFIG_SETTING_" + name
    return cx.ConfigSettingID[name]


def _struct_fields(obj) -> list:
    return [f for f, _ in obj.FIELDS] if hasattr(obj, "FIELDS") else []


def build_upgrade_set(node: Node, settings: dict) -> cx.ConfigUpgradeSet:
    """Each JSON item becomes one updatedEntry; struct settings merge
    field overrides over the node's current entry."""
    entries = []
    for name, spec in settings.items():
        sid = _setting_id(name)
        if isinstance(spec, dict):
            le = node.ledger_entry(LedgerKey.config_setting(sid))
            if le is None:
                raise RuntimeError(f"{sid.name}: node has no current "
                                   "entry to merge over")
            current = le.data.value.value
            unknown = set(spec) - set(_struct_fields(current))
            if unknown:
                raise RuntimeError(f"{sid.name}: unknown fields "
                                   f"{sorted(unknown)}")
            for f, v in spec.items():
                setattr(current, f, v)
            entries.append(cx.ConfigSettingEntry(sid, current))
        else:
            entries.append(cx.ConfigSettingEntry(sid, int(spec)))
    # the frame requires ascending unique setting ids
    entries.sort(key=lambda e: int(e.disc))
    return cx.ConfigUpgradeSet(updatedEntry=entries)


def _secret(arg: str, network_id: bytes) -> SecretKey:
    if arg == "master":
        return SecretKey.from_seed(network_id)
    return SecretKey.from_seed(bytes.fromhex(arg))


def _soroban_frame(network_id: bytes, key: SecretKey, seq: int, op_body,
                   ro, rw, instructions=4_000_000, resource_fee=10_000_000):
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.xdr.transaction import (
        DecoratedSignature, EnvelopeType, Memo, MemoType, MuxedAccount,
        Operation, Preconditions, PreconditionType, Transaction,
        TransactionEnvelope, TransactionV1Envelope, _TxExt)

    sd = cx.SorobanTransactionData(
        resources=cx.SorobanResources(
            footprint=cx.LedgerFootprint(readOnly=list(ro),
                                         readWrite=list(rw)),
            instructions=instructions, readBytes=200_000,
            writeBytes=200_000),
        resourceFee=resource_fee)
    tx = Transaction(
        sourceAccount=MuxedAccount.from_ed25519(key.public_key().raw),
        fee=100 + resource_fee, seqNum=seq,
        cond=Preconditions(PreconditionType.PRECOND_NONE),
        memo=Memo(MemoType.MEMO_NONE),
        operations=[Operation(sourceAccount=None, body=op_body)],
        ext=_TxExt(1, sd))
    env = TransactionEnvelope(
        EnvelopeType.ENVELOPE_TYPE_TX,
        TransactionV1Envelope(tx=tx, signatures=[]))
    frame = make_frame(env, network_id)
    sig = key.sign(frame.contents_hash())
    frame.signatures.append(DecoratedSignature(
        hint=key.public_key().hint(), signature=sig))
    env.value.signatures = frame.signatures
    return frame


def cmd_get(node: Node, args) -> int:
    sid = _setting_id(args.id)
    le = node.ledger_entry(LedgerKey.config_setting(sid))
    if le is None:
        print(f"{sid.name}: <absent>")
        return 1
    val = le.data.value.value
    if hasattr(val, "FIELDS"):
        print(json.dumps({f: getattr(val, f) for f in
                          _struct_fields(val)}, indent=1, default=str))
    else:
        print(val)
    return 0


def cmd_encode(node: Node, args) -> int:
    with open(args.settings) as f:
        upgrade_set = build_upgrade_set(node, json.load(f))
    raw = upgrade_set.to_bytes()
    print(json.dumps({
        "configUpgradeSet": base64.b64encode(raw).decode(),
        "contentHash": sha256(raw).hex(),
        "entries": len(upgrade_set.updatedEntry),
    }, indent=1))
    return 0


def cmd_setup(node: Node, args) -> int:
    from stellar_core_tpu_torch.soroban.env_contract import build_write_bytes
    from stellar_core_tpu_torch.soroban.host import (contract_id_from_preimage,
                                                     instance_key, ttl_key_for)
    from stellar_core_tpu_torch.xdr.transaction import (_OperationBody,
                                                        OperationType)
    from stellar_core_tpu_torch.xdr.types import PublicKey

    network_id = sha256(node.network_passphrase().encode())
    key = _secret(args.secret, network_id)
    account_id = PublicKey.ed25519(key.public_key().raw)
    with open(args.settings) as f:
        upgrade_set = build_upgrade_set(node, json.load(f))
    payload = upgrade_set.to_bytes()
    content_hash = sha256(payload)

    code = build_write_bytes()
    code_hash = sha256(code)
    code_key = LedgerKey.contract_code(code_hash)

    def close():
        if args.manual_close:
            node.cmd("manualclose")

    seq = node.account_seq(account_id)

    # 1. upload (idempotent: skip if the code is already on-chain)
    if node.ledger_entry(code_key) is None:
        seq += 1
        node.submit(_soroban_frame(
            network_id, key, seq,
            _OperationBody(
                OperationType.INVOKE_HOST_FUNCTION,
                cx.InvokeHostFunctionOp(hostFunction=cx.HostFunction(
                    cx.HostFunctionType
                    .HOST_FUNCTION_TYPE_UPLOAD_CONTRACT_WASM,
                    code), auth=[])),
            [], [code_key]))
        close()
        print("uploaded write-bytes contract code", file=sys.stderr)

    # 2. create (salt = contentHash: repeated runs for the same upgrade
    # reuse one contract instance deterministically)
    preimage = cx.ContractIDPreimage(
        cx.ContractIDPreimageType.CONTRACT_ID_PREIMAGE_FROM_ADDRESS,
        cx._ContractIDPreimageFromAddress(
            address=cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_ACCOUNT,
                                 account_id),
            salt=bytes(content_hash)))
    cid = contract_id_from_preimage(network_id, preimage)
    addr = cx.SCAddress(cx.SCAddressType.SC_ADDRESS_TYPE_CONTRACT, cid)
    create_args = cx.CreateContractArgs(
        contractIDPreimage=preimage,
        executable=cx.ContractExecutable(
            cx.ContractExecutableType.CONTRACT_EXECUTABLE_WASM,
            code_hash))
    if node.ledger_entry(instance_key(addr)) is None:
        seq += 1
        node.submit(_soroban_frame(
            network_id, key, seq,
            _OperationBody(
                OperationType.INVOKE_HOST_FUNCTION,
                cx.InvokeHostFunctionOp(hostFunction=cx.HostFunction(
                    cx.HostFunctionType.HOST_FUNCTION_TYPE_CREATE_CONTRACT,
                    create_args), auth=[
                        cx.SorobanAuthorizationEntry(
                            credentials=cx.SorobanCredentials(
                                cx.SorobanCredentialsType
                                .SOROBAN_CREDENTIALS_SOURCE_ACCOUNT),
                            rootInvocation=cx.SorobanAuthorizedInvocation(
                                function=cx.SorobanAuthorizedFunction(
                                    cx.SorobanAuthorizedFunctionType
                                    .SOROBAN_AUTHORIZED_FUNCTION_TYPE_CREATE_CONTRACT_HOST_FN,
                                    create_args),
                                subInvocations=[]))])),
            [code_key], [instance_key(addr)]))
        close()
        print(f"created contract {cid.hex()}", file=sys.stderr)

    # 3. write the upgrade bytes into the TEMPORARY entry
    data_key = LedgerKey.contract_data(
        addr, cx.SCVal(cx.SCValType.SCV_BYTES, bytes(content_hash)),
        cx.ContractDataDurability.TEMPORARY)
    seq += 1
    node.submit(_soroban_frame(
        network_id, key, seq,
        _OperationBody(
            OperationType.INVOKE_HOST_FUNCTION,
            cx.InvokeHostFunctionOp(hostFunction=cx.HostFunction(
                cx.HostFunctionType.HOST_FUNCTION_TYPE_INVOKE_CONTRACT,
                cx.InvokeContractArgs(
                    contractAddress=addr, functionName=b"write",
                    args=[cx.SCVal(cx.SCValType.SCV_BYTES, payload)])),
                auth=[])),
        [code_key, instance_key(addr)], [data_key]))
    close()
    if node.ledger_entry(data_key) is None:
        raise RuntimeError("upgrade bytes did not land on-chain")
    print("stored upgrade set on-chain", file=sys.stderr)

    upgrade_key = cx.ConfigUpgradeSetKey(contractID=cid,
                                         contentHash=bytes(content_hash))
    print(json.dumps({
        "configUpgradeSetKey":
            base64.b64encode(upgrade_key.to_bytes()).decode(),
        "contractID": cid.hex(),
        "contentHash": content_hash.hex(),
    }, indent=1))
    return 0


def cmd_propose(node: Node, args) -> int:
    out = node.cmd("upgrades", mode="set",
                   upgradetime=str(args.upgrade_time),
                   configupgradesetkey=args.key)
    print(json.dumps(out))
    return 0 if out.get("status") == "ok" else 1


def cmd_status(node: Node, args) -> int:
    print(json.dumps(node.cmd("upgrades", mode="get"), indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--node", default="http://127.0.0.1:11626")
    sub = ap.add_subparsers(dest="mode", required=True)
    g = sub.add_parser("get")
    g.add_argument("--id", required=True)
    e = sub.add_parser("encode")
    e.add_argument("--settings", required=True)
    s = sub.add_parser("setup")
    s.add_argument("--settings", required=True)
    s.add_argument("--secret", required=True)
    s.add_argument("--manual-close", action="store_true")
    p = sub.add_parser("propose")
    p.add_argument("--key", required=True)
    p.add_argument("--upgrade-time", type=int, default=0)
    sub.add_parser("status")
    args = ap.parse_args()
    node = Node(args.node)
    return {"get": cmd_get, "encode": cmd_encode, "setup": cmd_setup,
            "propose": cmd_propose, "status": cmd_status}[args.mode](
                node, args)


if __name__ == "__main__":
    sys.exit(main())
