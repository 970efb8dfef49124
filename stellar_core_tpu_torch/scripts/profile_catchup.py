"""Profile the catchup apply path: publish a synthetic archive, replay
it under cProfile, print the hot functions.

Usage: python -m stellar_core_tpu_torch.scripts.profile_catchup \
           [n_ledgers] [payments_per_ledger]

Run it before and after any LedgerTxn / apply-path change. Besides the
reference's report it prints the replayed LCL's header hash and
bucket-list hash, so that two replays can be held equal.
"""

import cProfile
import io
import pstats
import shutil
import sys
import tempfile
import time

sys.path.insert(0, __file__.rsplit("/", 3)[0])


def main():
    n_ledgers = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    per_ledger = int(sys.argv[2]) if len(sys.argv) > 2 else 30

    from stellar_core_tpu_torch.catchup.catchup_work import (
        CatchupConfiguration, CatchupWork)
    from stellar_core_tpu_torch.history.archive import make_tmpdir_archive
    from stellar_core_tpu_torch.main import Application, get_test_config
    from stellar_core_tpu_torch.util.timer import ClockMode, VirtualClock
    from stellar_core_tpu_torch.work import run_work_to_completion
    from stellar_core_tpu_torch.work.basic_work import State

    root_dir = tempfile.mkdtemp(prefix="profile-catchup-")
    archive = make_tmpdir_archive("bench", root_dir + "/archive")
    cfg = get_test_config()
    cfg.HISTORY = {"bench": {"get": archive.get_cmd, "put": archive.put_cmd}}

    # reuse bench.py's publish machinery by calling its internals through
    # a tiny shim: publish here, replay under the profiler
    app = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg)
    app.start()
    _publish(app, cfg, n_ledgers, per_ledger)

    from stellar_core_tpu_torch.crypto.keys import clear_verify_cache
    clear_verify_cache()     # replay must not reuse publish-phase verifies
    cfg2 = get_test_config()
    cfg2.NETWORK_PASSPHRASE = cfg.NETWORK_PASSPHRASE
    cfg2.SIGNATURE_VERIFY_BACKEND = "native"
    cfg2.MODE_STORES_HISTORY_MISC = False
    app2 = Application.create(VirtualClock(ClockMode.VIRTUAL_TIME), cfg2)
    app2.start()
    work = CatchupWork(app2, archive, CatchupConfiguration(to_ledger=0))

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    final = run_work_to_completion(app2, work)
    prof.disable()
    dt = time.perf_counter() - t0
    assert final == State.WORK_SUCCESS, final
    n = app2.ledger_manager.get_last_closed_ledger_num()
    print(f"replayed to ledger {n} in {dt:.2f}s = {n / dt:.1f} ledgers/s")
    lcl = app2.ledger_manager.get_last_closed_ledger_header()
    print(f"LCL {n} hash "
          f"{app2.ledger_manager.get_last_closed_ledger_hash().hex()} "
          f"bucket list {bytes(lcl.bucketListHash).hex()}\n")

    s = io.StringIO()
    ps = pstats.Stats(prof, stream=s).sort_stats("cumulative")
    ps.print_stats(40)
    print(s.getvalue())
    s = io.StringIO()
    ps = pstats.Stats(prof, stream=s).sort_stats("tottime")
    ps.print_stats(30)
    print(s.getvalue())
    app2.shutdown()
    app.shutdown()
    shutil.rmtree(root_dir, ignore_errors=True)


def _publish(app, cfg, n_ledgers, per_ledger):
    """Same synthetic workload bench.py --catchup publishes."""
    from stellar_core_tpu_torch.crypto.keys import SecretKey
    from stellar_core_tpu_torch.tx.frame import make_frame
    from stellar_core_tpu_torch.tx.tx_utils import starting_sequence_number
    from stellar_core_tpu_torch.xdr.ledger_entries import (
        Asset, AssetType, LedgerEntry, LedgerKey)
    from stellar_core_tpu_torch.xdr.transaction import (
        CreateAccountOp, DecoratedSignature, Memo, MemoType, MuxedAccount,
        Operation, OperationType, PaymentOp, Preconditions,
        PreconditionType, Transaction, TransactionEnvelope,
        TransactionV1Envelope, _OperationBody, _TxExt)
    from stellar_core_tpu_torch.xdr.types import EnvelopeType, PublicKey

    network_id = app.config.network_id()

    def submit(key, seq, ops):
        tx = Transaction(
            sourceAccount=MuxedAccount.from_ed25519(key.public_key().raw),
            fee=100 * len(ops), seqNum=seq,
            cond=Preconditions(PreconditionType.PRECOND_NONE),
            memo=Memo(MemoType.MEMO_NONE), operations=ops, ext=_TxExt(0))
        env = TransactionEnvelope(
            EnvelopeType.ENVELOPE_TYPE_TX,
            TransactionV1Envelope(tx=tx, signatures=[]))
        frame = make_frame(env, network_id)
        sig = key.sign(frame.contents_hash())
        frame.signatures.append(DecoratedSignature(
            hint=key.public_key().hint(), signature=sig))
        env.value.signatures = frame.signatures
        res = app.herder.recv_transaction(frame)
        assert res.name == "ADD_STATUS_PENDING", res

    master = SecretKey.from_seed(network_id)
    row = app.database.query_one(
        "SELECT entry FROM accounts WHERE key=?",
        (LedgerKey.account(
            PublicKey.ed25519(master.public_key().raw)).to_bytes(),))
    mseq = LedgerEntry.from_bytes(bytes(row[0])).data.value.seqNum
    dests = [SecretKey.from_seed(bytes([i]) * 32) for i in range(1, 9)]
    ops = [Operation(sourceAccount=None, body=_OperationBody(
        OperationType.CREATE_ACCOUNT, CreateAccountOp(
            destination=PublicKey.ed25519(d.public_key().raw),
            startingBalance=10**12))) for d in dests]
    mseq += 1
    submit(master, mseq, ops)
    app.manual_close()
    created_at = app.ledger_manager.get_last_closed_ledger_num()
    dseqs = {i: starting_sequence_number(created_at)
             for i in range(len(dests))}
    lcl = app.ledger_manager.get_last_closed_ledger_num()
    t0 = time.perf_counter()
    while lcl < n_ledgers:
        for i in range(per_ledger):
            di = (lcl + i) % len(dests)
            dseqs[di] += 1
            submit(dests[di], dseqs[di], [Operation(
                sourceAccount=None, body=_OperationBody(
                    OperationType.PAYMENT, PaymentOp(
                        destination=MuxedAccount.from_ed25519(
                            master.public_key().raw),
                        asset=Asset(AssetType.ASSET_TYPE_NATIVE),
                        amount=100)))])
        app.manual_close()
        lcl = app.ledger_manager.get_last_closed_ledger_num()
    print(f"published {lcl} ledgers in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
