"""Reusable end-to-end drives for tests and the driver's dryrun entry.

Reference analogue: test/TxTests.h helpers shared between test tiers —
logic exercised by both the pytest suite and __graft_entry__ lives here
so the two can't drift apart.
"""

from __future__ import annotations

from typing import List


def validate_txset_through_batch_verifier(app, n_accounts: int = 4,
                                          n_payments: int = 4) -> List[int]:
    """Fund accounts, queue payments, then validate the proposed txset
    the way an SCP validator receiving it from a peer would
    (herder/scp_driver.py validateValue → is_tx_set_valid — the node's
    batch collection point), finishing with a ledger close.

    Returns the batch sizes that flowed through app.batch_verifier;
    asserts the close advanced the ledger.  The verify cache is cleared
    before validation: queue admission warmed it, but a remote
    validator's cache is cold, and only a cold cache dispatches the
    device batch.
    """
    from ..crypto.keys import clear_verify_cache
    from ..herder.tx_set import make_tx_set_from_transactions
    from .load_generator import LoadGenerator

    bv = app.batch_verifier
    assert bv is not None, "app has no batch verifier configured"
    calls: List[int] = []
    orig = bv.verify_tuples
    bv.verify_tuples = lambda t: (calls.append(len(t)), orig(t))[1]
    try:
        gen = LoadGenerator(app)
        assert gen.generate_accounts(n_accounts) == n_accounts
        app.manual_close()
        gen.sync_account_seqs()
        assert gen.generate_payments(n_payments) == n_payments
        lcl_header = app.ledger_manager.get_last_closed_ledger_header()
        frame, _applicable, _excluded = make_tx_set_from_transactions(
            app.herder.tx_queue.get_transactions(), lcl_header,
            app.config.network_id())
        clear_verify_cache()
        assert app.herder.is_tx_set_valid(frame)
        assert calls, "validation bypassed the batch verifier"
        before = app.ledger_manager.get_last_closed_ledger_num()
        app.manual_close()
        assert app.ledger_manager.get_last_closed_ledger_num() == before + 1
    finally:
        bv.verify_tuples = orig
    return calls
