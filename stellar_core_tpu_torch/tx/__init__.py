"""Transaction subsystem (reference: src/transactions/).

- signature_checker: hint-prefiltered threshold signature accounting with
  a pluggable verifier — the seam the device batch backend slots behind
  (transactions/SignatureChecker.cpp, SURVEY.md §3.2)
- tx_utils: account/trustline/balance/reserve helpers
  (transactions/TransactionUtils.cpp)
- frame: TransactionFrame / FeeBumpTransactionFrame lifecycle
  (transactions/TransactionFrame.cpp)
- operations/: one OperationFrame per operation type
"""

from .frame import TransactionFrame, FeeBumpTransactionFrame, make_frame
from .signature_checker import SignatureChecker
from . import operations  # registers every OperationFrame

__all__ = ["TransactionFrame", "FeeBumpTransactionFrame", "make_frame",
           "SignatureChecker"]
