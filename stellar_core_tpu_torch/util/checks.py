"""Hard runtime checks (reference: src/util/GlobalChecks.h).

The reference crashes the node on invariant failure (releaseAssert/dbgAbort);
we raise a dedicated exception type that top-level callers treat as fatal.
"""


class AssertionFailed(RuntimeError):
    """Raised when a release-mode assertion fails (reference: util/GlobalChecks.h)."""


def releaseAssert(cond: bool, msg: str = "releaseAssert failed") -> None:
    if not cond:
        raise AssertionFailed(msg)
