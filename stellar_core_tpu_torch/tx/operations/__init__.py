"""Operation frames, one module per group; importing this package
registers every frame with the operation_frame registry (reference:
src/transactions/*OpFrame.cpp, dispatch at OperationFrame.cpp:31-120)."""

from . import account_ops          # noqa: F401
from . import payment_ops          # noqa: F401
from . import trust_ops            # noqa: F401
from . import misc_ops             # noqa: F401
from . import offer_ops            # noqa: F401
from . import path_payment_ops     # noqa: F401
from . import claimable_balance_ops  # noqa: F401
from . import sponsorship_ops      # noqa: F401
from . import clawback_ops         # noqa: F401
from . import liquidity_pool_ops   # noqa: F401
from ... import soroban as _soroban   # noqa: F401  (registers contract ops)
