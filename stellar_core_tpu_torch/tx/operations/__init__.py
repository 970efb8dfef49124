"""Operation frames, one module per group; importing this package
registers every frame the port has with the operation_frame registry
(reference: src/transactions/*OpFrame.cpp, dispatch at
OperationFrame.cpp:31-120). The claimable-balance, sponsorship,
clawback and liquidity-pool families and the Soroban ops are not copied
yet: `make_operation_frame` raises NotImplementedError for their op
types."""

from . import account_ops          # noqa: F401
from . import payment_ops          # noqa: F401
from . import trust_ops            # noqa: F401
from . import misc_ops             # noqa: F401
from . import offer_ops            # noqa: F401
from . import path_payment_ops     # noqa: F401
