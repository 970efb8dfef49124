"""`python -m stellar_core_tpu_torch <cmd>` — alias of the main CLI."""

import sys

from .main.command_line import main

if __name__ == "__main__":
    sys.exit(main())
