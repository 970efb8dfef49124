"""`python -m stellar_core_tpu_torch.main <cmd>` — the CLI entrypoint
(reference: main() in main/main.cpp dispatching to CommandLine)."""

import sys

from .command_line import main

if __name__ == "__main__":
    sys.exit(main())
