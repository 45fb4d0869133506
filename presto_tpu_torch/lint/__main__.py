"""``python -m presto_tpu_torch.lint``: the port's static-analysis gate
(cli.py has the flags and the exit contract)."""

import sys

from .cli import main

sys.exit(main())
