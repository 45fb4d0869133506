"""``python -m presto_tpu_torch.audit``: the corpus gate (cli.py)."""

import sys

from .cli import main

sys.exit(main())
