"""The finding model and the ratchet baseline the kernel audit
(presto_tpu_torch/audit/) reports through.

Counterpart of the parts of presto_tpu/lint/ that the audit needs:
``Finding`` with the reference's fingerprint law, the per-line
suppression parser, ``github_annotation`` (core.py) and the baseline
ratchet (baseline.py). The AST passes, their CLI and LOCK_ORDER.json
are ROADMAP item 16b.
"""

from .baseline import (apply_baseline, build_baseline,  # noqa: F401
                       load_baseline, run_scoped_baseline, save_baseline)
from .core import Finding, github_annotation, parse_suppressions  # noqa: F401

__all__ = ["Finding", "github_annotation", "parse_suppressions",
           "load_baseline", "save_baseline", "apply_baseline",
           "build_baseline", "run_scoped_baseline"]
