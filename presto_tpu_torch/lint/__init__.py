"""tpulint of the port: AST static analysis of presto_tpu_torch's
hot-path and server-tier discipline, and the finding model and ratchet
baseline the kernel audit (presto_tpu_torch/audit/) reports through.

Counterpart of presto_tpu/lint/, over the port's own files, with the
reference's eleven codes (C001-C004, S001, M001-M003, R001, H001, W001
-- H001 and W001 in torch terms), messages, suppression comments, JSON
schema and exit contract. It reads source only, never a device.

  * ``run_passes`` / ``all_passes`` / ``get_pass`` -- the engine
    (core.py); importing ``presto_tpu_torch.lint.passes`` registers the
    passes.
  * ``load_baseline`` / ``apply_baseline`` -- grandfathered findings
    (baseline.py; ``presto_tpu_torch/lint/baseline.json``, empty).
  * ``cli.main`` -- ``python -m presto_tpu_torch.lint``.
  * ``lockgraph`` -- ``python -m presto_tpu_torch.lint.lockgraph
    --check | --update | --dot`` over the committed
    ``presto_tpu_torch/lint/LOCK_ORDER.json``.
"""

from .baseline import (apply_baseline, build_baseline,  # noqa: F401
                       load_baseline, run_scoped_baseline, save_baseline)
from .core import (Finding, LintPass, LintResult,  # noqa: F401
                   ModuleSource, all_passes, get_pass, github_annotation,
                   parse_suppressions, register, run_passes)

__all__ = ["Finding", "LintPass", "LintResult", "ModuleSource",
           "all_passes", "get_pass", "register", "run_passes",
           "github_annotation", "parse_suppressions", "load_baseline",
           "save_baseline", "apply_baseline", "build_baseline",
           "run_scoped_baseline"]
