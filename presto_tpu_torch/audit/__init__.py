"""kernaudit for the port: audits of the op stream a lowered closure
dispatches.

Counterpart of presto_tpu/audit/. The reference audits the closed
jaxpr XLA compiles; the port audits the run of a plan's lowered closure
(exec/planner.py): every aten op it dispatches and every hand-written
kernel it launches, each traced back to the source line that issued
it. Findings are ``lint.core.Finding`` objects (line-independent
fingerprints), the committed ratchet baseline is ``lint.baseline``
applied to ``presto_tpu_torch/audit/baseline.json``, and per-site
suppressions are source comments (``# kernaudit: disable=K001``).
``python -m presto_tpu_torch.audit`` is the corpus gate (cli.py).
"""

from .core import (AuditPass, AuditResult, KernelTrace, all_passes,  # noqa: F401
                   get_pass, register, run_audit)

__all__ = ["AuditPass", "AuditResult", "KernelTrace", "all_passes",
           "get_pass", "register", "run_audit"]
