"""presto_tpu_torch: the PyTorch/CUDA port of presto_tpu.

A second package beside the JAX reference (`presto_tpu`). It imports
torch and numpy and nothing of JAX or presto_tpu; where it needs a
host-only module of the reference it keeps its own copy. Its entry
points, `sql` (SQL text in, rows out) and `run_query` (a plan in), run
on a CUDA device unless the caller names the CPU, and the group-by's
hot op is a hand-written CUDA kernel (ops/csrc/fused_limb_sums.cu).
"""

from .exec import QueryResult, prepare_plan, run_query
from .sql import plan_sql, sql

__version__ = "0.1.0"

__all__ = ["sql", "plan_sql", "run_query", "prepare_plan", "QueryResult",
           "__version__"]
