"""presto_tpu_torch: the PyTorch/CUDA port of presto_tpu.

A second package beside the JAX reference (`presto_tpu`). It imports
torch and numpy and nothing of JAX or presto_tpu; where it needs a
host-only module of the reference it keeps its own copy. Its entry
point, `run_query`, runs on a CUDA device unless the caller names the
CPU, and the group-by's hot op is a hand-written CUDA kernel
(ops/csrc/limb_partial_sums.cu).
"""

from .exec import QueryResult, run_query

__version__ = "0.1.0"

__all__ = ["run_query", "QueryResult", "__version__"]
