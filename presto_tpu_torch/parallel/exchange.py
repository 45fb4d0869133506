"""Row hashing for partitioned execution.

Counterpart of presto_tpu/parallel/exchange.py::_row_hash. Grouped
execution and the spilled join (exec/streaming.py, exec/spill.py) put a
row in a bucket by this hash, and the mesh exchange will route by it:
it equals the reference's bit for bit, as int64 bit patterns of the
reference's uint64 lanes. The collectives of the reference's module
are not ported yet (ROADMAP queue 1 item 14).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..block import Block, decoded
from ..expr.functions import combine_hash, hash64_block

__all__ = ["row_hash", "bucket_of"]


def row_hash(cols: Sequence[Block]) -> torch.Tensor:
    """Per-row hash of a key tuple: each column's hash64_block (a
    dictionary decoded first), folded left with combine_hash."""
    h = None
    for c in cols:
        hc = hash64_block(decoded(c))
        h = hc if h is None else combine_hash(h, hc)
    return h


def bucket_of(h: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """The hash's unsigned 64-bit value modulo `n_buckets` (< 2^31), as
    the reference's `h % uint64(n)`: the int64 pattern splits into its
    high and low 32-bit halves, each non-negative."""
    hi = (h >> 32) & 0xFFFFFFFF
    lo = h & 0xFFFFFFFF
    return ((hi % n_buckets) * ((1 << 32) % n_buckets)
            + lo % n_buckets) % n_buckets
