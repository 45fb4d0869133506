"""UNNEST: each row expanded by the array or map in one of its columns.

Counterpart of presto_tpu/ops/unnest.py, with the same prefix-sum
expansion as the join's: output slot k belongs to the source row
whose exclusive offset of live cardinalities is the last one at or
below k (a binary search), and to that row's element k - offset. One
gather per output column, no per-row loop; the output has a static
capacity, and a flag says when the rows did not fit.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from .. import types as T
from ..block import ArrayColumn, Batch, Block, Column, MapColumn, gather_block

__all__ = ["unnest"]


def unnest(batch: Batch, array_channel: int, out_capacity: int,
           with_ordinality: bool = False) -> Tuple[Batch, torch.Tensor]:
    """Expand the rows by the array (or map) at `array_channel`. Output
    columns: every input column but the unnested one, then the element
    column (for a map, a key column and then a value column), then a
    BIGINT ordinality column on request. A NULL or empty collection
    gives no row. Returns (batch, overflow flag)."""
    arr = batch.column(array_channel)
    if not isinstance(arr, (ArrayColumn, MapColumn)):
        raise TypeError(f"unnest of {arr.type}: an array or a map is needed")
    n = batch.capacity
    dev = batch.active.device

    cnt = torch.where(batch.active & ~arr.nulls, arr.lengths,
                      0).to(torch.int64)
    off = torch.cumsum(cnt, 0) - cnt
    total = off[-1] + cnt[-1]
    overflow = total > out_capacity

    k = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    row = (torch.searchsorted(off, k, right=True) - 1).clamp(0, n - 1)
    j = k - off[row]
    valid = (k < total) & (j < cnt[row])
    jc = j.clamp(0, arr.max_cardinality - 1)

    out: List[Block] = [gather_block(c, row, valid)
                        for ci, c in enumerate(batch.columns)
                        if ci != array_channel]
    if isinstance(arr, MapColumn):
        out.append(Column(arr.keys[row, jc], ~valid, arr.type.key_type))
        out.append(Column(arr.values[row, jc],
                          torch.where(valid, arr.value_nulls[row, jc], True),
                          arr.type.value_type))
    else:
        out.append(Column(arr.elements[row, jc],
                          torch.where(valid, arr.elem_nulls[row, jc], True),
                          arr.type.element_type))
    if with_ordinality:
        out.append(Column(j + 1, ~valid, T.BIGINT))
    return Batch(tuple(out), valid), overflow
