"""Limit, Distinct, MarkDistinct and GroupId: the LimitOperator,
DistinctLimitOperator, MarkDistinctOperator and GroupIdOperator analogs.

Counterpart of presto_tpu/ops/misc.py. The reference finds distinct
keys with its hash-slot group-id kernel and flags a rerun when the
table overflows. Here distinctness comes from ONE stable sort of
(inactive flag, key words): the first row of each run of equal keys is
marked. The sort is stable, so within a run rows keep their order and
the marked row is the lowest row of its key, the row the reference's
`first[...].min(rows)` picks; the row id is the last sort key without
a sort pass of its own. A sort has no table, so it cannot overflow:
the DistinctNode and MarkDistinctNode are not capacity nodes in the
port (plan/stats.py), and their `max_groups` is carried for the plan
JSON only.

NULL keys are equal here (the key words carry each column's null
word, ops/keys.py), as DISTINCT and set operations need.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .. import types as T
from ..block import Batch, Column, concat_batches, null_like
from .keys import SIGN, key_words
from .sort import lex_permutation

__all__ = ["limit", "mark_distinct", "distinct", "group_id"]


def limit(batch: Batch, n: int) -> Batch:
    """Keep the first n active rows, in row order."""
    pos = torch.cumsum(batch.active.to(torch.int64), dim=0)
    return batch.with_active(batch.active & (pos <= n))


def mark_distinct(batch: Batch, key_channels: Sequence[int]) -> torch.Tensor:
    """True on the first active occurrence, in row order, of each
    distinct key of `key_channels`."""
    words = key_words([batch.column(c) for c in key_channels])
    perm = lex_permutation([(~batch.active).to(torch.int64),
                            *(w ^ SIGN for w in words)])
    first = torch.zeros_like(batch.active)
    first[:1] = True
    for w in words:
        sw = w[perm]
        first[1:] |= sw[1:] != sw[:-1]
    mask = torch.empty_like(first)
    mask[perm] = first & batch.active[perm]
    return mask


def distinct(batch: Batch, key_channels: Sequence[int]) -> Batch:
    """SELECT DISTINCT: deactivate every row mark_distinct leaves
    unmarked."""
    return batch.with_active(mark_distinct(batch, key_channels))


def group_id(batch: Batch, grouping_sets: Sequence[Sequence[int]],
             key_channels: Sequence[int]) -> Batch:
    """One copy of `batch` per grouping set, one after another: key
    channels not in the set are NULL, and a BIGINT column holding the
    set's index is appended."""
    keyset = set(key_channels)
    parts = []
    for gi, kept in enumerate(grouping_sets):
        cols = tuple(null_like(c) if ci in keyset and ci not in kept else c
                     for ci, c in enumerate(batch.columns))
        gid = Column(torch.full((batch.capacity,), gi, dtype=torch.int64,
                                device=batch.active.device),
                     torch.zeros_like(batch.active), T.BIGINT)
        parts.append(Batch(cols + (gid,), batch.active))
    return concat_batches(parts)
