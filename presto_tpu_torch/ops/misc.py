"""Limit, Distinct and MarkDistinct: the LimitOperator,
DistinctLimitOperator and MarkDistinctOperator analogs.

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

from ..block import Batch
from .keys import SIGN, key_words
from .sort import lex_permutation

__all__ = ["limit", "mark_distinct", "distinct"]


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
