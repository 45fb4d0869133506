"""Sort and TopN operators: the OrderByOperator and TopNOperator analogs.

Counterpart of presto_tpu/ops/sort.py (`sort_permutation`,
`sort_batch`, `top_n`). The reference sorts a tuple of uint64 key words
with one multi-operand lax.sort; here the same order comes from stable
sorts, one per word, least significant word first (an LSD radix sort
over words). Key words are int64 bit patterns (ops/keys.py), so each
sort compares `word ^ SIGN`, which orders signed as the reference's
words order unsigned. DESC complements the words; NULLS FIRST/LAST
flips the per-column null word. TopN is the sort's first n rows.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..block import Batch, Block, gather_block
from .keys import SIGN, key_words

__all__ = ["lex_permutation", "sort_permutation", "sort_batch", "top_n"]

SortKey = Tuple[int, bool, bool]  # (channel, descending, nulls_last)


def _column_words(col: Block, descending: bool, nulls_last: bool):
    words = key_words([col], nulls_last=[nulls_last != descending])
    if descending:
        words = [~w for w in words]
    return words


def lex_permutation(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting rows by the tuple of int64 `keys`
    (first key most significant, each compared signed): one stable sort
    per key, least significant first."""
    perm = torch.arange(keys[0].shape[0], dtype=torch.int64,
                        device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def sort_permutation(batch: Batch, keys: Sequence[SortKey]) -> torch.Tensor:
    """Stable permutation ordering active rows by `keys`, each a
    (channel, descending, nulls_last) triple; inactive rows sink to the
    end."""
    words: List[torch.Tensor] = [(~batch.active).to(torch.int64)]
    for channel, descending, nulls_last in keys:
        words.extend(_column_words(batch.column(channel), descending,
                                   nulls_last))
    return lex_permutation([w ^ SIGN for w in words])


def sort_batch(batch: Batch, keys: Sequence[SortKey]) -> Batch:
    perm = sort_permutation(batch, keys)
    return Batch(tuple(gather_block(c, perm) for c in batch.columns),
                 batch.active[perm])


def top_n(batch: Batch, keys: Sequence[SortKey], n: int) -> Batch:
    """TopN: the sorted prefix of n rows (static output capacity n)."""
    perm = sort_permutation(batch, keys)[:min(n, batch.capacity)]
    return Batch(tuple(gather_block(c, perm) for c in batch.columns),
                 batch.active[perm])
