"""Joins: the HashBuilderOperator / LookupJoinOperator analog.

Counterpart of presto_tpu/ops/join.py (`hash_join` for INNER, LEFT,
RIGHT and FULL joins, `semi_join_mask`, and their helpers). No
pointer-chasing hash table: the build side is SORTED by key words once;
probes binary-search it with torch.searchsorted. 1:N matches expand
through a static-capacity prefix-sum expansion:

  start[i] = searchsorted_left(build, probe_i)
  cnt[i]   = searchsorted_right - start  (0 for null/missing keys)
  off      = exclusive_cumsum(cnt)
  out row k maps back to probe row via searchsorted(off, k), and to
  build row start[row] + (k - off[row])

LEFT and FULL emit max(cnt, 1) rows per active probe row, with NULL
build columns where nothing matched. RIGHT and FULL find the build rows
no probe row matches by the reverse probe (build keys binary-search the
sorted probe keys) and append them after the matched region, with NULL
probe columns.

Every step is a fixed-shape gather: the dynamic result size only shows
in the output's active mask and an `overflow` flag when out_capacity is
too small (the runner reruns bigger).

Key words are int64 bit patterns of the reference's uint64 words
(ops/keys.py). Here every word is moved into signed order once
(`word ^ SIGN`), so the sorts, the unusable-row sentinel (the maximum,
INT64_MAX) and searchsorted all use one order, the reference's unsigned
one. A key of several words reduces to one dense rank per row
(`_pack_ranks`), so one searchsorted serves it.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..block import (Batch, Block, StringColumn, decoded, gather_block,
                     pad_chars)
from .keys import SIGN, key_words
from .sort import lex_permutation

__all__ = ["hash_join", "semi_join_mask", "JoinResult"]

_MAXW = (1 << 63) - 1  # the largest word in signed order


@dataclasses.dataclass
class JoinResult:
    batch: Batch          # probe columns ++ build columns
    num_rows: torch.Tensor
    overflow: torch.Tensor


def _align_key_widths(p_keys: Sequence[Block], b_keys: Sequence[Block]):
    """String key columns on the two sides may declare different widths:
    their key words would then disagree in COUNT. Pad the narrower side
    per column so both sides build identical word layouts. Dictionary
    keys decode first."""
    out_p, out_b = [], []
    for pc, bc in zip(p_keys, b_keys):
        pc, bc = decoded(pc), decoded(bc)
        if isinstance(pc, StringColumn) and isinstance(bc, StringColumn):
            w = max(pc.max_len, bc.max_len)
            pc, bc = pad_chars(pc, w), pad_chars(bc, w)
        out_p.append(pc)
        out_b.append(bc)
    return out_p, out_b


def _combined_key(cols: Sequence[Block], active: torch.Tensor
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(value words in signed order, usable mask). Null keys never
    match in joins, so each column's null word is dropped and its rows
    are unusable."""
    words: List[torch.Tensor] = []
    usable = active
    for c in cols:
        words.extend(w ^ SIGN for w in key_words([c])[1:])
        usable = usable & ~c.nulls
    return words, usable


def _sort_build(b_words: List[torch.Tensor], b_usable: torch.Tensor):
    """Sort build rows so the words are globally sorted AND
    searchsorted-safe: unusable rows have all words forced to the
    maximum so they sink to the end without breaking sortedness; within
    equal words, usable rows sort first (trailing tiebreak) so clamping
    match ranges to n_usable keeps exactly the genuine rows. Returns
    (sorted words, permutation)."""
    masked = [torch.where(b_usable, w, _MAXW) for w in b_words]
    tiebreak = (~b_usable).to(torch.int64)
    perm = lex_permutation([*masked, tiebreak])
    return [w[perm] for w in masked], perm


def _probe_ranges(b_words: List[torch.Tensor], b_usable: torch.Tensor,
                  p_words: List[torch.Tensor]):
    """Sort the build side and binary-search every probe key in it:
    (start, end) of each probe row's matches in sorted build order,
    clamped to the usable rows, and the build permutation."""
    sb_words, b_perm = _sort_build(b_words, b_usable)
    if len(p_words) == 1:
        sorted_keys, probe_keys = sb_words[0], p_words[0]
    else:
        sorted_keys, probe_keys = _pack_ranks(sb_words, p_words)
    start = torch.searchsorted(sorted_keys, probe_keys)
    end = torch.searchsorted(sorted_keys, probe_keys, right=True)
    n_usable = b_usable.sum()
    return (torch.minimum(start, n_usable), torch.minimum(end, n_usable),
            b_perm)


def _pack_ranks(build_words: List[torch.Tensor],
                probe_words: List[torch.Tensor]):
    """Reduce multi-word keys to single int64 ranks, exactly. Per word
    level, the union of (rank so far, word) pairs of both sides is
    sorted and densely ranked, so equal key prefixes share a rank and
    rank order is key order. Cost: one union sort per word."""
    nb = build_words[0].shape[0]
    dev = build_words[0].device
    b_rank = torch.zeros(nb, dtype=torch.int64, device=dev)
    p_rank = torch.zeros(probe_words[0].shape[0], dtype=torch.int64,
                         device=dev)
    for bw, pw in zip(build_words, probe_words):
        ranks = torch.cat([b_rank, p_rank])
        words = torch.cat([bw, pw])
        perm = lex_permutation([ranks, words])
        r, w = ranks[perm], words[perm]
        boundary = torch.zeros_like(r, dtype=torch.bool)
        boundary[1:] = (r[1:] != r[:-1]) | (w[1:] != w[:-1])
        dense = torch.cumsum(boundary.to(torch.int64), dim=0)
        new = torch.empty_like(dense)
        new[perm] = dense
        b_rank, p_rank = new[:nb], new[nb:]
    return b_rank, p_rank


def hash_join(probe: Batch, build: Batch,
              probe_key_channels: Sequence[int],
              build_key_channels: Sequence[int],
              out_capacity: int,
              join_type: str = "inner",
              build_output_channels: Optional[Sequence[int]] = None
              ) -> JoinResult:
    """Join probe x build, join_type one of inner, left, right and
    full. Output columns are probe.columns ++
    build.columns[build_output_channels]; output rows are active for
    slots < the row count (matches, then the probe rows of an outer
    probe side that matched nothing, then the build rows of an outer
    build side that matched nothing), which `overflow` flags when it
    exceeds out_capacity."""
    if join_type not in ("inner", "left", "right", "full"):
        raise ValueError(f"unknown join type {join_type!r}")
    if build_output_channels is None:
        build_output_channels = range(build.num_columns)

    p_keys = [probe.column(c) for c in probe_key_channels]
    b_keys = [build.column(c) for c in build_key_channels]
    p_keys, b_keys = _align_key_widths(p_keys, b_keys)
    p_words, p_usable = _combined_key(p_keys, probe.active)
    b_words, b_usable = _combined_key(b_keys, build.active)

    nb = build.capacity
    npr = probe.capacity
    start, end, b_perm = _probe_ranges(b_words, b_usable, p_words)

    cnt = torch.where(p_usable, end - start, 0)
    if join_type in ("left", "full"):
        emit = torch.where(probe.active, cnt.clamp(min=1), 0)
    else:
        emit = cnt
    off = torch.cumsum(emit, dim=0) - emit  # exclusive
    total = off[-1] + emit[-1]
    outer_build = join_type in ("right", "full")
    if outer_build:
        # the reverse probe, in the forward probe's word order and
        # sentinel: does a usable probe row carry this build key?
        bs, be, _ = _probe_ranges(p_words, p_usable, b_words)
        u = (build.active & ~(b_usable & (be > bs))).to(torch.int64)
        off2 = torch.cumsum(u, dim=0) - u  # exclusive, build row order
        total2 = total + off2[-1] + u[-1]
    else:
        total2 = total
    overflow = total2 > out_capacity

    k = torch.arange(out_capacity, dtype=torch.int64, device=cnt.device)
    # map output slot -> probe row
    prow = (torch.searchsorted(off, k, right=True) - 1).clamp(0, npr - 1)
    j = k - off[prow]
    valid = (k < total) & (j < emit[prow])
    build_valid = valid & (j < cnt[prow])
    srow = (start[prow] + j).clamp(0, nb - 1)
    brow = b_perm[srow]  # back to original build row order
    all_valid = valid
    if outer_build:
        # slots [total, total2): the unmatched build rows
        k2 = k - total
        brow2 = (torch.searchsorted(off2, k2, right=True) - 1).clamp(
            0, nb - 1)
        valid2 = (k >= total) & (k < total2) & (k2 - off2[brow2] < u[brow2])
        brow = torch.where(valid2, brow2, brow)
        build_valid = build_valid | valid2
        all_valid = valid | valid2

    out_cols: List[Block] = [gather_block(c, prow, valid)
                             for c in probe.columns]
    out_cols += [gather_block(build.column(ci), brow, build_valid)
                 for ci in build_output_channels]
    return JoinResult(Batch(tuple(out_cols), all_valid), total2, overflow)


def semi_join_mask(probe: Batch, build: Batch,
                   probe_key_channels: Sequence[int],
                   build_key_channels: Sequence[int],
                   null_keys_match: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SemiJoinNode analog: per probe row, 'key IN build side' with
    SQL's three values, as (match, null_flag):

      match      the non-null key has a build match
      null_flag  the IN is NULL: the probe key is NULL, or it has no
                 match and the build side holds a NULL key

    so NOT IN composes through Kleene `not` and the filters. With
    null_keys_match NULL keys compare equal (IS NOT DISTINCT FROM, the
    set-operation semantics) and null_flag is always False."""
    p_keys = [probe.column(c) for c in probe_key_channels]
    b_keys = [build.column(c) for c in build_key_channels]
    p_keys, b_keys = _align_key_widths(p_keys, b_keys)
    if null_keys_match:
        # the null words join the key: NULL == NULL
        p_words = [w ^ SIGN for w in key_words(p_keys)]
        b_words = [w ^ SIGN for w in key_words(b_keys)]
        p_usable, b_usable = probe.active, build.active
    else:
        p_words, p_usable = _combined_key(p_keys, probe.active)
        b_words, b_usable = _combined_key(b_keys, build.active)
    start, end, _ = _probe_ranges(b_words, b_usable, p_words)
    match = p_usable & (end > start)
    if null_keys_match:
        return match, torch.zeros_like(match)
    build_has_null = (build.active & ~b_usable).any()
    null_flag = (probe.active & ~p_usable) | \
        (probe.active & ~match & build_has_null)
    return match, null_flag
