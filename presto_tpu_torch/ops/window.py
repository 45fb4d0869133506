"""Window functions: the WindowOperator / RowNumberOperator analog.

Counterpart of presto_tpu/ops/window.py, with its design: one global
stable sort by (inactive flag, partition words, order words) turns
every window computation into segmented scans over the sorted order,
and the results scatter back to the input rows through the sort's
permutation.

  part_start[i]  first sorted position of i's partition
  run_start[i]   first sorted position of i's (partition, order) peer run
  row_number     pos - part_start + 1
  rank           run_start - part_start + 1
  dense_rank     (# order boundaries in partition before pos) + 1
  frame sums     differences of one global cumsum at the frame's ends
  frame min/max  a segmented running scan (frames from the partition
                 head) or a sparse table (bounded-start frames)

The sort is `ops/sort.lex_permutation` over the words in signed order
(`word ^ SIGN`, ops/keys.py). The reference's `lax.cummax`/`cummin`
are `torch.cummax`/`cummin` (values only); its associative scans with
a custom combine are log-step (Hillis-Steele) scans over (value,
boundary) pairs here; a RANGE value frame searches the composite
(segment, order value) key with one `torch.searchsorted`, after the
join's dense ranking of multi-word keys. Long-decimal (Int128Column)
sums are exact: 13-bit limb cumsums recombined to (hi, lo), avg
divided half up. Double sums are cumsum differences as in the
reference; torch's cumsum adds in another order than XLA's, so they
agree within rounding, not bit for bit. NULL inputs are skipped;
padding and inactive rows get NULL outputs.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from .. import types as T
from ..block import (Batch, Block, Column, Int128Column, StringColumn,
                     decoded, torch_dtype)
from ..int128 import (cmp128, combine_limb_totals_128, div128_by_count,
                      limbs13_of_128)
from .join import _pack_ranks
from .keys import SIGN, _fixed_words, key_words
from .sort import SortKey, _column_words, lex_permutation

__all__ = ["WindowSpec", "window", "specs_of"]

_FUNCS = ("row_number", "rank", "dense_rank", "sum", "count", "avg", "min",
          "max", "first_value", "last_value", "ntile", "percent_rank",
          "cume_dist", "lag", "lead", "nth_value")

_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    name: str
    input_channel: Optional[int] = None
    output_type: T.Type = T.BIGINT
    # frame: "range_current" (default: RANGE UNBOUNDED PRECEDING..CURRENT
    # ROW), "full" (whole partition), or a ROWS or RANGE frame
    # ("rows" | "range", start, end) with signed row (ROWS) or order-key
    # value (RANGE) offsets, None = unbounded on that side
    frame: object = "range_current"
    ntile_buckets: int = 0
    offset: int = 1  # lag/lead distance; nth_value's n

    def __post_init__(self):
        assert self.name in _FUNCS, self.name
        if self.name == "ntile":
            assert self.ntile_buckets > 0, "ntile requires a positive bucket count"
        if self.name == "nth_value":
            assert self.offset >= 1, "nth_value's n must be at least 1"
        if isinstance(self.frame, (tuple, list)):
            assert self.frame[0] in ("rows", "range"), self.frame


def specs_of(functions) -> List[WindowSpec]:
    """The specs of a WindowNode's (name, channel, type, frame, k)
    entries: k is the function's int parameter, ntile's bucket count,
    lag/lead's offset or nth_value's n."""
    return [WindowSpec(name, ch, ty, frame,
                       ntile_buckets=(k or 0) if name == "ntile" else 0,
                       offset=((1 if k is None else k)
                               if name in ("lag", "lead", "nth_value")
                               else 1))
            for name, ch, ty, frame, k in functions]


def _is_bounded(frame) -> bool:
    return isinstance(frame, (tuple, list))


def _seg_positions(words: List[torch.Tensor]) -> torch.Tensor:
    """Boundary mask: True where any word differs from the previous row."""
    b = torch.zeros(words[0].shape[0], dtype=torch.bool,
                    device=words[0].device)
    for w in words:
        b[1:] |= w[1:] != w[:-1]
    b[:1] = True
    return b


def _rev_cummin(x: torch.Tensor) -> torch.Tensor:
    """out[i] = min(x[i:])."""
    return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])


def window(batch: Batch, partition_channels: Sequence[int],
           order_keys: Sequence[SortKey], specs: Sequence[WindowSpec]) -> Batch:
    """Returns the input batch with one appended column per spec (same
    row order as the input; padding rows get nulls). Dictionary columns
    decode first."""
    batch = Batch(tuple(decoded(c) for c in batch.columns), batch.active)
    n = batch.capacity
    dev = batch.active.device

    pwords = key_words([batch.column(c) for c in partition_channels])
    owords: List[torch.Tensor] = []
    for ch, desc, nulls_last in order_keys:
        owords.extend(_column_words(batch.column(ch), desc, nulls_last))
    lead = (~batch.active).to(torch.int64)
    perm = lex_permutation([w ^ SIGN for w in [lead, *pwords, *owords]])
    s_active = batch.active[perm]
    s_pwords = [w[perm] for w in pwords]
    s_owords = [w[perm] for w in owords]

    if s_pwords:
        part_bound = _seg_positions(s_pwords) | ~s_active
    else:
        # OVER () / no PARTITION BY: one whole-input partition
        part_bound = ~s_active
        part_bound[:1] = True
    run_bound = part_bound | (_seg_positions(s_owords) if s_owords
                              else torch.zeros_like(part_bound))

    spos = torch.arange(n, dtype=torch.int64, device=dev)
    part_start = torch.cummax(torch.where(part_bound, spos, 0), 0).values
    run_start = torch.cummax(torch.where(run_bound, spos, 0), 0).values
    # partition (peer run) end: the first boundary after i, less one
    nb = torch.cat([torch.where(part_bound, spos, n)[1:],
                    spos.new_full((1,), n)])
    part_end = _rev_cummin(nb) - 1
    nrb = torch.cat([torch.where(run_bound, spos, n)[1:],
                     spos.new_full((1,), n)])
    run_end = _rev_cummin(nrb) - 1

    row_number = spos - part_start + 1
    rank = run_start - part_start + 1
    # dense rank: count of run boundaries in (part_start, pos]
    rb = torch.cumsum(run_bound.to(torch.int64), 0)
    dense = rb - rb[part_start] + 1
    part_rows = part_end - part_start + 1

    out_cols: List[Block] = list(batch.columns)
    inv = torch.empty_like(spos)
    inv[perm] = spos

    # RANGE value-offset frames search the (single, ASC) order key's
    # values within each partition; null-order-key rows are overridden
    # to their peer run by _frame_bounds, and the sentinel keeps the
    # search from wandering into the null zone.
    o_vals_sorted = o_nulls_sorted = seg_id = None
    if any(_is_bounded(s.frame) and s.frame[0] == "range" for s in specs):
        assert len(order_keys) == 1, \
            "RANGE value frames require exactly one ORDER BY key"
        ch, desc, nulls_last = order_keys[0]
        assert not desc, "RANGE value frames over DESC order keys"
        ocol = batch.column(ch)
        assert not isinstance(ocol, (StringColumn, Int128Column)), \
            "RANGE value frame over unsupported order-key column"
        o_nulls_sorted = (ocol.nulls | ~batch.active)[perm]
        if ocol.type.is_floating:
            ov = ocol.values[perm].to(torch.float64)
            sent = float("inf") if nulls_last else float("-inf")
        else:
            ov = ocol.values[perm].to(torch.int64)
            sent = _I64_MAX if nulls_last else _I64_MIN
        o_vals_sorted = torch.where(o_nulls_sorted, sent, ov)
        seg_id = torch.cumsum(part_bound.to(torch.int64), 0)

    def frame_bounds(frame):
        return _frame_bounds(frame, spos, part_start, part_end, run_end,
                             o_vals_sorted, o_nulls_sorted, run_start,
                             seg_id)

    for spec in specs:
        name = spec.name
        if name == "row_number":
            vals_sorted = row_number
            nulls_sorted = ~s_active
        elif name == "rank":
            vals_sorted = rank
            nulls_sorted = ~s_active
        elif name == "dense_rank":
            vals_sorted = dense
            nulls_sorted = ~s_active
        elif name == "percent_rank":
            denom = torch.clamp(part_rows - 1, min=1).to(torch.float64)
            vals_sorted = torch.where(part_rows == 1, 0.0,
                                      (rank - 1).to(torch.float64) / denom)
            nulls_sorted = ~s_active
        elif name == "cume_dist":
            vals_sorted = (run_end - part_start + 1).to(torch.float64) / \
                part_rows.to(torch.float64)
            nulls_sorted = ~s_active
        elif name == "ntile":
            k = spec.ntile_buckets
            r0 = row_number - 1
            vals_sorted = torch.clamp(
                r0 * k // torch.clamp(part_rows, min=1), max=k - 1) + 1
            nulls_sorted = ~s_active
        elif name in ("lag", "lead"):
            col = batch.column(spec.input_channel)
            assert not isinstance(col, StringColumn), \
                "lag/lead over strings is not yet supported"
            k = spec.offset if name == "lag" else -spec.offset
            src = torch.clamp(spos - k, 0, n - 1)
            same_part = part_start[src] == part_start
            in_rng = (spos - k >= 0) & (spos - k < n)
            ok = in_rng & same_part & s_active
            v_sorted = col.values[perm]
            n_sorted = col.nulls[perm]
            vals_sorted = torch.where(ok, v_sorted[src], v_sorted)
            nulls_sorted = torch.where(ok, n_sorted[src], True) | ~s_active
        elif name == "count" and spec.input_channel is None:
            # count(*) over frame: rows (not non-null values)
            f_lo, f_hi = frame_bounds(spec.frame)
            vals_sorted = torch.clamp(f_hi - f_lo + 1, min=0)
            nulls_sorted = ~s_active
        elif name in ("sum", "count", "avg", "min", "max", "first_value",
                      "last_value", "nth_value"):
            col = batch.column(spec.input_channel)
            assert not isinstance(col, StringColumn), \
                f"window {name} over strings is not yet supported"
            f_lo, f_hi = frame_bounds(spec.frame)
            f_hi_c = torch.clamp(f_hi, 0, n - 1)
            f_lo_c = torch.clamp(f_lo, 0, n - 1)
            empty_frame = f_hi < f_lo

            def frame_total(contrib):
                """Inclusive [f_lo, f_hi] totals via padded-cumsum diff."""
                ps = torch.cumsum(contrib, 0)
                base = torch.where(f_lo > 0,
                                   ps[torch.clamp(f_lo - 1, min=0)], 0)
                return torch.where(empty_frame, 0, ps[f_hi_c] - base)

            nn_sorted = (~col.nulls & batch.active)[perm]
            if name in ("first_value", "last_value", "nth_value"):
                if name == "first_value":
                    idx = f_lo_c
                elif name == "last_value":
                    idx = f_hi_c
                else:  # nth_value(x, n): n-th row of the frame
                    idx = torch.clamp(f_lo + (spec.offset - 1), 0, n - 1)
                # membership is tested on the UNCLIPPED index: a clipped
                # idx can land back on a valid slot (e.g. n beyond the
                # frame at the last array position) and must stay NULL
                in_frame = (~empty_frame) & \
                    (f_lo + (spec.offset - 1 if name == "nth_value" else 0)
                     <= f_hi)
                if isinstance(col, Int128Column):
                    nl = (col.nulls | ~batch.active)[perm]
                    nulls = nl[idx] | ~in_frame | ~s_active
                    out_cols.append(Int128Column(
                        col.hi[perm][idx][inv], col.lo[perm][idx][inv],
                        nulls[inv], spec.output_type))
                    continue
                vals_sorted = col.values[perm][idx]
                nulls_sorted = col.nulls[perm][idx] | ~in_frame | ~s_active
            elif isinstance(col, Int128Column):
                # long-decimal inputs (aggregation states feeding a
                # window stage, the q53/q12/q51 shapes): exact windowed
                # sums via 13-bit limb cumsums recombined to (hi, lo);
                # avg divides with the decimal half-up rule; min/max by
                # a segmented 128-bit scan
                out_cols.append(_window128(
                    spec, col, perm, inv, nn_sorted, s_active, part_bound,
                    f_hi_c, empty_frame, frame_total))
                continue
            elif name in ("sum", "avg", "count"):
                v_sorted = col.values[perm]
                sv = v_sorted.to(torch.float64 if col.type.is_floating
                                 else torch.int64)
                wsum = frame_total(torch.where(nn_sorted, sv, 0))
                wcnt = frame_total(nn_sorted.to(torch.int64))
                if name == "sum":
                    vals_sorted = wsum
                    nulls_sorted = (wcnt == 0) | ~s_active
                elif name == "count":
                    vals_sorted = wcnt
                    nulls_sorted = ~s_active
                else:
                    vals_sorted = wsum.to(torch.float64) / \
                        torch.clamp(wcnt, min=1).to(torch.float64)
                    if not spec.output_type.is_floating:
                        # decimal-typed avg: scaled float mean -> scaled int
                        vals_sorted = torch.round(vals_sorted)
                    nulls_sorted = (wcnt == 0) | ~s_active
            else:  # min, max
                minimize = name == "min"
                v_sorted = col.values[perm]
                if col.type.is_floating:
                    v_sorted = v_sorted.to(torch.float64)
                    ident = float("inf") if minimize else float("-inf")
                else:
                    v_sorted = v_sorted.to(torch.int64)
                    ident = _I64_MAX if minimize else _I64_MIN
                sv = torch.where(nn_sorted, v_sorted, ident)
                if _is_bounded(spec.frame) and spec.frame[1] is not None:
                    # general bounded-start frame: sparse-table range
                    # extreme. For ROWS frames with a bounded end the
                    # static offsets cap the frame length, so only
                    # log2(w) levels are built; RANGE value offsets say
                    # nothing about row counts, so no cap applies.
                    _s, _e = spec.frame[1], spec.frame[2]
                    cap = (_e - _s + 1) if (_e is not None and
                                            spec.frame[0] == "rows") else None
                    vals_sorted = _range_extreme(sv, f_lo_c, f_hi_c,
                                                 ident, minimize,
                                                 max_len=cap)
                else:
                    # frame starts at the partition head: the cheaper
                    # segmented running scan answers any end bound
                    op = torch.minimum if minimize else torch.maximum
                    vals_sorted = _segmented_scan(sv, part_bound, op)[f_hi_c]
                wcnt = frame_total(nn_sorted.to(torch.int64))
                nulls_sorted = (wcnt == 0) | empty_frame | ~s_active
        else:
            raise NotImplementedError(name)

        dt = torch_dtype(spec.output_type.to_dtype())
        out_cols.append(Column(vals_sorted[inv].to(dt), nulls_sorted[inv],
                               spec.output_type))

    return Batch(tuple(out_cols), batch.active)


def _window128(spec: WindowSpec, col: Int128Column, perm, inv, nn_sorted,
               s_active, part_bound, f_hi_c, empty_frame,
               frame_total) -> Int128Column:
    """sum/avg/count/min/max of one long-decimal column over each
    row's frame, exactly."""
    name = spec.name
    if name in ("min", "max"):
        if _is_bounded(spec.frame) and spec.frame[1] is not None:
            raise NotImplementedError(
                "bounded-start ROWS min/max over long decimals")
        minimize = name == "min"
        ih = _I64_MAX if minimize else _I64_MIN
        il = -1 if minimize else 0  # the unsigned low word's max / min
        h_s = torch.where(nn_sorted, col.hi[perm], ih)
        l_s = torch.where(nn_sorted, col.lo[perm], il)
        sh, sl = _segmented_extreme128(h_s, l_s, part_bound, minimize)
        wcnt = frame_total(nn_sorted.to(torch.int64))
        empty = (wcnt == 0) | empty_frame | ~s_active
        return Int128Column(sh[f_hi_c][inv], sl[f_hi_c][inv], empty[inv],
                            spec.output_type)
    if name not in ("sum", "avg", "count"):
        raise NotImplementedError(f"window {name} over long decimals")
    wcnt = frame_total(nn_sorted.to(torch.int64))
    if name == "count":
        return Column(wcnt[inv], (~s_active)[inv], spec.output_type)
    totals = [frame_total(torch.where(nn_sorted, limb[perm], 0))
              for limb in limbs13_of_128(col.hi, col.lo)]
    hi, lo = combine_limb_totals_128(torch.stack(totals, dim=-1))
    empty = (wcnt == 0) | ~s_active
    if name == "avg":
        q = div128_by_count(hi, lo, torch.clamp(wcnt, min=1))
        hi, lo = q >> 63, q
    return Int128Column(hi[inv], lo[inv], empty[inv], spec.output_type)


def _ordered(v: torch.Tensor) -> torch.Tensor:
    """int64 lanes whose signed order is the order of the values `v`
    (int64 or float64): the key words of ops/keys.py, in signed order."""
    if not v.is_floating_point():
        return v
    w = _fixed_words(Column(v, torch.zeros_like(v, dtype=torch.bool),
                            T.DOUBLE))[0]
    return w ^ SIGN


def _frame_bounds(frame, spos, part_start, part_end, run_end,
                  order_vals=None, order_nulls=None, run_start=None,
                  seg_id=None):
    """Inclusive [lo, hi] sorted-position bounds of each row's frame.
    "range_current" = RANGE UNBOUNDED PRECEDING..CURRENT ROW (peer-
    inclusive via run_end); "full" = whole partition; ("rows", s, e) =
    signed row offsets; ("range", s, e) = ORDER-KEY VALUE offsets (both:
    None = unbounded on that side). Value frames search the partition's
    sorted order values; rows whose order key is NULL frame over their
    null-peer run (the SQL null-peers rule)."""
    if _is_bounded(frame) and frame[0] == "range":
        _mode, s, e = frame
        v = order_vals
        # (segment, value) is ascending along the sorted order, so one
        # search of (row's segment, target) lands inside its partition
        if s is None:
            lo = part_start
        else:
            lo = _seg_search(seg_id, v, v + s, right=False)
        if e is None:
            hi = part_end
        else:
            hi = _seg_search(seg_id, v, v + e, right=True) - 1
        if order_nulls is not None:
            # null-order-key rows treat all null rows as peers, but ONLY
            # on offset-bounded sides: an UNBOUNDED side still reaches
            # the partition edge for them (Presto/Postgres null-peers
            # semantics)
            if s is not None:
                lo = torch.where(order_nulls, run_start, lo)
            if e is not None:
                hi = torch.where(order_nulls, run_end, hi)
        return lo, hi
    if _is_bounded(frame):
        _mode, s, e = frame
        lo = part_start if s is None else torch.maximum(part_start, spos + s)
        hi = part_end if e is None else torch.minimum(part_end, spos + e)
        return lo, hi
    if frame == "full":
        return part_start, part_end
    return part_start, run_end


def _seg_search(seg_id, vals, targets, right: bool):
    """Per row, the insertion point of (seg_id[i], targets[i]) into the
    ascending sequence of (seg_id, vals) pairs: its 'left' or 'right'
    position inside row i's own partition. The pairs reduce to dense
    int64 ranks (ops/join._pack_ranks), so one searchsorted serves."""
    sorted_rank, target_rank = _pack_ranks(
        [seg_id, _ordered(vals)], [seg_id, _ordered(targets)])
    return torch.searchsorted(sorted_rank, target_rank, right=right)


def _range_extreme(sv, lo, hi, ident, minimize: bool, max_len=None):
    """Min/max over arbitrary inclusive [lo, hi] ranges via a sparse
    table: level k holds extrema of length-2^k blocks; a query combines
    the two blocks covering the range (O(n log n) build, O(1) gathers
    per row). `max_len` (a static bound on hi-lo+1, when the caller
    knows one) caps the level count at log2(max_len)."""
    n = sv.shape[0]
    op = torch.minimum if minimize else torch.maximum
    levels = [sv]
    k = 1
    k_stop = max(min(n, max_len if max_len is not None else n), 1)
    while k < k_stop:
        prev = levels[-1]
        shifted = torch.cat([prev[k:], sv.new_full((min(k, n),), ident)])
        levels.append(op(prev, shifted))
        k *= 2
    table = torch.stack(levels)  # (L, n)
    length = torch.clamp(hi - lo + 1, min=1)
    # floor(log2(length)) seeded by f32 log2, then corrected one step in
    # each direction: f32 rounding is off by at most 1 (e.g. log2 of
    # 2^21 - 1 rounds UP to exactly 21.0)
    kk = torch.floor(torch.log2(length.to(torch.float32))).to(torch.int64)
    kk = torch.clamp(kk, 0, len(levels) - 1)
    kk = torch.where((1 << kk) > length, kk - 1, kk)
    kk = torch.where((kk + 1 < len(levels)) & ((1 << (kk + 1)) <= length),
                     kk + 1, kk)
    kk = torch.clamp(kk, 0, len(levels) - 1)
    a = table[kk, lo]
    b = table[kk, torch.clamp(hi - (1 << kk) + 1, 0, n - 1)]
    return op(a, b)


def _hillis_steele(flags: torch.Tensor, lanes, combine):
    """Inclusive segmented scan, restarting where `flags` is set: log2(n)
    steps, each combining every position with the one d before it
    (earlier operand first) unless a boundary lies in between."""
    n = flags.shape[0]
    d = 1
    while d < n:
        f_prev, f_cur = flags[:-d], flags[d:]
        prev = [x[:-d] for x in lanes]
        cur = [x[d:] for x in lanes]
        merged = combine(prev, cur)
        lanes = [torch.cat([x[:d], torch.where(f_cur, c, m)])
                 for x, c, m in zip(lanes, cur, merged)]
        flags = torch.cat([flags[:d], f_prev | f_cur])
        d *= 2
    return lanes


def _segmented_scan(vals, seg_bound, op):
    """Inclusive segmented running min/max (`op`): restart at each
    boundary."""
    return _hillis_steele(seg_bound, [vals],
                          lambda a, b: [op(a[0], b[0])])[0]


def _segmented_extreme128(h, l, seg_bound, minimize: bool):
    """Inclusive segmented running min/max over int128 (hi, lo) lanes,
    compared 128-bit lexicographically (signed hi, unsigned lo)."""
    def combine(a, b):
        a_lt_b, _ = cmp128(a[0], a[1], b[0], b[1])
        pick_b = ~a_lt_b if minimize else a_lt_b
        return [torch.where(pick_b, b[0], a[0]),
                torch.where(pick_b, b[1], a[1])]

    sh, sl = _hillis_steele(seg_bound, [h, l], combine)
    return sh, sl
