"""Grouped aggregation: the HashAggregationOperator analog.

Counterpart of presto_tpu/ops/aggregation.py for sum/avg/count/
count_star/min/max/count_distinct: its small-table path (max_groups <=
64, the TPC-H q1 shape), its keyless one-slot path (q6, q14) and its
sorted large-table path (q3). The small-table path has no hash table
and no scatter:

1. group ids by first-occurrence extraction (`_group_ids_small`): each
   round takes the first unresolved row and resolves every row with
   equal key words, at most max_groups rounds;
2. every integer accumulator of every aggregate joins one request pool
   (`_SegSumPool`) as a descriptor of the lanes it reads (source lane,
   live mask, bit offset, width). ONE launch of the fused_limb_sums
   kernel (ops/kernels.py) reads each distinct lane once, splits the
   limbs in registers and sums them per group into exact int64 totals;
3. decimal sums are 128-bit: 13-bit limbs whose exact totals recombine
   into (hi, lo) once per group (`_sum128`).

The reference collects requests in a first trace and serves them in a
second, which XLA's dead-code elimination makes free. PyTorch runs
eagerly, so here each aggregate hands the pool its requests and returns
closures that build its state columns once the pool has computed.

The large-table path (`_group_by_sorted`, max_groups > 64) is
scatter-free too: one sort of the key words, segment boundaries by
adjacent-word inequality, per-group [start, end) ranges by
searchsorted, and every sum as differences of a padded cumsum over
13-bit limbs (`_seg_total`), exact in int64.

min and max are per-group extremes in both paths (`_seg_extreme`,
`_argbest`): a scatter_reduce over the group ids (the segment ids in
sorted order) with dead rows at the identity. Long decimals and
strings take the extreme row word by word (for Int128 lanes the signed
`hi`, then `lo` as unsigned), and gather its value.

count_distinct counts the distinct non-null values per group. In the
sorted path it rides the one sort: the value's words follow the key
words (nulls last), and a row that starts a new (key, value) pair
counts. In the small-table and keyless paths it marks the first row of
each (group id, value) pair with ops/misc.mark_distinct and counts the
marks per group.

Limb forms (an argument, not a knob): "narrow" (the default) takes the
fused kernel; "wide" keeps the unfused path of the TPU kernel's
contract: requests materialise into 13-bit limbs stacked as an (n, L)
float32 matrix that the per-tile limb_partial_sums kernel sums.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..block import Batch, Block, Column, Int128Column, gather_block
from ..expr.functions import lookup
from ..int128 import (combine_limb_totals_128, limbs13_of_128,
                      limbs13_of_i64, limbs_of_i64)
from . import kernels as K
from .keys import SIGN, key_words, string_words
from .misc import mark_distinct
from .sort import lex_permutation

__all__ = ["AggSpec", "GroupByResult", "group_by", "finalize_states",
           "SMALL_G", "LIMB_FORMS"]

SMALL_G = 64  # the largest group table of the small-table path
LIMB_FORMS = ("narrow", "wide")

@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate: `name(input_channel)` -> a column of `output_type`.
    input_channel is None for count(*)."""
    name: str
    input_channel: Optional[int]
    output_type: T.Type


@dataclasses.dataclass
class GroupByResult:
    """Dense group table: one row per group (keys, then aggregate
    states), active for slots < num_groups. `overflow` is True when the
    distinct keys exceeded max_groups; the caller reruns bigger."""
    batch: Batch
    num_groups: torch.Tensor
    overflow: torch.Tensor


def _group_ids(key_cols: Sequence[Block], active: torch.Tensor,
               max_groups: int):
    """(ids int32, perm_first, num_groups, overflow); perm_first[g] is a
    row of group g, used to gather the key values."""
    n = active.shape[0]
    words = key_words(key_cols)
    dev = active.device
    if not words:  # global aggregation: every row is group 0
        return (torch.zeros(n, dtype=torch.int32, device=dev),
                torch.zeros(max_groups, dtype=torch.int64, device=dev),
                active.any().to(torch.int32),
                torch.zeros((), dtype=torch.bool, device=dev))
    return _group_ids_small(words, active, max_groups)


def _group_ids_small(words, active: torch.Tensor, max_groups: int):
    """First-occurrence extraction. The reference's while-loop exits
    once every active row is resolved, which needs a host read of a
    device flag per round; here all max_groups rounds run with no host
    sync, a round with nothing left to resolve changing nothing.
    Active rows still unresolved after the last round mean more than
    max_groups distinct keys: overflow (they park in the last slot)."""
    n = active.shape[0]
    dev = active.device
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    ids = torch.full((n,), -1, dtype=torch.int32, device=dev)
    first = torch.zeros(max_groups, dtype=torch.int64, device=dev)
    num_groups = torch.zeros((), dtype=torch.int32, device=dev)
    for g in range(max_groups):
        unres = active & (ids < 0)
        i = torch.where(unres, rows, n).min()
        found = i < n
        i_safe = i.clamp(0, max(n - 1, 0)).reshape(1)
        match = unres
        for w in words:
            match = match & (w == w.index_select(0, i_safe))
        ids = ids.masked_fill(match, g)
        first[g] = torch.where(found, i_safe[0], 0)
        num_groups = num_groups + found.to(torch.int32)
    overflow = (active & (ids < 0)).any()
    ids = torch.where(active & (ids >= 0), ids, max_groups - 1)
    return ids, first, num_groups, overflow


@dataclasses.dataclass(frozen=True, eq=False)
class _Request:
    """One queued per-group sum, as a descriptor: bits [shift, shift +
    bits) of `source` (a lane, or the (hi, lo) pair of a 128-bit value)
    as an unsigned field, or with `remainder` every bit from `shift` up,
    signed; zero where `mask` is False. The fused kernel reads the
    source lanes themselves; `materialize` gives the int64 contribution
    the reference queues, for the tests and the other forms."""
    source: K.Source
    mask: Optional[torch.Tensor]
    shift: int
    bits: int
    remainder: bool

    def materialize(self) -> torch.Tensor:
        x = K.source_field(self.source, self.shift, self.bits,
                           self.remainder)
        return x if self.mask is None else torch.where(self.mask, x, 0)


def _as_request(r) -> _Request:
    """A descriptor, or a plain (contrib, value_bits) whole-lane request."""
    if isinstance(r, _Request):
        return r
    contrib, value_bits = r
    return _Request(contrib, None, 0, int(value_bits), True)


def _fused_limb_sums(ids: torch.Tensor, requests, max_groups: int,
                     limb_form: str = "narrow") -> List[torch.Tensor]:
    """Every integer seg-sum of `requests` (descriptors, or plain
    (contrib, value_bits) pairs) -> list of (G,) exact int64 totals.
    Narrow: ONE fused_limb_sums launch over the distinct source lanes
    (each tensor passed once), the limb split inside the kernel. Wide:
    the requests materialise into float32 13-bit limbs stacked into an
    (n, L) matrix, ONE limb_partial_sums launch sums them per tile, the
    tiles add in int64 and the limbs recombine by shifts."""
    if limb_form not in LIMB_FORMS:
        raise ValueError(f"limb_form must be one of {LIMB_FORMS}")
    reqs = [_as_request(r) for r in requests]
    ids = ids.to(torch.int32)
    if limb_form == "narrow":
        sources: List[K.Source] = []
        slots = {}

        def slot(src) -> int:
            key = tuple(map(id, src)) if isinstance(src, tuple) else id(src)
            if key not in slots:
                slots[key] = len(sources)
                sources.append(src)
            return slots[key]

        kreqs = [K.LimbRequest(slot(r.source),
                               -1 if r.mask is None else slot(r.mask),
                               r.shift, r.bits, r.remainder) for r in reqs]
        return list(K.fused_limb_sums(ids, sources, kreqs, max_groups)
                    .unbind(1))
    limb_bits = 13
    limb_cols = []
    spans = []
    for r in reqs:
        nl = max(-(-r.bits // limb_bits), 1)
        x = r.materialize()
        spans.append((len(limb_cols), nl))
        limb_cols.extend(limbs_of_i64(x, limb_bits, nl) if nl > 1 else [x])
    lm = torch.stack([l.to(torch.float32) for l in limb_cols], dim=1)
    part = K.limb_partial_sums(ids, lm, max_groups)
    tot = part.to(torch.int64).sum(dim=0)  # (G, L)
    # limb weights 2^(13 k), made on the device (no host copy)
    shifts = limb_bits * torch.arange(max(nl for _, nl in spans),
                                      dtype=torch.int64, device=tot.device)
    weights = torch.ones_like(shifts) << shifts
    return [(tot[:, start:start + nl] * weights[:nl]).sum(dim=1)
            for start, nl in spans]


class _SegSumPool:
    """Batches every integer per-group sum of one group_by call. `add`
    queues a descriptor and returns its handle; `compute` runs them all
    (one fused kernel launch for 1 < G <= 64, a plain reduction per
    request for the single group of a global aggregation); `result`
    then reads a handle's (G,) int64 totals."""

    def __init__(self, ids: torch.Tensor, max_groups: int, limb_form: str):
        self.ids = ids
        self.g = max_groups
        self.limb_form = limb_form
        self.requests: List[_Request] = []
        self.results: Optional[List[torch.Tensor]] = None

    def add(self, request: _Request) -> int:
        self.requests.append(request)
        return len(self.requests) - 1

    def compute(self) -> None:
        if self.g == 1:
            self.results = [r.materialize().sum().reshape(1)
                            for r in self.requests]
        elif self.requests:
            self.results = _fused_limb_sums(self.ids, self.requests, self.g,
                                            self.limb_form)
        else:
            self.results = []
        self.requests = []

    def result(self, handle: int) -> torch.Tensor:
        return self.results[handle]


def _seg_add(pool: _SegSumPool, values: torch.Tensor, live: torch.Tensor,
             value_bits: int) -> int:
    """Queue a per-group sum of `values` over the live rows."""
    return pool.add(_Request(values, live, 0, value_bits, True))


def _seg_count(pool: _SegSumPool, flags: torch.Tensor) -> int:
    """Queue a per-group count of True flags."""
    return pool.add(_Request(flags, None, 0, 1, True))


def _lane_bits(values: torch.Tensor) -> int:
    """Proven bit width of a value lane: its physical dtype's width
    (narrowed lanes are themselves a proof of the value range)."""
    if values.dtype == torch.bool:
        return 1
    return values.element_size() * 8


def _nlimbs13(values: torch.Tensor) -> int:
    return max(-(-_lane_bits(values) // 13), 1)


def _sum128(pool: _SegSumPool, col: Block, live: torch.Tensor) -> List[int]:
    """Queue the 13-bit limbs of an exact per-group 128-bit sum, each a
    descriptor of the column's own lanes; the totals recombine with
    combine_limb_totals_128."""
    if isinstance(col, Int128Column):
        source, nl = (col.hi, col.lo), 10  # 10 limbs cover decimal(38)
    else:
        source, nl = col.values, _nlimbs13(col.values)
    return [pool.add(_Request(source, live, 13 * k, 13, k == nl - 1))
            for k in range(nl)]


def _sum_type(in_ty: T.Type) -> T.Type:
    return T.decimal(38, in_ty.scale) if in_ty.is_decimal else T.BIGINT


StateBuilder = Callable[[], Block]


def _acc_columns(spec: AggSpec, col: Optional[Block], active: torch.Tensor,
                 live: Optional[torch.Tensor],
                 pool: _SegSumPool) -> List[StateBuilder]:
    """Queue one aggregate's sums and return a builder per state column
    (avg has two: sum and count), called after pool.compute(). `live`
    is the column's active non-null mask, one tensor per input channel
    so that the pool passes it to the kernel once."""
    g = pool.g
    no_nulls = torch.zeros(g, dtype=torch.bool, device=active.device)
    name = spec.name
    if name == "count_star":
        h = _seg_count(pool, active)
        return [lambda: Column(pool.result(h), no_nulls, T.BIGINT)]
    if name == "count_distinct":
        # the first live row of each (group, value) pair
        pairs = Batch((Column(pool.ids, torch.zeros_like(live), T.INTEGER),
                       col), live)
        h = _seg_count(pool, mark_distinct(pairs, [0, 1]))
        return [lambda: Column(pool.result(h), no_nulls, T.BIGINT)]
    if name not in ("count", "sum", "avg", "min", "max"):
        raise NotImplementedError(_unported(spec))
    hn = _seg_count(pool, live)

    def count() -> Block:
        return Column(pool.result(hn), no_nulls, T.BIGINT)

    if name == "count":
        return [count]
    if name in ("min", "max"):
        return [lambda: _extreme(spec, col, pool.ids.to(torch.int64), live,
                                 g, pool.result(hn) == 0)]
    sum_ty = spec.output_type if name == "sum" else _sum_type(col.type)
    if isinstance(col, Int128Column) or col.type.is_decimal:
        hs = _sum128(pool, col, live)

        def total() -> Block:
            hi, lo = combine_limb_totals_128(
                torch.stack([pool.result(h) for h in hs], dim=-1))
            return Int128Column(hi, lo, pool.result(hn) == 0, sum_ty)
    elif col.type.is_integral:
        v = col.values
        h = _seg_add(pool, v, live, _lane_bits(v))

        def total() -> Block:
            return Column(pool.result(h), pool.result(hn) == 0, sum_ty)
    else:
        raise NotImplementedError(
            f"{spec.name} over {col.type} is not ported yet (ROADMAP queue 1 "
            "item 9: breadth)")
    return [total] if name == "sum" else [total, count]


def _unported(spec: AggSpec) -> str:
    item = {"approx_distinct": "8", "approx_percentile": "8"}.get(
        spec.name, "9: breadth")
    return (f"aggregate {spec.name} is not ported yet (ROADMAP queue 1 "
            f"item {item})")


def _ident(dt: torch.dtype, minimize: bool):
    """The identity of min (the dtype's largest value) or of max."""
    if dt.is_floating_point:
        return float("inf") if minimize else float("-inf")
    info = torch.iinfo(dt)
    return info.max if minimize else info.min


def _seg_extreme(ids: torch.Tensor, values: torch.Tensor,
                 live: torch.Tensor, g: int, minimize: bool) -> torch.Tensor:
    """Per-group min (or max) of the live values; the identity where a
    group has none. `ids` are int64 in [0, g)."""
    ident = _ident(values.dtype, minimize)
    contrib = torch.where(live, values, ident)
    return torch.full((g,), ident, dtype=values.dtype,
                      device=values.device).scatter_reduce(
        0, ids, contrib, "amin" if minimize else "amax")


def _argbest(words: Sequence[torch.Tensor], ids: torch.Tensor,
             live: torch.Tensor, g: int, minimize: bool) -> torch.Tensor:
    """Row of the min (or max) word tuple per group, words compared as
    signed int64 from the first; ties go to the lowest row. n where a
    group has no live row."""
    n = live.shape[0]
    remaining = live
    for w in words:
        best = _seg_extreme(ids, w, remaining, g, minimize)
        remaining = remaining & (w == best[ids])
    rows = torch.arange(n, dtype=torch.int64, device=live.device)
    return _seg_extreme(ids, rows, remaining, g, True).clamp(max=n)


def _extreme(spec: AggSpec, col: Block, ids: torch.Tensor,
             live: torch.Tensor, g: int, nulls: torch.Tensor) -> Block:
    """min/max state of one group table, NULL where `nulls` (no live
    input): the reference's _seg_min/_seg_max for fixed-width lanes, its
    _argbest over (hi, lo) for long decimals and over the packed key
    words for strings (_minmax_string)."""
    minimize = spec.name == "min"
    if isinstance(col, Column):
        if col.values.dtype == torch.bool:
            raise NotImplementedError(
                f"{spec.name} over {col.type} is not ported yet (ROADMAP "
                "queue 1 item 9: breadth)")
        return Column(_seg_extreme(ids, col.values, live, g, minimize),
                      nulls, spec.output_type)
    if isinstance(col, Int128Column):
        words = [col.hi, col.lo ^ SIGN]  # lo compares as unsigned
    else:
        words = [w ^ SIGN for w in string_words(col)]
    n = live.shape[0]
    idx = _argbest(words, ids, live, g, minimize).clamp(max=max(n - 1, 0))
    return dataclasses.replace(gather_block(col, idx), nulls=nulls,
                               type=spec.output_type)


def group_by(batch: Batch, key_channels: Sequence[int],
             aggs: Sequence[AggSpec], max_groups: int,
             limb_form: str = "narrow") -> GroupByResult:
    """Grouped aggregation over one batch -> dense group table. A global
    aggregation (no keys) always yields exactly one group, even over
    zero input rows."""
    if not key_channels:
        max_groups = 1
    elif max_groups > SMALL_G:
        for spec in aggs:
            if spec.name not in _SORTED_AGGS:
                raise NotImplementedError(_unported(spec))
        return _group_by_sorted(batch, key_channels, aggs, max_groups)
    keys = [batch.column(c) for c in key_channels]
    ids, perm_first, num_groups, overflow = _group_ids(keys, batch.active,
                                                       max_groups)
    if not key_channels:
        num_groups = torch.clamp(num_groups, min=1)
    slot = torch.arange(max_groups, device=batch.active.device)
    slot_active = slot < torch.clamp(num_groups, max=max_groups)
    out_cols: List[Block] = [gather_block(k, perm_first, slot_active)
                             for k in keys]
    pool = _SegSumPool(ids, max_groups, limb_form)
    builders = []
    lives = {}
    for spec in aggs:
        col, live = None, None
        if spec.input_channel is not None:
            col = batch.column(spec.input_channel)
            if spec.input_channel not in lives:
                lives[spec.input_channel] = batch.active & ~col.nulls
            live = lives[spec.input_channel]
        builders.extend(_acc_columns(spec, col, batch.active, live, pool))
    pool.compute()
    out_cols.extend(build() for build in builders)
    return GroupByResult(Batch(tuple(out_cols), slot_active), num_groups,
                         overflow)


# ---------------------------------------------------------------------------
# Sorted-mode group-by: the large-table path (max_groups > SMALL_G)
# ---------------------------------------------------------------------------

# the reference's sorted mode also takes approx_percentile and the
# moments; the port's takes min/max over long decimals and strings too,
# which the reference sends to its hash path
_SORTED_AGGS = ("count_star", "count", "sum", "avg", "min", "max",
                "count_distinct")


def _padded_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.pad(torch.cumsum(x, dim=0), (1, 0))


def _seg_total(x: torch.Tensor, start: torch.Tensor, end: torch.Tensor):
    """Per-segment totals of x (sorted order) over [start, end) ranges."""
    p = _padded_cumsum(x)
    return p[end] - p[start]


def _sorted_states(spec: AggSpec, scol: Optional[Block], live: torch.Tensor,
                   start: torch.Tensor, end: torch.Tensor,
                   seg_ids: torch.Tensor, pair_first: torch.Tensor,
                   max_groups: int) -> List[Block]:
    """Sorted-order accumulator states for one aggregate, in the state
    layout of `_acc_columns` (avg: sum then count). `seg_ids` is each
    sorted row's group slot; `pair_first` flags the sorted rows that
    start a (key, count_distinct value) pair."""
    zeros_g = torch.zeros(max_groups, dtype=torch.bool, device=live.device)
    if spec.name == "count_star":
        return [Column(end - start, zeros_g, T.BIGINT)]
    if spec.name == "count_distinct":
        return [Column(_seg_total((live & pair_first).to(torch.int64),
                                  start, end), zeros_g, T.BIGINT)]
    nn = _seg_total(live.to(torch.int64), start, end)
    no_input = nn == 0
    if spec.name == "count":
        return [Column(nn, zeros_g, T.BIGINT)]
    if spec.name in ("min", "max"):
        return [_extreme(spec, scol, seg_ids, live, max_groups, no_input)]
    sum_ty = spec.output_type if spec.name == "sum" else _sum_type(scol.type)
    if isinstance(scol, Int128Column) or scol.type.is_decimal:
        if isinstance(scol, Int128Column):
            limbs = limbs13_of_128(scol.hi, scol.lo)
        else:
            limbs = limbs13_of_i64(scol.values, _nlimbs13(scol.values))
        totals = [_seg_total(torch.where(live, l, 0), start, end)
                  for l in limbs]
        hi, lo = combine_limb_totals_128(torch.stack(totals, dim=-1))
        total: Block = Int128Column(hi, lo, no_input, sum_ty)
    elif scol.type.is_integral:
        # 13-bit limb cumsums keep every intermediate exact
        v = scol.values
        tot = torch.zeros(max_groups, dtype=torch.int64, device=live.device)
        for li, l in enumerate(limbs13_of_i64(v, _nlimbs13(v))):
            tot = tot + (_seg_total(torch.where(live, l, 0), start, end)
                         << (13 * li))
        total = Column(tot, no_input, sum_ty)
    else:
        raise NotImplementedError(
            f"{spec.name} over {scol.type} is not ported yet (ROADMAP queue "
            "1 item 9: breadth)")
    if spec.name == "avg":
        return [total, Column(nn, zeros_g, T.BIGINT)]
    return [total]


def _group_by_sorted(batch: Batch, key_channels: Sequence[int],
                     aggs: Sequence[AggSpec], max_groups: int
                     ) -> GroupByResult:
    """Sorted-mode group_by: ONE stable sort of (inactive flag, key
    words, the count_distinct column's words), segment ids by
    adjacent-word inequality, [start, end) row ranges per group slot by
    searchsorted over the segment ids, and every accumulator a
    segmented reduction in sorted order. The output table gathers keys
    from each segment's first row. One column only can follow the keys
    in the sort, so every count_distinct must count the same column."""
    n = batch.capacity
    dev = batch.active.device
    keys = [batch.column(c) for c in key_channels]
    words = key_words(keys)
    distinct_chans = {s.input_channel for s in aggs
                      if s.name == "count_distinct"}
    if len(distinct_chans) > 1:
        raise NotImplementedError(
            "count_distinct over more than one column in one aggregation "
            "is not ported yet (ROADMAP queue 1 item 8: the hash-slot "
            "group-by)")
    pair_words = [] if not distinct_chans else key_words(
        [batch.column(distinct_chans.pop())], nulls_last=True)
    perm = lex_permutation([(~batch.active).to(torch.int64),
                            *(w ^ SIGN for w in words + pair_words)])
    s_active = batch.active[perm]

    diffs = torch.zeros(n, dtype=torch.bool, device=dev)
    for w in words:
        sw = w[perm]
        diffs[1:] |= sw[1:] != sw[:-1]
    seg = torch.cumsum(diffs.to(torch.int64), dim=0)
    pair_first = diffs.clone()
    pair_first[:1] = True
    for w in pair_words:
        sw = w[perm]
        pair_first[1:] |= sw[1:] != sw[:-1]

    n_act = s_active.sum()
    num_groups = torch.where(n_act > 0,
                             seg[(n_act - 1).clamp(0, max(n - 1, 0))] + 1, 0)
    overflow = num_groups > max_groups

    # per-slot [start, end) ranges; inactive rows get a sentinel segment
    seg_search = torch.where(s_active, seg, (1 << 63) - 1)
    gids = torch.arange(max_groups, dtype=torch.int64, device=dev)
    start = torch.searchsorted(seg_search, gids)
    end = torch.searchsorted(seg_search, gids, right=True)
    slot_active = gids < torch.clamp(num_groups, max=max_groups)

    seg_ids = seg.clamp(max=max_groups - 1)
    perm_first = perm[start.clamp(0, max(n - 1, 0))]
    out_cols: List[Block] = [gather_block(k, perm_first, slot_active)
                             for k in keys]
    sorted_cols = {}
    for spec in aggs:
        if spec.input_channel is None:
            scol, live = None, s_active
        else:
            ch = spec.input_channel
            if ch not in sorted_cols:
                sorted_cols[ch] = gather_block(batch.column(ch), perm)
            scol = sorted_cols[ch]
            live = s_active & ~scol.nulls
        out_cols.extend(_sorted_states(spec, scol, live, start, end,
                                       seg_ids, pair_first, max_groups))
    return GroupByResult(Batch(tuple(out_cols), slot_active),
                         num_groups.to(torch.int32), overflow)


def state_width(spec: AggSpec) -> int:
    return 2 if spec.name == "avg" else 1


def finalize_states(table: Batch, num_keys: int, aggs: Sequence[AggSpec]
                    ) -> Batch:
    """State table (keys..., states...) -> one column per aggregate:
    avg divides sum by count with the registered decimal `divide`
    (exact, half away from zero); the other states pass through."""
    cols: List[Block] = list(table.columns[:num_keys])
    ch = num_keys
    for spec in aggs:
        w = state_width(spec)
        states = table.columns[ch:ch + w]
        ch += w
        if spec.name == "avg":
            cols.append(lookup("divide").fn(spec.output_type, states[0],
                                            states[1]))
        else:
            cols.append(states[0])
    return Batch(tuple(cols), table.active)
