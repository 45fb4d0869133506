"""Grouped aggregation: the HashAggregationOperator analog.

Counterpart of presto_tpu/ops/aggregation.py: every aggregate of its
`_AGGS`, its three group-id paths, its partial/final split
(`merge_partials`) and its finalizers. `group_by` dispatches as the
reference does: a keyless aggregation takes one slot; a table of at
most 64 groups the small-table path; a larger table the sorted path
when `_sorted_capable` allows, else the hash-slot path.

Small tables (max_groups <= 64, the TPC-H q1 shape) have no hash table
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

The hash-slot path (`_group_ids_hash`) hashes the key words with
splitmix64 into a table of m >= 2 * max_groups slots; in each round the
unresolved rows claim their probe slot by a scatter-min of the row id,
and a row whose slot owner has equal key words resolves there
(triangular probing, at most 64 rounds). Dense ids are slot order, so
the output table has the reference's group order. Its integer sums are
the pool's requests summed by `index_add_` in int64 (exact: wrapping
adds commute), doubles by `index_add_` in float64.

The sorted path (`_group_by_sorted`) is scatter-free for its sums: one
sort of the key words, segment boundaries by adjacent-word inequality,
per-group [start, end) ranges by searchsorted, and every sum as
differences of a padded cumsum, over 13-bit limbs for integers (exact
in int64).

min and max are per-group extremes in every path (`_seg_reduce`,
`_argbest`): a scatter_reduce over the group ids (the segment ids in
sorted order) with dead rows at the identity. Long decimals and
strings take the extreme row word by word (for Int128 lanes the signed
`hi`, then `lo` as unsigned), and gather its value; min_by/max_by take
the row of the extreme order value the same way.

count_distinct counts the distinct non-null values per group. In the
sorted path it rides the one sort: the value's words follow the key
words (nulls last), and a row that starts a new (key, value) pair
counts. In the other paths it marks the first row of each (group id,
value) pair with ops/misc.mark_distinct and counts the marks per group.

approx_distinct keeps HyperLogLog registers (p = 11, 2048 int8 a
group, an `array(tinyint)` ArrayColumn): a register per the top 11
bits of the value's hash, holding the largest rank (leading zeros of
the remaining bits, plus one); registers merge by elementwise max.

Limb forms (an argument, not a knob): "narrow" (the default) takes the
fused kernel; "wide" keeps the unfused path of the TPU kernel's
contract: requests materialise into 13-bit limbs stacked as an (n, L)
float32 matrix that the per-tile limb_partial_sums kernel sums.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import types as T
from ..block import (ArrayColumn, Batch, Block, Column, Int128Column,
                     StringColumn, decoded, gather_block)
from ..expr.functions import GOLD, decimal_to_f64, hash64_block, lookup, mix64
from ..int128 import (_lshr, combine_limb_totals_128, limbs13_of_128,
                      limbs13_of_i64, limbs_of_i64)
from . import kernels as K
from .keys import SIGN, key_words, string_words
from .misc import mark_distinct
from .sort import lex_permutation

__all__ = ["AggSpec", "GroupByResult", "group_by", "merge_partials",
           "finalize_states", "state_width", "state_types", "merge_spec",
           "hll_estimate",
           "hll_state_type", "HASH_STATS", "SMALL_G", "LIMB_FORMS"]

SMALL_G = 64  # the largest group table of the small-table path
LIMB_FORMS = ("narrow", "wide")

_AGGS = ("sum", "count", "count_star", "min", "max", "avg",
         "var_samp", "var_pop", "stddev_samp", "stddev_pop", "stddev",
         "variance", "bool_and", "bool_or", "every", "min_by", "max_by",
         "count_distinct", "approx_distinct", "arbitrary", "any_value",
         "approx_percentile", "corr", "covar_samp", "covar_pop",
         "regr_slope", "regr_intercept", "geometric_mean", "checksum")
# two-input statistics over (y, x) pairs: six float64 moments
_PAIR_MOMENT_AGGS = ("corr", "covar_samp", "covar_pop", "regr_slope",
                     "regr_intercept")
_VARIANCE_AGGS = ("var_samp", "var_pop", "stddev_samp", "stddev_pop")
_ALIAS = {"stddev": "stddev_samp", "variance": "var_samp",
          "every": "bool_and", "any_value": "arbitrary"}
# aggregates whose value column joins the sorted path's one sort
_VALUE_ORDER_AGGS = ("count_distinct", "approx_percentile")

# HyperLogLog: 2^11 int8 registers a group
_HLL_P = 11
_HLL_M = 1 << _HLL_P

_MAX_PROBES = 64  # the hash path's probe budget; exhaustion overflows
_HASH_CHECK_EVERY = 4  # rounds between host reads of the exit flag
# the last hash-path call's probe rounds and host reads of its exit flag
HASH_STATS: Dict[str, int] = {"rounds": 0, "exit_checks": 0}


def hll_state_type() -> T.Type:
    return T.array_of(T.TINYINT)


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One aggregate: `name(input_channel)` -> a column of `output_type`.
    input_channel is None for count(*); min_by/max_by order by, and the
    pair moments take x from, `second_channel`; `parameter` is
    approx_percentile's fraction; `mask_channel` a BOOLEAN column that
    restricts the rows this aggregate consumes (NULL excludes). The
    reference's plan JSON carries neither `parameter` nor
    `mask_channel`; the port's writes both where set."""
    name: str
    input_channel: Optional[int]
    output_type: T.Type
    second_channel: Optional[int] = None
    second_type: Optional[T.Type] = None
    parameter: Optional[float] = None
    mask_channel: Optional[int] = None

    @property
    def canonical(self) -> str:
        return _ALIAS.get(self.name, self.name)


@dataclasses.dataclass
class GroupByResult:
    """Dense group table: one row per group (keys, then aggregate
    states), active for slots < num_groups. `overflow` is True when the
    distinct keys exceeded max_groups; the caller reruns bigger."""
    batch: Batch
    num_groups: torch.Tensor
    overflow: torch.Tensor


# ---------------------------------------------------------------------------
# group ids
# ---------------------------------------------------------------------------

def _group_ids(key_cols: Sequence[Block], active: torch.Tensor,
               max_groups: int):
    """(ids, perm_first, num_groups, overflow); perm_first[g] is a row
    of group g, used to gather the key values. Keyless: one group;
    max_groups <= SMALL_G: first-occurrence extraction; else the
    hash-slot table."""
    n = active.shape[0]
    words = key_words(key_cols)
    dev = active.device
    if not words:  # global aggregation: every row is group 0
        return (torch.zeros(n, dtype=torch.int32, device=dev),
                torch.zeros(max_groups, dtype=torch.int64, device=dev),
                active.any().to(torch.int32),
                torch.zeros((), dtype=torch.bool, device=dev))
    if max_groups <= SMALL_G:
        return _group_ids_small(words, active, max_groups)
    return _group_ids_hash(words, active, max_groups)


def _group_ids_small(words, active: torch.Tensor, max_groups: int):
    """First-occurrence extraction. The reference's while-loop exits
    once every active row is resolved, which needs a host read of a
    device flag per round; here all max_groups rounds run with no host
    sync, a round with nothing left to resolve changing nothing.
    Active rows still unresolved after the last round mean more than
    max_groups distinct keys: overflow (they park in the last slot)."""
    n = active.shape[0]
    dev = active.device
    ids = torch.full((n,), -1, dtype=torch.int32, device=dev)
    firsts = []
    num_groups = torch.zeros((), dtype=torch.int32, device=dev)
    for g in range(max_groups):
        unres = active & (ids < 0)
        # the first unresolved row (argmax takes the first maximum),
        # found where there is one; over bytes, so that no row-wide
        # int64 lane is made (one per member under a batch)
        found = unres.any()
        i = torch.argmax(unres.to(torch.uint8)) if n else \
            torch.zeros((), dtype=torch.int64, device=dev)
        i_safe = torch.where(found, i, 0).reshape(1)
        match = unres
        for w in words:
            match = match & (w == w.index_select(0, i_safe))
        ids = ids.masked_fill(match, g)
        firsts.append(i_safe[0])
        num_groups = num_groups + found.to(torch.int32)
    first = torch.stack(firsts)
    overflow = (active & (ids < 0)).any()
    ids = torch.where(active & (ids >= 0), ids, max_groups - 1)
    return ids, first, num_groups, overflow


def _batched(t: torch.Tensor) -> bool:
    """Whether `t` carries a member axis of torch.func.vmap: a value
    the host cannot read, one for every member."""
    return torch._C._functorch.is_batchedtensor(t)


def _hash_words(words: Sequence[torch.Tensor]) -> torch.Tensor:
    """splitmix64 over the key words, as int64 bit patterns."""
    # W001: a 64-bit hash word is the hash table's contract
    h = torch.full(words[0].shape, GOLD, dtype=torch.int64,  # tpulint: disable=W001
                   device=words[0].device)
    for w in words:
        h = mix64(h ^ w)
    return h


def _group_ids_hash(words, active: torch.Tensor, max_groups: int):
    """The hash-slot table: m slots (a power of two, >= 2 * max_groups,
    >= 1024); each round the unresolved rows probe slot (h + r(r+1)/2)
    mod m, claim it by a scatter-min of their row if it is empty, and
    resolve there if its owner's key words equal theirs. The
    reference's loop exits when every active row is resolved; a round
    after that changes nothing, so here the exit flag is read on the
    host only every _HASH_CHECK_EVERY rounds, and not at all where the
    flag is a batched value (a member axis of exec/batching.py's
    torch.func.vmap): then every round runs, as _group_ids_small runs
    all of its rounds. Occupied slots take dense
    ids in slot order; rows left after _MAX_PROBES rounds, or more
    occupied slots than max_groups, overflow (such rows park in the
    last slot)."""
    n = active.shape[0]
    dev = active.device
    m = max(1024, 1 << int(max(2 * max_groups - 1, 1)).bit_length())
    h = _hash_words(words)
    # W001: row positions, slot owners and group slots are int64
    # index lanes: torch's gather, scatter and indexing take them
    rows = torch.arange(n, dtype=torch.int64, device=dev)  # tpulint: disable=W001
    rep = torch.full((m,), n, dtype=torch.int64, device=dev)  # tpulint: disable=W001
    slot_of = torch.full((n,), -1, dtype=torch.int64, device=dev)  # tpulint: disable=W001
    rounds = checks = 0
    for r in range(_MAX_PROBES):
        unres = active & (slot_of < 0)
        if r % _HASH_CHECK_EVERY == 0 and r and not _batched(unres):
            checks += 1
            if not bool(unres.any()):
                break
        slot = (h + r * (r + 1) // 2) & (m - 1)
        occupied = rep[slot] < n
        claim = torch.where(unres & ~occupied, rows, n)
        rep = rep.scatter_reduce(0, slot, claim, "amin")
        owner = rep[slot]
        match = unres & (owner < n)
        own = owner.clamp(0, max(n - 1, 0))
        for w in words:
            match = match & (w == w[own])
        slot_of = torch.where(match, slot, slot_of)
        rounds += 1
    HASH_STATS.update(rounds=rounds, exit_checks=checks)

    occupied = rep < n
    num_groups = occupied.sum().to(torch.int32)
    dense = torch.cumsum(occupied.to(torch.int64), dim=0) - 1  # tpulint: disable=W001
    resolved = active & (slot_of >= 0)
    overflow = (num_groups > max_groups) | (active & ~resolved).any()
    gid = dense[slot_of.clamp(0, m - 1)].clamp(0, max_groups - 1)
    ids = torch.where(resolved, gid, max_groups - 1)
    slot_gid = torch.where(occupied, dense.clamp(0, max_groups - 1),
                           max_groups - 1)
    perm_first = torch.zeros(max_groups, dtype=torch.int64,  # tpulint: disable=W001
                             device=dev).scatter_reduce(
        0, slot_gid, torch.where(occupied, rep.clamp(0, max(n - 1, 0)), 0),
        "amax")
    return ids, perm_first, num_groups, overflow


# ---------------------------------------------------------------------------
# the integer sum pool
# ---------------------------------------------------------------------------

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


def _batched_request(r: _Request) -> bool:
    lanes = list(r.source) if isinstance(r.source, tuple) else [r.source]
    return any(map(_batched, lanes + ([] if r.mask is None else [r.mask])))


def _as_request(r) -> _Request:
    """A descriptor, or a plain (contrib, value_bits) whole-lane request."""
    if isinstance(r, _Request):
        return r
    contrib, value_bits = r
    return _Request(contrib, None, 0, int(value_bits), True)


def _source_key(src) -> tuple:
    return tuple(map(id, src)) if isinstance(src, tuple) else (id(src),)


def _fused_chunks(reqs: List[_Request]) -> List[List[_Request]]:
    """The requests in order, cut where one fused_limb_sums launch would
    take more sources, requests, limbs or shared memory than the kernel
    holds (K.fused_fits): q1's 39 requests over 11 sources are one
    launch, a projection of many distinct lanes (the function
    statements' aggregates) takes more."""
    chunks: List[List[_Request]] = []
    srcs: dict = {}  # the last chunk's sources: key -> bytes a row
    for r in reqs:
        need = {_source_key(s): K.source_bytes(s) for s in
                (r.source,) + (() if r.mask is None else (r.mask,))}
        both = {**srcs, **need}
        if not chunks or not K.fused_fits(
                len(both), sum(both.values()), len(chunks[-1]) + 1,
                sum(K.limb_count(q.bits) for q in chunks[-1] + [r])):
            chunks.append([])
            both = need
        chunks[-1].append(r)
        srcs = both
    return chunks


def _fused_limb_sums(ids: torch.Tensor, requests, max_groups: int,
                     limb_form: str = "narrow") -> List[torch.Tensor]:
    """Every integer seg-sum of `requests` (descriptors, or plain
    (contrib, value_bits) pairs) -> list of (G,) exact int64 totals.
    Narrow: one fused_limb_sums launch over the distinct source lanes
    (each tensor passed once) per chunk of requests that fits the kernel
    (`_fused_chunks`; q1's is one), the limb split inside the kernel. Wide:
    the requests materialise into float32 13-bit limbs stacked into an
    (n, L) matrix, ONE limb_partial_sums launch sums them per tile, the
    tiles add in int64 and the limbs recombine by shifts."""
    if limb_form not in LIMB_FORMS:
        raise ValueError(f"limb_form must be one of {LIMB_FORMS}")
    reqs = [_as_request(r) for r in requests]
    ids = ids.to(torch.int32)
    if limb_form == "narrow":
        out: List[torch.Tensor] = []
        for chunk in _fused_chunks(reqs):
            sources: List[K.Source] = []
            slots = {}

            def slot(src) -> int:
                key = _source_key(src)
                if key not in slots:
                    slots[key] = len(sources)
                    sources.append(src)
                return slots[key]

            kreqs = [K.LimbRequest(slot(r.source),
                                   -1 if r.mask is None else slot(r.mask),
                                   r.shift, r.bits, r.remainder)
                     for r in chunk]
            out += K.fused_limb_sums_op(ids, sources, kreqs,
                                        max_groups).unbind(-1)
        return out
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
    # W001: exact limb sums accumulate in int64, (G, L)
    tot = part.to(torch.int64).sum(dim=0)  # tpulint: disable=W001
    # limb weights 2^(13 k), made on the device (no host copy)
    shifts = limb_bits * torch.arange(max(nl for _, nl in spans),
                                      dtype=torch.int64, device=tot.device)  # tpulint: disable=W001
    weights = torch.ones_like(shifts) << shifts
    return [(tot[:, start:start + nl] * weights[:nl]).sum(dim=1)
            for start, nl in spans]


class _SegSumPool:
    """Batches every integer per-group sum of one group_by call. `add`
    queues a descriptor and returns its handle; `compute` runs them all
    (a plain reduction per request for the single group of a global
    aggregation, or the fused kernel where its lanes carry a member
    axis; one fused kernel launch for 1 < G <= SMALL_G; an int64
    `index_add` per request for the hash path's larger tables);
    `result` then reads a handle's (G,) int64 totals."""

    def __init__(self, ids: torch.Tensor, max_groups: int, limb_form: str):
        self.ids = ids
        self._ids64: Optional[torch.Tensor] = None
        self.g = max_groups
        self.limb_form = limb_form
        self.requests: List[_Request] = []
        self.results: Optional[List[torch.Tensor]] = None

    def add(self, request: _Request) -> int:
        self.requests.append(request)
        return len(self.requests) - 1

    def compute(self) -> None:
        if self.g == 1 and any(map(_batched_request, self.requests)):
            # a keyless sum over rows that carry a member axis: the
            # plain reduction would materialise a [B, n] int64 field per
            # request, so the batched kernel sums them (G = 1, the
            # shared value lanes read in place, a mask lane per member)
            self.results = _fused_limb_sums(self.ids, self.requests, 1)
        elif self.g == 1:
            self.results = [r.materialize().sum().reshape(1)
                            for r in self.requests]
        elif not self.requests:
            self.results = []
        elif self.g <= SMALL_G:
            self.results = _fused_limb_sums(self.ids, self.requests, self.g,
                                            self.limb_form)
        else:
            self.results = [torch.zeros(
                self.g, dtype=torch.int64, device=self.ids.device
            ).index_add(0, self.ids64, r.materialize())
                for r in self.requests]
        self.requests = []

    def result(self, handle: int) -> torch.Tensor:
        return self.results[handle]

    @property
    def ids64(self) -> torch.Tensor:
        """The ids as int64 (index_add's index), made once where a sum
        needs them: the fused kernel reads the int32 ids."""
        if self._ids64 is None:
            self._ids64 = self.ids.to(torch.int64)
        return self._ids64

    def fsum(self, values: torch.Tensor, live: torch.Tensor
             ) -> torch.Tensor:
        """Per-group float64 sum of the live values (not pooled)."""
        contrib = torch.where(live, values.to(torch.float64), 0.0)
        if self.g == 1:
            return contrib.sum().reshape(1)
        return torch.zeros(self.g, dtype=torch.float64,
                           device=contrib.device).index_add(
            0, self.ids64, contrib)


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
    if in_ty.is_decimal:
        return T.decimal(38, in_ty.scale)
    if in_ty.is_floating:
        return T.DOUBLE
    return T.BIGINT


# ---------------------------------------------------------------------------
# per-group extremes
# ---------------------------------------------------------------------------

def _ident(dt: torch.dtype, minimize: bool):
    """The identity of min (the dtype's largest value) or of max."""
    if dt.is_floating_point:
        return float("inf") if minimize else float("-inf")
    info = torch.iinfo(dt)
    return info.max if minimize else info.min


def _seg_reduce(ids: torch.Tensor, contrib: torch.Tensor, g: int, ident,
                minimize: bool) -> torch.Tensor:
    """Per-group min (or max) of `contrib` (dead rows already at
    `ident`); `ident` where a group has no row. `ids` are int64."""
    return torch.full((g,), ident, dtype=contrib.dtype,
                      device=contrib.device).scatter_reduce(
        0, ids, contrib, "amin" if minimize else "amax")


def _seg_extreme(ids: torch.Tensor, values: torch.Tensor,
                 live: torch.Tensor, g: int, minimize: bool) -> torch.Tensor:
    """Per-group min (or max) of the live values; the identity where a
    group has none."""
    ident = _ident(values.dtype, minimize)
    return _seg_reduce(ids, torch.where(live, values, ident), g, ident,
                       minimize)


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
    input): a scatter_reduce for fixed-width lanes, the extreme row by
    `_argbest` over (hi, lo) for long decimals and over the packed key
    words for strings."""
    minimize = spec.canonical == "min"
    if isinstance(col, Column):
        if col.values.dtype == torch.bool:
            raise NotImplementedError(
                f"{spec.name} over {col.type}: the reference refuses it "
                "too")
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


# ---------------------------------------------------------------------------
# HyperLogLog
# ---------------------------------------------------------------------------

def _clz64(w: torch.Tensor) -> torch.Tensor:
    """Leading zeros of nonzero 64-bit patterns, by an exact
    shift-and-compare search (a float log2 rounds near powers of two
    above 2^53)."""
    n = torch.zeros_like(w)
    for s in (32, 16, 8, 4, 2, 1):
        top_zero = _lshr(w, 64 - s) == 0
        # W001: a count over 64-bit words, at the words' width
        n = n + top_zero.to(torch.int64) * s  # tpulint: disable=W001
        w = torch.where(top_zero, w << s, w)
    return n


def _hll_registers_from_values(col: Block, live: torch.Tensor,
                               ids: torch.Tensor, g: int) -> torch.Tensor:
    """(g, 2048) int8 registers: per group and register (the top 11
    bits of the value words' hash), the largest rank (leading zeros of
    the other 53 bits, plus one) of the live rows."""
    h = _hash_words(key_words([col])[1:])  # value words; nulls not live
    reg = _lshr(h, 64 - _HLL_P)
    w = h << _HLL_P
    rank = torch.where(w == 0, 64 - _HLL_P + 1, _clz64(w) + 1)
    # W001: register slots are int64 index lanes (scatter positions)
    flat = torch.where(live, ids.to(torch.int64) * _HLL_M + reg, g * _HLL_M)  # tpulint: disable=W001
    regs = torch.zeros(g * _HLL_M + 1, dtype=torch.int32,
                       device=h.device).scatter_reduce(
        0, flat, torch.where(live, rank, 0).to(torch.int32), "amax")
    return regs[:g * _HLL_M].reshape(g, _HLL_M).to(torch.int8)


def _hll_registers_merge(col: ArrayColumn, live: torch.Tensor,
                         ids: torch.Tensor, g: int) -> torch.Tensor:
    """The union of partial register vectors per group: elementwise
    max, exact over any number of merges."""
    if not isinstance(col, ArrayColumn):
        raise TypeError(f"hll_merge reads register arrays, not {col.type}")
    contrib = torch.where(live[:, None], col.elements.to(torch.int32), 0)
    # W001: group slots are int64 index lanes (scatter positions)
    safe = torch.where(live, ids.to(torch.int64), g)  # tpulint: disable=W001
    regs = torch.zeros((g + 1, _HLL_M), dtype=torch.int32,
                       device=contrib.device).scatter_reduce(
        0, safe[:, None].expand(-1, _HLL_M), contrib, "amax")
    return regs[:g].to(torch.int8)


def _hll_state_column(regs: torch.Tensor) -> ArrayColumn:
    g = regs.shape[0]
    dev = regs.device
    return ArrayColumn(regs, torch.zeros_like(regs, dtype=torch.bool),
                       torch.full((g,), _HLL_M, dtype=torch.int32,
                                  device=dev),
                       torch.zeros(g, dtype=torch.bool, device=dev),
                       hll_state_type())


def hll_estimate(regs: torch.Tensor) -> torch.Tensor:
    """Registers (g, m) -> int64 estimates: the HLL estimator, linear
    counting in the small range."""
    m = float(_HLL_M)
    # W001: the estimator's double arithmetic, a BIGINT result
    z = torch.exp2(-regs.to(torch.float64)).sum(dim=1)  # tpulint: disable=W001
    alpha = 0.7213 / (1 + 1.079 / m)
    e = alpha * m * m / z
    v = (regs == 0).sum(dim=1)
    lin = m * torch.log(m / v.clamp(min=1).to(torch.float64))  # tpulint: disable=W001
    est = torch.where((e <= 2.5 * m) & (v > 0), lin, e)
    return torch.round(est).to(torch.int64)  # tpulint: disable=W001


# ---------------------------------------------------------------------------
# accumulator states: small-table, keyless and hash paths
# ---------------------------------------------------------------------------

StateBuilder = Callable[[], Block]


def _masked_active(batch: Batch, spec: AggSpec) -> torch.Tensor:
    """Rows this aggregate consumes: the active rows, restricted by the
    spec's BOOLEAN mask column (NULL excludes)."""
    if spec.mask_channel is None:
        return batch.active
    mc = batch.column(spec.mask_channel)
    return batch.active & mc.values.to(torch.bool) & ~mc.nulls


def _acc_columns(spec: AggSpec, col: Optional[Block], active: torch.Tensor,
                 live: Optional[torch.Tensor], pool: _SegSumPool,
                 batch: Batch) -> List[StateBuilder]:
    """Queue one aggregate's sums and return a builder per state column
    (avg has two: sum and count), called after pool.compute(). `active`
    is the rows the aggregate consumes, `live` its active non-null rows
    (one tensor per (input, mask) pair, so that the pool passes it to
    the kernel once)."""
    g = pool.g
    dev = active.device
    no_nulls = torch.zeros(g, dtype=torch.bool, device=dev)
    name = spec.canonical
    if name == "count_star":
        h = _seg_count(pool, active)
        return [lambda: Column(pool.result(h), no_nulls, T.BIGINT)]
    hn = _seg_count(pool, live)

    def nn() -> torch.Tensor:
        return pool.result(hn)

    def count() -> Block:
        return Column(nn(), no_nulls, T.BIGINT)

    if name == "count":
        return [count]
    if name == "count_distinct":
        # the first live row of each (group, value) pair
        pairs = Batch((Column(pool.ids, torch.zeros_like(live), T.INTEGER),
                       col), live)
        h = _seg_count(pool, mark_distinct(pairs, [0, 1]))
        return [lambda: Column(pool.result(h), no_nulls, T.BIGINT)]
    if name == "approx_distinct":
        regs = _hll_registers_from_values(col, live, pool.ids64, g)
        return [lambda: _hll_state_column(regs)]
    if name == "hll_merge":
        regs = _hll_registers_merge(col, live, pool.ids64, g)
        return [lambda: _hll_state_column(regs)]
    if name == "checksum":
        # a wrapping int64 sum of the rows' hashes; a NULL row adds GOLD
        contrib = torch.where(col.nulls & active, GOLD,
                              torch.where(live, hash64_block(col), 0))
        hs = pool.add(_Request(contrib, None, 0, 64, True))
        ha = _seg_count(pool, active)
        return [lambda: Column(pool.result(hs), pool.result(ha) == 0,
                               T.BIGINT)]

    if isinstance(col, StringColumn):
        if name in ("min", "max"):
            return [lambda: _extreme(spec, col, pool.ids64, live, g,
                                     nn() == 0)]
        raise NotImplementedError(f"{spec.name} over strings")
    if isinstance(col, Int128Column) or (name in ("sum", "avg")
                                         and col.type.is_decimal):
        if name in ("sum", "avg"):
            sum_ty = spec.output_type if name == "sum" \
                else _sum_type(col.type)
            hs = _sum128(pool, col, live)

            def total() -> Block:
                hi, lo = combine_limb_totals_128(
                    torch.stack([pool.result(h) for h in hs], dim=-1))
                return Int128Column(hi, lo, nn() == 0, sum_ty)
            return [total] if name == "sum" else [total, count]
        if name in ("min", "max"):
            return [lambda: _extreme(spec, col, pool.ids64, live, g, nn() == 0)]
        raise NotImplementedError(f"{spec.name} over long decimals")

    v = col.values
    if name in ("sum", "avg"):
        sum_ty = spec.output_type if name == "sum" else _sum_type(col.type)
        if v.is_floating_point():
            s = pool.fsum(v, live)

            def total() -> Block:
                return Column(s, nn() == 0, sum_ty)
        else:
            h = _seg_add(pool, v, live, _lane_bits(v))

            def total() -> Block:
                return Column(pool.result(h), nn() == 0, sum_ty)
        return [total] if name == "sum" else [total, count]
    if name in ("min", "max"):
        return [lambda: _extreme(spec, col, pool.ids64, live, g, nn() == 0)]
    if name in ("bool_and", "bool_or"):
        ident = 1 if name == "bool_and" else 0
        m = _seg_reduce(pool.ids64, torch.where(live, v.to(torch.int32), ident), g,
                        ident, name == "bool_and")
        return [lambda: Column(m.to(torch.bool), nn() == 0, T.BOOLEAN)]
    if name in _VARIANCE_AGGS:
        # (count, sum, sum of squares) in float64; finalize_variance
        f = decimal_to_f64(col)
        s, s2 = pool.fsum(f, live), pool.fsum(f * f, live)
        return [count, lambda: Column(s, nn() == 0, T.DOUBLE),
                lambda: Column(s2, nn() == 0, T.DOUBLE)]
    if name in _PAIR_MOMENT_AGGS:
        # six moments over the rows where both y and x are non-null
        xcol = batch.column(spec.second_channel)
        pair_live = active & ~col.nulls & ~xcol.nulls
        y, x = decimal_to_f64(col), decimal_to_f64(xcol)
        hp = _seg_count(pool, pair_live)
        sums = [pool.fsum(t, pair_live) for t in (y, x, y * y, x * x, y * x)]

        def moment(s: torch.Tensor) -> StateBuilder:
            return lambda: Column(s, pool.result(hp) == 0, T.DOUBLE)
        return [lambda: Column(pool.result(hp), no_nulls, T.BIGINT)] + \
            [moment(s) for s in sums]
    if name == "geometric_mean":
        # (count, sum of ln x); a nonpositive input makes its group NaN
        logs = torch.log(torch.where(live, decimal_to_f64(col), 1.0))
        slog = pool.fsum(logs, live)
        return [count, lambda: Column(slog, nn() == 0, T.DOUBLE)]
    if name == "arbitrary":
        n = len(col)
        # W001: row positions, an int64 index lane
        rows = torch.arange(n, dtype=torch.int64, device=dev)  # tpulint: disable=W001
        row = _seg_reduce(pool.ids64, torch.where(live, rows, n), g, n, True)
        idx = row.clamp(max=max(n - 1, 0))
        return [lambda: Column(v[idx], row >= n, spec.output_type)]
    if name in ("min_by", "max_by"):
        return _min_by(spec, col, active, pool.ids64, g, batch)
    if name == "approx_percentile":
        return [_percentile(spec, col, live, pool.ids64, g, nn)]
    raise NotImplementedError(f"aggregate function {spec.name!r}")


def _min_by(spec: AggSpec, col: Column, active: torch.Tensor,
            ids: torch.Tensor, g: int, batch: Batch) -> List[StateBuilder]:
    """min_by/max_by: the value at the row of the extreme order value
    among the rows whose order value is not NULL (a NULL value there is
    the answer); the state keeps that order value too, so that partial
    states merge by min_by/max_by again."""
    order = batch.column(spec.second_channel)
    if not isinstance(order, Column):
        raise NotImplementedError(
            f"{spec.name} ordered by {order.type}: the reference refuses "
            "it too")
    live = active & ~order.nulls
    words = [w ^ SIGN for w in key_words([order])[1:]]
    n = len(col)
    row = _argbest(words, ids, live, g, spec.canonical == "min_by")
    valid = row < n
    idx = row.clamp(max=max(n - 1, 0))
    oty = spec.second_type or order.type
    return [lambda: Column(col.values[idx], ~valid | col.nulls[idx],
                           spec.output_type),
            lambda: Column(order.values[idx], ~valid, oty)]


def _percentile(spec: AggSpec, col: Column, live: torch.Tensor,
                ids: torch.Tensor, g: int, nn) -> StateBuilder:
    """approx_percentile, exact: rows sorted by (group, value), each
    group's answer at start + floor((count - 1) * fraction)."""
    if spec.parameter is None:
        raise ValueError("approx_percentile needs its fraction (parameter)")
    n = len(col)
    dev = live.device
    vwords = key_words([col])[1:]  # dead rows sink by the lead word
    # W001: lex_permutation sorts int64 words; positions and targets
    # are int64 index lanes, the fraction's product a double
    perm = lex_permutation([(~live).to(torch.int64), ids,  # tpulint: disable=W001
                            *(w ^ SIGN for w in vwords)])
    pos = torch.arange(n, dtype=torch.int64, device=dev)  # tpulint: disable=W001
    sorted_ids = torch.where(live[perm], ids[perm], g)
    start = _seg_reduce(sorted_ids.clamp(max=g - 1),
                        torch.where(sorted_ids < g, pos, n), g, n, True)

    def build() -> Block:
        cnt = nn()
        target = start + torch.floor((cnt - 1).to(torch.float64)  # tpulint: disable=W001
                                     * float(spec.parameter)).to(torch.int64)
        rows = perm[target.clamp(0, max(n - 1, 0))]
        return Column(col.values[rows], cnt == 0, spec.output_type)
    return build


# ---------------------------------------------------------------------------
# group_by
# ---------------------------------------------------------------------------

def _sorted_capable(batch: Batch, key_channels: Sequence[int],
                    aggs: Sequence[AggSpec]) -> bool:
    """Whether this aggregation runs in sorted mode, as the reference
    decides: keyed, at most one value-order column, unmasked value-order
    aggregates, and none of min_by/max_by, the pair moments,
    geometric_mean, checksum, or min/max over strings and long
    decimals (those take the hash-slot path)."""
    if not key_channels:
        return False
    if any(s.mask_channel is not None and s.canonical in _VALUE_ORDER_AGGS
           for s in aggs):
        return False
    if len({s.input_channel for s in aggs
            if s.canonical in _VALUE_ORDER_AGGS}) > 1:
        return False
    for s in aggs:
        c = s.canonical
        if c in ("min_by", "max_by", "geometric_mean", "checksum") \
                or c in _PAIR_MOMENT_AGGS:
            return False
        if s.input_channel is None:
            continue
        col = batch.column(s.input_channel)
        if isinstance(col, (StringColumn, Int128Column)) \
                and c in ("min", "max"):
            return False
    return True


def group_by(batch: Batch, key_channels: Sequence[int],
             aggs: Sequence[AggSpec], max_groups: int,
             limb_form: str = "narrow") -> GroupByResult:
    """Grouped aggregation over one batch -> dense group table. A global
    aggregation (no keys) always yields exactly one group, even over
    zero input rows. Dictionary columns decode first."""
    batch = Batch(tuple(decoded(c) for c in batch.columns), batch.active)
    if not key_channels:
        max_groups = 1
    if max_groups > SMALL_G and _sorted_capable(batch, key_channels, aggs):
        return _group_by_sorted(batch, key_channels, aggs, max_groups)
    keys = [batch.column(c) for c in key_channels]
    ids, perm_first, num_groups, overflow = _group_ids(keys, batch.active,
                                                       max_groups)
    if not key_channels:
        num_groups = torch.clamp(num_groups, min=1)
    slot = torch.arange(max_groups, dtype=torch.int64,
                        device=batch.active.device)
    slot_active = slot < torch.clamp(num_groups, max=max_groups)
    out_cols: List[Block] = [gather_block(k, perm_first, slot_active)
                             for k in keys]
    pool = _SegSumPool(ids, max_groups, limb_form)
    builders = []
    actives, lives = {}, {}
    for spec in aggs:
        if spec.mask_channel not in actives:
            actives[spec.mask_channel] = _masked_active(batch, spec)
        active = actives[spec.mask_channel]
        col, live = None, None
        if spec.input_channel is not None:
            col = batch.column(spec.input_channel)
            key = (spec.input_channel, spec.mask_channel)
            if key not in lives:
                lives[key] = active & ~col.nulls
            live = lives[key]
        builders.extend(_acc_columns(spec, col, active, live, pool, batch))
    pool.compute()
    out_cols.extend(build() for build in builders)
    return GroupByResult(Batch(tuple(out_cols), slot_active), num_groups,
                         overflow)


# ---------------------------------------------------------------------------
# Sorted-mode group-by: the large-table path when _sorted_capable
# ---------------------------------------------------------------------------

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
    layout of `_acc_columns`. `seg_ids` is each sorted row's group slot;
    `pair_first` flags the sorted rows that start a (key, value-order
    column) pair; `live` is the aggregate's active (masked) non-null
    rows."""
    g = max_groups
    zeros_g = torch.zeros(g, dtype=torch.bool, device=live.device)
    name = spec.canonical
    if name == "count_star":
        if spec.mask_channel is not None:
            return [Column(_seg_total(live.to(torch.int64), start, end),
                           zeros_g, T.BIGINT)]
        return [Column(end - start, zeros_g, T.BIGINT)]
    nn = _seg_total(live.to(torch.int64), start, end)
    no_input = nn == 0
    if name == "count":
        return [Column(nn, zeros_g, T.BIGINT)]
    if name == "count_distinct":
        return [Column(_seg_total((live & pair_first).to(torch.int64),
                                  start, end), zeros_g, T.BIGINT)]
    if name == "approx_distinct":
        return [_hll_state_column(_hll_registers_from_values(
            scol, live, seg_ids, g))]
    if name == "hll_merge":
        return [_hll_state_column(_hll_registers_merge(scol, live, seg_ids,
                                                       g))]
    if name == "approx_percentile":
        if spec.parameter is None:
            raise ValueError("approx_percentile needs its fraction "
                             "(parameter)")
        # value-sorted segment, nulls last: the live values sit at
        # [start, start + nn)
        n = live.shape[0]
        target = start + torch.floor(
            (nn - 1).clamp(min=0).to(torch.float64)
            * float(spec.parameter)).to(torch.int64)
        return [gather_block(scol, target.clamp(0, max(n - 1, 0)),
                             ~no_input)]
    if name == "arbitrary":
        n = live.shape[0]
        pos = torch.arange(n, dtype=torch.int64, device=live.device)
        first = _seg_reduce(seg_ids, torch.where(live, pos, n), g, n, True)
        return [gather_block(scol, first.clamp(max=max(n - 1, 0)),
                             first < n)]
    if name in ("min", "max"):
        return [_extreme(spec, scol, seg_ids, live, g, no_input)]
    if name in ("bool_and", "bool_or"):
        v = scol.values.to(torch.bool)
        if name == "bool_and":
            out = _seg_total((live & ~v).to(torch.int64), start, end) == 0
        else:
            out = _seg_total((live & v).to(torch.int64), start, end) > 0
        return [Column(out, no_input, T.BOOLEAN)]
    if name in _VARIANCE_AGGS:
        f = decimal_to_f64(scol)
        s = _seg_total(torch.where(live, f, 0.0), start, end)
        s2 = _seg_total(torch.where(live, f * f, 0.0), start, end)
        return [Column(nn, zeros_g, T.BIGINT), Column(s, no_input, T.DOUBLE),
                Column(s2, no_input, T.DOUBLE)]
    if name not in ("sum", "avg"):
        raise NotImplementedError(f"sorted-mode aggregate {spec.name!r}")
    sum_ty = spec.output_type if name == "sum" else _sum_type(scol.type)
    if isinstance(scol, Int128Column) or scol.type.is_decimal:
        if isinstance(scol, Int128Column):
            limbs = limbs13_of_128(scol.hi, scol.lo)
        else:
            limbs = limbs13_of_i64(scol.values, _nlimbs13(scol.values))
        totals = [_seg_total(torch.where(live, l, 0), start, end)
                  for l in limbs]
        hi, lo = combine_limb_totals_128(torch.stack(totals, dim=-1))
        total: Block = Int128Column(hi, lo, no_input, sum_ty)
    elif scol.values.is_floating_point():
        total = Column(_seg_total(torch.where(
            live, scol.values.to(torch.float64), 0.0), start, end),
            no_input, sum_ty)
    else:
        # 13-bit limb cumsums keep every intermediate exact
        v = scol.values
        tot = torch.zeros(g, dtype=torch.int64, device=live.device)
        for li, l in enumerate(limbs13_of_i64(v, _nlimbs13(v))):
            tot = tot + (_seg_total(torch.where(live, l, 0), start, end)
                         << (13 * li))
        total = Column(tot, no_input, sum_ty)
    if name == "avg":
        return [total, Column(nn, zeros_g, T.BIGINT)]
    return [total]


def _group_by_sorted(batch: Batch, key_channels: Sequence[int],
                     aggs: Sequence[AggSpec], max_groups: int
                     ) -> GroupByResult:
    """Sorted-mode group_by: ONE stable sort of (inactive flag, key
    words, the value-order column's words), segment ids by
    adjacent-word inequality, [start, end) row ranges per group slot by
    searchsorted over the segment ids, and every accumulator a
    segmented reduction in sorted order. The output table gathers keys
    from each segment's first row. One column only can follow the keys
    in the sort (`_sorted_capable`)."""
    n = batch.capacity
    dev = batch.active.device
    keys = [batch.column(c) for c in key_channels]
    words = key_words(keys)
    vo_chans = [s.input_channel for s in aggs
                if s.canonical in _VALUE_ORDER_AGGS]
    pair_words = [] if not vo_chans else key_words(
        [batch.column(vo_chans[0])], nulls_last=True)
    perm = lex_permutation([(~batch.active).to(torch.int64),
                            *(w ^ SIGN for w in words + pair_words)])
    s_active = batch.active[perm]

    # row i > 0 starts a new segment where a key word differs from row
    # i - 1's; built out of place (the rows' words may carry a member
    # axis under exec/batching.py's vmap)
    changed = torch.zeros(max(n - 1, 0), dtype=torch.bool, device=dev)
    for w in words:
        sw = w[perm]
        changed = changed | (sw[1:] != sw[:-1])
    diffs = torch.cat([torch.zeros(min(n, 1), dtype=torch.bool,
                                   device=dev), changed])
    seg = torch.cumsum(diffs.to(torch.int64), dim=0)
    for w in pair_words:
        sw = w[perm]
        changed = changed | (sw[1:] != sw[:-1])
    pair_first = torch.cat([torch.ones(min(n, 1), dtype=torch.bool,
                                       device=dev), changed])

    n_act = s_active.sum()
    # the last active row's segment, read by index_select: indexing with
    # a 0-d tensor would read the index on the host
    last = (n_act - 1).clamp(0, max(n - 1, 0)).reshape(1)
    num_groups = torch.where(n_act > 0,
                             seg.index_select(0, last).reshape(()) + 1, 0)
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

    def sorted_col(ch: int) -> Block:
        if ch not in sorted_cols:
            sorted_cols[ch] = gather_block(batch.column(ch), perm)
        return sorted_cols[ch]

    for spec in aggs:
        act = s_active
        if spec.mask_channel is not None:
            m = sorted_col(spec.mask_channel)
            act = act & m.values.to(torch.bool) & ~m.nulls
        if spec.input_channel is None:
            scol, live = None, act
        else:
            scol = sorted_col(spec.input_channel)
            live = act & ~scol.nulls
        out_cols.extend(_sorted_states(spec, scol, live, start, end,
                                       seg_ids, pair_first, max_groups))
    return GroupByResult(Batch(tuple(out_cols), slot_active),
                         num_groups.to(torch.int32), overflow)


# ---------------------------------------------------------------------------
# partial states: widths, merge, finalize
# ---------------------------------------------------------------------------

def state_width(spec: AggSpec) -> int:
    """State columns of one aggregate in a PARTIAL table."""
    c = spec.canonical
    if c in _VARIANCE_AGGS:
        return 3
    if c in _PAIR_MOMENT_AGGS:
        return 6
    if c in ("avg", "min_by", "max_by", "geometric_mean"):
        return 2
    return 1


def state_types(spec: AggSpec, input_types: Sequence[T.Type]
                ) -> List[T.Type]:
    """The types of one aggregate's state columns in a PARTIAL table
    (`state_width` of them), its input row's types `input_types`."""
    c = spec.canonical
    if c == "approx_distinct":
        return [hll_state_type()]
    if c == "avg":
        return [_sum_type(input_types[spec.input_channel]), T.BIGINT]
    if c in ("min_by", "max_by"):
        return [spec.output_type, spec.second_type or T.BIGINT]
    if c in _VARIANCE_AGGS or c in _PAIR_MOMENT_AGGS \
            or c == "geometric_mean":
        return [T.BIGINT] + [T.DOUBLE] * (state_width(spec) - 1)
    return [spec.output_type]


def merge_spec(spec: AggSpec, state_channel: int) -> List[AggSpec]:
    """The FINAL step's aggregates over a partial state at
    `state_channel`: sum <- sum, count <- sum, min <- min, max <- max,
    avg <- (sum of sums, sum of counts), the moments <- their sums,
    min_by/max_by <- min_by/max_by over the (value, order) state, HLL
    registers <- their elementwise max. count_distinct and
    approx_percentile states do not merge."""
    c = spec.canonical
    if c == "sum":
        return [AggSpec("sum", state_channel, spec.output_type)]
    if c in ("count", "count_star", "checksum"):
        return [AggSpec("sum", state_channel, T.BIGINT)]
    if c in ("min", "max"):
        return [AggSpec(c, state_channel, spec.output_type)]
    if c in ("bool_and", "bool_or"):
        return [AggSpec(c, state_channel, T.BOOLEAN)]
    if c == "avg":
        # the sum state keeps the avg's scale, which the finalizing
        # divide reads from the block's type
        sum_ty = T.decimal(38, spec.output_type.scale) \
            if spec.output_type.is_decimal else T.DOUBLE
        return [AggSpec("sum", state_channel, sum_ty),
                AggSpec("sum", state_channel + 1, T.BIGINT)]
    if c in _VARIANCE_AGGS or c in _PAIR_MOMENT_AGGS \
            or c == "geometric_mean":
        return [AggSpec("sum", state_channel, T.BIGINT)] + \
            [AggSpec("sum", state_channel + i, T.DOUBLE)
             for i in range(1, state_width(spec))]
    if c in ("min_by", "max_by"):
        return [AggSpec(c, state_channel, spec.output_type,
                        second_channel=state_channel + 1,
                        second_type=spec.second_type)]
    if c == "arbitrary":
        return [AggSpec("arbitrary", state_channel, spec.output_type)]
    if c == "approx_distinct":
        return [AggSpec("hll_merge", state_channel, T.BIGINT)]
    if c in ("count_distinct", "approx_percentile"):
        raise NotImplementedError(
            f"{spec.name} states don't merge across partials; distributed "
            "plans must hash-exchange raw rows by the group keys first, "
            "then aggregate in one step (the standard mark_distinct plan "
            "shape; sketch states arrive with the KLL/HLL library)")
    raise NotImplementedError(spec.name)


def merge_partials(partials: Batch, num_keys: int, aggs: Sequence[AggSpec],
                   max_groups: int, limb_form: str = "narrow"
                   ) -> GroupByResult:
    """The FINAL (or INTERMEDIATE) step: re-group the rows of partial
    state tables (keys, then each aggregate's states) by their keys
    with the merge aggregates of merge_spec."""
    specs: List[AggSpec] = []
    ch = num_keys
    for spec in aggs:
        specs.extend(merge_spec(spec, ch))
        ch += state_width(spec)
    return group_by(partials, list(range(num_keys)), specs, max_groups,
                    limb_form)


def finalize_pair_moments(c: str, n, sy, sx, syy, sxx, sxy):
    """(n, sy, sx, syy, sxx, sxy) -> (value, nulls) for the two-input
    statistics. Population co-moments: cxy = sxy - sx * sy / n."""
    # W001: the statistics are DOUBLE
    nf = n.to(torch.float64)  # tpulint: disable=W001
    safe_n = nf.clamp(min=1.0)
    cxy = sxy - sx * sy / safe_n
    cxx = (sxx - sx * sx / safe_n).clamp(min=0.0)
    cyy = (syy - sy * sy / safe_n).clamp(min=0.0)
    if c == "covar_pop":
        return cxy / safe_n, n < 1
    if c == "covar_samp":
        return cxy / (nf - 1.0).clamp(min=1.0), n < 2
    if c == "corr":
        denom = torch.sqrt(cxx * cyy)
        v = torch.where(denom > 0, cxy / denom.clamp(min=1e-300), 0.0)
        return v, (n < 2) | (denom <= 0)
    slope = torch.where(cxx > 0, cxy / cxx.clamp(min=1e-300), 0.0)
    nulls = (n < 2) | (cxx <= 0)
    if c == "regr_slope":
        return slope, nulls
    return (sy - slope * sx) / safe_n, nulls  # regr_intercept


def finalize_variance(spec: AggSpec, count: torch.Tensor, s: torch.Tensor,
                      s2: torch.Tensor):
    """(count, sum, sumsq) -> (value, nulls) for the variance family:
    var = (sumsq - sum^2 / n) / (n - ddof), floored at 0."""
    c = spec.canonical
    ddof = 1 if c in ("var_samp", "stddev_samp") else 0
    # W001: the variance family is DOUBLE
    n = count.to(torch.float64)  # tpulint: disable=W001
    var = (s2 - s * s / n.clamp(min=1.0)) / (n - ddof).clamp(min=1.0)
    var = var.clamp(min=0.0)
    if c.startswith("stddev"):
        var = torch.sqrt(var)
    return var, count < (2 if ddof else 1)


def finalize_states(table: Batch, num_keys: int, aggs: Sequence[AggSpec]
                    ) -> Batch:
    """State table (keys..., states...) -> one column per aggregate:
    avg divides sum by count with the registered decimal `divide`
    (exact, half away from zero); the moments fold into their
    statistic; approx_distinct estimates from its registers;
    min_by/max_by drop their order state; the rest pass through."""
    cols: List[Block] = list(table.columns[:num_keys])
    ch = num_keys
    for spec in aggs:
        w = state_width(spec)
        states = table.columns[ch:ch + w]
        ch += w
        c = spec.canonical
        if c == "avg":
            cols.append(lookup("divide").fn(spec.output_type, states[0],
                                            states[1]))
        elif c in _VARIANCE_AGGS:
            v, nulls = finalize_variance(spec, *(s.values for s in states))
            cols.append(Column(v, nulls, T.DOUBLE))
        elif c in _PAIR_MOMENT_AGGS:
            v, nulls = finalize_pair_moments(c, *(s.values for s in states))
            cols.append(Column(v, nulls, T.DOUBLE))
        elif c == "geometric_mean":
            cnt, slog = states
            # W001: geometric_mean is DOUBLE
            n = cnt.values.to(torch.float64).clamp(min=1.0)  # tpulint: disable=W001
            cols.append(Column(torch.exp(slog.values / n), cnt.values == 0,
                               T.DOUBLE))
        elif c == "approx_distinct":
            est = hll_estimate(states[0].elements)
            cols.append(Column(est, torch.zeros_like(est, dtype=torch.bool),
                               T.BIGINT))
        else:
            cols.append(states[0])
    return Batch(tuple(cols), table.active)
