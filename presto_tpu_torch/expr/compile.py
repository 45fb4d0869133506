"""RowExpression evaluation over a Batch: the PageFilter/PageProjection
analog.

Counterpart of presto_tpu/expr/compile.py (`evaluate`, `_eval_special`
for AND/OR/IN/IS_NULL/IF/NULL_IF/COALESCE/BETWEEN/SWITCH,
`_constant_block`, `_like`, `_select`, `_bind_lambda`,
`_eval_array_lambda`, `_eval_map_lambda`, `compile_filter`,
`compile_projections`). PyTorch runs eagerly, so "compiling" an
expression is binding it into a closure over the tree.

Some calls take an argument that is plan structure, not data, and
`evaluate` dispatches them by name as the reference does: the patterns
of LIKE, regexp_like and regexp_replace, the zone of at_timezone, the
format of date_format, the units of date_add, date_trunc and
date_diff, the delimiter and index of split_part, the field index of
row_field and the bounds of sequence must be constants. A call that
gives one as an expression is refused. ARRAY[...] and the lambda
functions over arrays and maps are dispatched by name too.

Null semantics are Presto's three-valued logic: a scalar call is NULL
when any argument is; AND, OR and IN are Kleene; IF, COALESCE and
SWITCH compute every branch and then select lanes, as the reference
does.

A template plan of exec/batching.py carries BatchParam leaves where the
plan had literals: `evaluate` reads slot `index` of the parameter
vector bound on this thread by `bound_params`, and refuses outside one,
as the reference does. The batching executor binds, under
torch.func.vmap over the batch's members, batched 0-d tensors: each
member's value and null of the batch's [B, P] tensors, already on the
device. A parameter block is its one value expanded to the capacity,
with no read on the host. Inside `shared_constants` the broadcast
blocks of literals are built once and reused.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Sequence

import numpy as np
import torch

from .. import types as T
from .. import tz as TZ
from ..block import (ArrayColumn, Batch, Block, Column, Int128Column,
                     MapColumn, StringColumn, decoded, gather_block,
                     pad_chars, torch_dtype)
from ..ops.regex import compile_dfa, regexp_like_kernel
from . import functions as F
from .ir import (BatchParam, Call, Constant, InputReference, Lambda,
                 LambdaVariable, RowExpression, SpecialForm)
from .logical import rewrite_bottom_up

__all__ = ["compile_filter", "compile_projections", "evaluate",
           "bound_params", "shared_constants"]

_SCOPE = threading.local()


@contextlib.contextmanager
def bound_params(values: Sequence):
    """Bind the parameter vector that BatchParam leaves read on this
    thread: a sequence of (value, is_null) pairs, each a Python scalar
    or a 0-d tensor on the batch's device (a value of a floating type
    as a float64 tensor, see exec/batching.py)."""
    prev = getattr(_SCOPE, "params", None)
    _SCOPE.params = values
    try:
        yield
    finally:
        _SCOPE.params = prev


@contextlib.contextmanager
def shared_constants():
    """Reuse each literal's one-element block across the evaluations
    inside this scope (the members of one batch)."""
    prev = getattr(_SCOPE, "constants", None)
    _SCOPE.constants = {}
    try:
        yield
    finally:
        _SCOPE.constants = prev


def _param_block(p: BatchParam, capacity: int, device) -> Block:
    params = getattr(_SCOPE, "params", None)
    if params is None:
        raise RuntimeError(
            "BatchParam evaluated outside a bound_params scope: template "
            "plans only execute through exec/batching.py")
    v, null = params[p.index]
    dt = torch_dtype(p.type.to_dtype())
    if isinstance(v, torch.Tensor):
        values = v.reshape(1).to(device).to(dt)
    else:
        values = torch.full((1,), v, dtype=dt, device=device)
    nulls = null.reshape(1).to(device) if isinstance(null, torch.Tensor) \
        else torch.full((1,), bool(null), dtype=torch.bool, device=device)
    return Column(values.expand(capacity), nulls.to(torch.bool)
                  .expand(capacity), p.type)


def _constant_block(c: Constant, capacity: int, device) -> Block:
    """A literal broadcast to the batch: one element expanded to
    `capacity` rows (a view, no per-row storage)."""
    memo = getattr(_SCOPE, "constants", None)
    if memo is None:
        return _expand(_one_constant(c, device), capacity)
    key = (str(c.type), repr(c.value), str(device))
    one = memo.get(key)
    if one is None:
        one = memo[key] = _one_constant(c, device)
    return _expand(one, capacity)


def _expand(block: Block, capacity: int) -> Block:
    """A one-row constant block expanded to `capacity` rows (views)."""
    if isinstance(block, StringColumn):
        return StringColumn(block.chars.expand(capacity,
                                               block.chars.shape[1]),
                            block.lengths.expand(capacity),
                            block.nulls.expand(capacity), block.type)
    return Column(block.values.expand(capacity),
                  block.nulls.expand(capacity), block.type)


def _one_constant(c: Constant, device) -> Block:
    """The literal as a one-row block."""
    ty = c.type
    if c.value is None:
        nulls = torch.ones(1, dtype=torch.bool, device=device)
        if ty.is_string:
            return StringColumn(
                torch.zeros((1, 1), dtype=torch.uint8, device=device),
                torch.zeros(1, dtype=torch.int32, device=device), nulls, ty)
        dt = torch_dtype(np.bool_ if ty == T.UNKNOWN else ty.to_dtype())
        return Column(torch.zeros(1, dtype=dt, device=device), nulls, ty)
    no_nulls = torch.zeros(1, dtype=torch.bool, device=device)
    if ty.is_string:
        b = str(c.value).encode("utf-8")
        w = max(len(b), 1)
        chars = torch.tensor(list(b.ljust(w, b"\x00")), dtype=torch.uint8,
                             device=device)
        return StringColumn(chars[None, :],
                            torch.full((1,), len(b), dtype=torch.int32,
                                       device=device), no_nulls, ty)
    v = c.value
    if ty.base == "date" and isinstance(v, str):
        v = int((np.datetime64(v) - np.datetime64("1970-01-01")).astype(int))
    values = torch.full((1,), v, dtype=torch_dtype(ty.to_dtype()),
                        device=device)
    return Column(values, no_nulls, ty)


def _like(a: StringColumn, pattern: str) -> torch.Tensor:
    """Full LIKE matcher for patterns of %/_ wildcards, vectorized:
    segments between % marks are located left-to-right greedily (each
    segment's first feasible window), with '_' matching any single char.
    Greedy works because segments are matched earliest-first, which never
    eliminates a later feasible assignment (classic glob argument)."""
    pat = pattern.encode("utf-8")
    anchored_left = not pat.startswith(b"%")
    anchored_right = not pat.endswith(b"%")
    segments = [s for s in pat.split(b"%") if s != b""]
    n, w = a.chars.shape
    lengths = a.lengths
    dev = a.chars.device

    if not segments:
        # pattern is only % signs (or empty)
        if pat == b"":
            return lengths == 0
        return torch.ones(n, dtype=torch.bool, device=dev)

    def seg_match_windows(seg: bytes):
        """(N, windows) bool: seg matches at window start i ('_' = any)."""
        L = len(seg)
        windows = w - L + 1
        if windows <= 0:
            return None
        start = torch.arange(windows, dtype=torch.int64, device=dev)
        idx = start[:, None] + torch.arange(L, dtype=torch.int64,
                                            device=dev)[None, :]
        g = a.chars[:, idx]  # (N, windows, L)
        sarr = torch.tensor(list(seg), dtype=torch.uint8, device=dev)
        wild = sarr == ord("_")
        m = ((g == sarr) | wild).all(dim=2)
        ends_ok = (start + L)[None, :] <= lengths[:, None]
        return m & ends_ok

    ok = torch.ones(n, dtype=torch.bool, device=dev)
    earliest = torch.zeros(n, dtype=torch.int64, device=dev)

    # all segments except (if right-anchored) the last: greedy earliest match
    loop_segments = segments[:-1] if anchored_right else segments
    for si, seg in enumerate(loop_segments):
        m = seg_match_windows(seg)
        if m is None:
            return torch.zeros(n, dtype=torch.bool, device=dev)
        pos = torch.arange(m.shape[1], dtype=torch.int64, device=dev)[None, :]
        feasible = m & (pos >= earliest[:, None])
        if si == 0 and anchored_left:
            feasible = feasible & (pos == 0)
        found = feasible.any(dim=1)
        # the first True window (argmax returns the first maximum)
        first = torch.argmax(feasible.to(torch.uint8), dim=1)
        ok = ok & found
        earliest = first + len(seg)

    if anchored_right:
        last = segments[-1]
        m = seg_match_windows(last)
        if m is None:
            return torch.zeros(n, dtype=torch.bool, device=dev)
        # the last segment must match ending exactly at the string end,
        # starting no earlier than where the previous segments finished
        end_pos = lengths.to(torch.int64) - len(last)
        at_end = torch.gather(
            m, 1, end_pos.clamp(0, m.shape[1] - 1)[:, None])[:, 0]
        ok = ok & at_end & (end_pos >= earliest)
        if anchored_left and len(segments) == 1:
            ok = ok & (lengths == len(last))  # no % at all: exact-width match
    return ok


def evaluate(expr: RowExpression, batch: Batch) -> Block:
    if isinstance(expr, InputReference):
        return decoded(batch.column(expr.channel))
    if isinstance(expr, Constant):
        return _constant_block(expr, batch.capacity, batch.active.device)
    if isinstance(expr, BatchParam):
        return _param_block(expr, batch.capacity, batch.active.device)
    if isinstance(expr, SpecialForm):
        return _eval_special(expr, batch)
    if isinstance(expr, Call):
        name = expr.name.lower()
        if name in _BY_NAME:
            return _BY_NAME[name](expr, batch)
        if name in _ARRAY_LAMBDAS and \
                any(isinstance(a, Lambda) for a in expr.arguments):
            return _eval_array_lambda(expr, batch)
        if name in _MAP_LAMBDAS:
            return _eval_map_lambda(expr, batch)
        args = [evaluate(a, batch) for a in expr.arguments]
        sf = F.lookup(name)
        out = sf.fn(expr.type, *args)
        if sf.null_fn is not None:
            nulls = sf.null_fn(expr.type, *args)
            if nulls is not None:  # None: the function set its own mask
                out = _with_nulls(out, nulls)
        return out
    raise TypeError(f"cannot evaluate {type(expr)}")


def _constant_arg(expr: Call, i: int, what: str):
    """The value of argument i, which must be a constant."""
    c = expr.arguments[i]
    if not isinstance(c, Constant):
        raise NotImplementedError(
            f"{expr.name} needs a constant {what}, as in the reference")
    return c.value


def _eval_like(expr: Call, batch: Batch) -> Block:
    a = evaluate(expr.arguments[0], batch)
    pat = _constant_arg(expr, 1, "pattern")
    return Column(_like(a, str(pat)), a.nulls, expr.type)


def _eval_regexp_like(expr: Call, batch: Batch) -> Block:
    """The pattern compiles to a DFA on the host (a pattern the DFA
    refuses raises RegexUnsupported); the rows scan on the device."""
    a = evaluate(expr.arguments[0], batch)
    table, accepting = compile_dfa(str(_constant_arg(expr, 1, "pattern")))
    return Column(regexp_like_kernel(a.chars, a.lengths, table, accepting),
                  a.nulls, expr.type)


def _eval_at_timezone(expr: Call, batch: Batch) -> Block:
    """The same instant with another zone key; a naive timestamp is a
    UTC instant."""
    a = evaluate(expr.arguments[0], batch)
    key = TZ.zone_key(str(_constant_arg(expr, 1, "zone")))
    inst = a.values.to(torch.int64)
    if a.type.base == "timestamp with time zone":
        inst = TZ.unpack_micros(inst)
    return Column(TZ.pack(inst, key), a.nulls, expr.type)


def _eval_regexp_replace(expr: Call, batch: Batch) -> Block:
    a = evaluate(expr.arguments[0], batch)
    pat = str(_constant_arg(expr, 1, "pattern"))
    rep = "" if len(expr.arguments) < 3 else \
        str(_constant_arg(expr, 2, "replacement"))
    return F.regexp_replace(a, pat, rep, expr.type)


def _eval_date_format(expr: Call, batch: Batch) -> Block:
    d = evaluate(expr.arguments[0], batch)
    chars, lengths = F.date_format_kernel(
        d.values, d.type, str(_constant_arg(expr, 1, "format")))
    return StringColumn(chars, lengths, d.nulls, expr.type)


def _eval_date_add(expr: Call, batch: Batch) -> Block:
    """date_add(unit, n, date): days and weeks add to the lanes, months
    and years do calendar arithmetic clamped at the month's end."""
    unit = str(_constant_arg(expr, 0, "unit"))
    n = evaluate(expr.arguments[1], batch)
    d = evaluate(expr.arguments[2], batch)
    nv, dv = n.values.to(torch.int64), d.values.to(torch.int64)
    step = {"day": 1, "week": 7}.get(unit)
    if step is not None:
        vals = dv + nv * step
    elif unit in ("month", "year"):
        vals = F._month_add(dv, nv * 12 if unit == "year" else nv)
    else:
        raise NotImplementedError(f"date_add unit {unit!r}")
    return Column(vals.to(torch_dtype(d.type.to_dtype())),
                  F._default_nulls(n, d), expr.type)


def _eval_date_trunc(expr: Call, batch: Batch) -> Block:
    u = str(_constant_arg(expr, 0, "unit"))
    d = evaluate(expr.arguments[1], batch)
    v = d.values.to(torch.int64)
    if d.type.base == "timestamp":
        step = {"second": 1_000_000, "minute": 60_000_000,
                "hour": 3_600_000_000}.get(u)
        if step is not None:
            vals = F._fdiv(v, step) * step
        else:  # calendar units truncate through days
            vals = F.date_trunc_kernel(u, F._fdiv(v, F._DAY_US)) * F._DAY_US
    elif d.type.base == "date":
        vals = F.date_trunc_kernel(u, v)
    else:
        raise NotImplementedError(f"date_trunc of {d.type}")
    return Column(vals.to(torch_dtype(d.type.to_dtype())), d.nulls,
                  expr.type)


def _as_micros(b: Block) -> torch.Tensor:
    v = b.values.to(torch.int64)
    return v * F._DAY_US if b.type.base == "date" else v


def _eval_date_diff(expr: Call, batch: Batch) -> Block:
    """Whole units from the first date to the second, truncated toward
    zero. With a timestamp, sub-day units count elapsed micros, and
    calendar units count on days with the time of day breaking a tie
    of the day of month."""
    u = str(_constant_arg(expr, 0, "unit"))
    d1 = evaluate(expr.arguments[1], batch)
    d2 = evaluate(expr.arguments[2], batch)
    if "timestamp" in (d1.type.base, d2.type.base):
        m1, m2 = _as_micros(d1), _as_micros(d2)
        step = {"millisecond": 1_000, "second": 1_000_000,
                "minute": 60_000_000, "hour": 3_600_000_000,
                "day": F._DAY_US, "week": 7 * F._DAY_US}.get(u)
        if step is not None:
            vals = F._trunc_units(m2 - m1, step)
        else:
            day1, day2 = F._fdiv(m1, F._DAY_US), F._fdiv(m2, F._DAY_US)
            vals = F.date_diff_kernel(u, day1, day2)
            tie = F._civil(day1)[2] == F._civil(day2)[2]
            tod1, tod2 = F._fmod(m1, F._DAY_US), F._fmod(m2, F._DAY_US)
            adj = torch.where((vals > 0) & tie & (tod2 < tod1), 1,
                              torch.where((vals < 0) & tie & (tod2 > tod1),
                                          -1, 0))
            vals = vals - adj
    elif d1.type.base == "date" and d2.type.base == "date":
        vals = F.date_diff_kernel(u, d1.values, d2.values)
    else:
        raise NotImplementedError(f"date_diff of {d1.type} and {d2.type}")
    return Column(vals.to(torch_dtype(expr.type.to_dtype())),
                  F._default_nulls(d1, d2), expr.type)


def _eval_split_part(expr: Call, batch: Batch) -> Block:
    a = evaluate(expr.arguments[0], batch)
    delim = str(_constant_arg(expr, 1, "delimiter")).encode()
    index = int(_constant_arg(expr, 2, "index"))
    return F.split_part_kernel(a, delim, index, expr.type)


def _eval_row_field(expr: Call, batch: Batch) -> Block:
    """The field index is plan structure; a NULL row nulls the field."""
    r = evaluate(expr.arguments[0], batch)
    i = int(_constant_arg(expr, 1, "field index"))
    rows = torch.arange(len(r), device=r.nulls.device)
    return gather_block(r.field(i), rows, ~r.nulls)


def _eval_array_constructor(expr: Call, batch: Batch) -> Block:
    """ARRAY[e1, ..., ek]: the k element columns side by side, each
    cast to the element type; ARRAY[] is empty in every row."""
    cap, dev = batch.capacity, batch.active.device
    elems = [evaluate(a, batch) for a in expr.arguments]
    ety = expr.type.element_type
    if not elems:
        dt = torch.int64 if ety == T.UNKNOWN else torch_dtype(ety.to_dtype())
        return ArrayColumn(torch.zeros((cap, 1), dtype=dt, device=dev),
                           torch.ones((cap, 1), dtype=torch.bool, device=dev),
                           torch.zeros(cap, dtype=torch.int32, device=dev),
                           torch.zeros(cap, dtype=torch.bool, device=dev),
                           expr.type)
    if any(isinstance(e, StringColumn) for e in elems):
        raise NotImplementedError("ARRAY[] of strings is not supported, as "
                                  "in the reference")
    dt = torch_dtype(ety.to_dtype())
    return ArrayColumn(torch.stack([e.values.to(dt) for e in elems], dim=1),
                       torch.stack([e.nulls for e in elems], dim=1),
                       torch.full((cap,), len(elems), dtype=torch.int32,
                                  device=dev),
                       torch.zeros(cap, dtype=torch.bool, device=dev),
                       expr.type)


def _eval_sequence(expr: Call, batch: Batch) -> Block:
    """sequence(lo, hi[, step]) with constant bounds: one bigint row,
    the same in every row (a view)."""
    cap, dev = batch.capacity, batch.active.device
    lo = int(_constant_arg(expr, 0, "lower bound"))
    hi = int(_constant_arg(expr, 1, "upper bound"))
    step = int(_constant_arg(expr, 2, "step")) if len(expr.arguments) > 2 \
        else (1 if hi >= lo else -1)
    seq = np.arange(lo, hi + (1 if step > 0 else -1), step, dtype=np.int64)
    k = max(len(seq), 1)
    row = torch.from_numpy(seq if len(seq) else np.zeros(1, np.int64))
    return ArrayColumn(row.to(dev)[None, :].expand(cap, k),
                       torch.zeros((1, k), dtype=torch.bool,
                                   device=dev).expand(cap, k),
                       torch.full((1,), len(seq), dtype=torch.int32,
                                  device=dev).expand(cap),
                       torch.zeros(1, dtype=torch.bool,
                                   device=dev).expand(cap), expr.type)


_BY_NAME = {"like": _eval_like, "regexp_like": _eval_regexp_like,
            "at_timezone": _eval_at_timezone,
            "regexp_replace": _eval_regexp_replace,
            "date_format": _eval_date_format, "date_add": _eval_date_add,
            "date_trunc": _eval_date_trunc, "date_diff": _eval_date_diff,
            "split_part": _eval_split_part, "row_field": _eval_row_field,
            "array_constructor": _eval_array_constructor,
            "sequence": _eval_sequence}
_ARRAY_LAMBDAS = ("transform", "filter", "any_match", "all_match",
                  "none_match", "reduce")
_MAP_LAMBDAS = ("transform_values", "transform_keys", "map_filter")


def _channels(e: RowExpression, out: set) -> set:
    if isinstance(e, InputReference):
        out.add(e.channel)
    for c in e.children():
        _channels(c, out)
    return out


def _bind_lambda(lam: Lambda, batch: Batch, params: Sequence[Block]
                 ) -> Block:
    """The lambda's body over `batch` with its parameters bound to
    `params`, appended as channels past the batch's own."""
    nc = batch.num_columns
    slot = {p: nc + i for i, p in enumerate(lam.parameters)}

    def sub(x):
        if isinstance(x, LambdaVariable) and x.name in slot:
            return InputReference(x.type, slot[x.name])
        return x

    body = rewrite_bottom_up(lam.body, sub)
    return evaluate(body, Batch(tuple(batch.columns) + tuple(params),
                                batch.active))


def _element_batch(batch: Batch, lam: Lambda, lanes: torch.Tensor
                   ) -> Batch:
    """The batch with each row repeated once per lane of its (N, K)
    collection, active where the lane is in range: the columns the
    lambda's body captures are gathered, the others left out (None),
    since nothing reads them."""
    n, k = lanes.shape
    rep = torch.arange(n, device=lanes.device).repeat_interleave(k)
    used = _channels(lam, set())
    cols = tuple(gather_block(c, rep) if ci in used else None
                 for ci, c in enumerate(batch.columns))
    return Batch(cols, (batch.active[:, None] & lanes).reshape(-1))


def _eval_array_lambda(expr: Call, batch: Batch) -> Block:
    """transform, filter, reduce, any_match, all_match and none_match.
    The element axis is flattened: the lambda's body runs once over the
    (N*K,) element lanes with the captured columns repeated K times;
    reduce runs K steps, one per lane."""
    name = expr.name.lower()
    arr = evaluate(expr.arguments[0], batch)
    n, k = arr.elements.shape
    ety = expr.arguments[0].type.element_type
    in_range = F._arr_in_range(arr)

    if name == "reduce":
        state = evaluate(expr.arguments[1], batch)
        comb, out_lam = expr.arguments[2], expr.arguments[3]
        for j in range(k):
            elem = Column(arr.elements[:, j], arr.elem_nulls[:, j] | arr.nulls,
                          ety)
            new_state = _bind_lambda(comb, batch, [state, elem])
            live = (arr.lengths > j) & ~arr.nulls
            state = _select(live, new_state, state, new_state.type)
        res = _bind_lambda(out_lam, batch, [state])
        # a NULL array reduces to NULL
        return dataclasses.replace(res, nulls=res.nulls | arr.nulls,
                                   type=expr.type)

    lam = expr.arguments[1]
    flat = Column(arr.elements.reshape(-1),
                  (arr.elem_nulls | ~in_range).reshape(-1), ety)
    out = _bind_lambda(lam, _element_batch(batch, lam, in_range), [flat])
    if name == "transform":
        if isinstance(out, StringColumn):
            raise NotImplementedError("transform to string elements is not "
                                      "supported, as in the reference")
        return ArrayColumn(out.values.reshape(n, k),
                           out.nulls.reshape(n, k) | ~in_range, arr.lengths,
                           arr.nulls, expr.type)
    pv = (out.values & ~out.nulls).reshape(n, k) & in_range
    pn = out.nulls.reshape(n, k) & in_range
    if name == "filter":
        order = torch.argsort((~pv).to(torch.uint8), dim=1, stable=True)
        return ArrayColumn(torch.gather(arr.elements, 1, order),
                           torch.gather(arr.elem_nulls, 1, order),
                           pv.sum(dim=1).to(arr.lengths.dtype), arr.nulls,
                           expr.type)
    any_true = pv.any(dim=1)
    any_null = pn.any(dim=1)
    if name == "all_match":
        any_false = ((~(out.values | out.nulls)).reshape(n, k)
                     & in_range).any(dim=1)
        nulls = ~any_false & any_null | arr.nulls
        return Column(~any_false & ~nulls, nulls, expr.type)
    v = ~any_true if name == "none_match" else any_true
    nulls = ~any_true & any_null | arr.nulls
    return Column(v & ~nulls, nulls, expr.type)


def _eval_map_lambda(expr: Call, batch: Batch) -> Block:
    """transform_values, transform_keys and map_filter: the (key,
    value) lambda runs once over the flattened (N*K,) entry lanes, as
    in the array path."""
    name = expr.name.lower()
    m = evaluate(expr.arguments[0], batch)
    lam = expr.arguments[1]
    n, k = m.keys.shape
    mty = expr.arguments[0].type
    in_range = F._arr_in_range(m)
    flat_k = Column(m.keys.reshape(-1), (~in_range).reshape(-1), mty.key_type)
    flat_v = Column(m.values.reshape(-1),
                    (m.value_nulls | ~in_range).reshape(-1), mty.value_type)
    out = _bind_lambda(lam, _element_batch(batch, lam, in_range),
                       [flat_k, flat_v])
    if isinstance(out, StringColumn):
        raise NotImplementedError(f"{name} to string lanes is not "
                                  "supported, as in the reference")
    if name == "transform_values":
        return MapColumn(m.keys, out.values.reshape(n, k),
                         out.nulls.reshape(n, k) | ~in_range, m.lengths,
                         m.nulls, expr.type)
    if name == "transform_keys":
        # keys must be non-NULL and distinct: Presto raises on a NULL or
        # duplicate key; the reference, and so the port, gives a NULL map
        nk = out.values.reshape(n, k)
        bad = (out.nulls.reshape(n, k) & in_range).any(dim=1)
        both = in_range[:, :, None] & in_range[:, None, :]
        eq = (nk[:, :, None] == nk[:, None, :]) & both
        eye = torch.eye(k, dtype=torch.bool, device=nk.device)
        dup = (eq & ~eye[None]).any(dim=2).any(dim=1)
        return MapColumn(nk, m.values, m.value_nulls, m.lengths,
                         m.nulls | bad | dup, expr.type)
    # map_filter: keep the entries whose predicate is TRUE, in order
    keep = (out.values & ~out.nulls).reshape(n, k) & in_range
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    return MapColumn(torch.gather(m.keys, 1, order),
                     torch.gather(m.values, 1, order),
                     torch.gather(m.value_nulls, 1, order),
                     keep.sum(dim=1).to(m.lengths.dtype), m.nulls, expr.type)


def _with_nulls(b: Block, nulls: torch.Tensor) -> Block:
    return dataclasses.replace(b, nulls=nulls)


def _bool(b: Block):
    """(value, null) lanes of a boolean block; values under null are
    False."""
    return b.values & ~b.nulls, b.nulls


def _eval_special(expr: SpecialForm, batch: Batch) -> Block:
    form, args = expr.form, expr.arguments
    if form == "AND":
        # Kleene: FALSE if any FALSE; else NULL if any NULL; else TRUE
        any_false, any_null = None, None
        for a in args:
            bv, bn = _bool(evaluate(a, batch))
            f = ~bv & ~bn
            any_false = f if any_false is None else (any_false | f)
            any_null = bn if any_null is None else (any_null | bn)
        nulls = ~any_false & any_null
        return Column(~any_false & ~nulls, nulls, expr.type)
    if form == "OR":
        # Kleene: TRUE if any TRUE; else NULL if any NULL; else FALSE
        any_true, any_null = None, None
        for a in args:
            bv, bn = _bool(evaluate(a, batch))
            any_true = bv if any_true is None else (any_true | bv)
            any_null = bn if any_null is None else (any_null | bn)
        return Column(any_true, ~any_true & any_null, expr.type)
    if form == "IS_NULL":
        a = evaluate(args[0], batch)
        return Column(a.nulls, torch.zeros_like(a.nulls), expr.type)
    if form == "IF":
        cv, cn = _bool(evaluate(args[0], batch))
        t = evaluate(args[1], batch)
        f = evaluate(args[2], batch) if len(args) > 2 else _constant_block(
            Constant(expr.type, None), batch.capacity, batch.active.device)
        return _select(cv & ~cn, t, f, expr.type)
    if form == "NULL_IF":
        a = evaluate(args[0], batch)
        ev, en = _bool(F.lookup("eq").fn(T.BOOLEAN, a,
                                         evaluate(args[1], batch)))
        return dataclasses.replace(a, nulls=a.nulls | (ev & ~en),
                                   type=expr.type)
    if form == "COALESCE":
        out = evaluate(args[0], batch)
        for a in args[1:]:
            out = _select(~out.nulls, out, evaluate(a, batch), expr.type)
        return out
    if form == "IN":
        # TRUE on a match; else NULL if the value or any item is NULL
        x = evaluate(args[0], batch)
        eq = F.lookup("eq").fn
        any_match, any_null = None, x.nulls
        for a in args[1:]:
            b = evaluate(a, batch)
            ev, _ = _bool(eq(T.BOOLEAN, x, b))
            any_match = ev if any_match is None else (any_match | ev)
            any_null = any_null | b.nulls
        nulls = ~any_match & any_null
        return Column(any_match & ~nulls, nulls, expr.type)
    if form == "BETWEEN":
        x = evaluate(args[0], batch)
        lo = evaluate(args[1], batch)
        hi = evaluate(args[2], batch)
        ge = F.lookup("ge").fn(T.BOOLEAN, x, lo)
        le = F.lookup("le").fn(T.BOOLEAN, x, hi)
        n = x.nulls | lo.nulls | hi.nulls
        return Column(ge.values & le.values & ~n, n, expr.type)
    if form == "SWITCH":
        # args: operand, WHEN(value, result)..., [else]
        operand = args[0]
        whens = [a for a in args[1:]
                 if isinstance(a, SpecialForm) and a.form == "WHEN"]
        els = [a for a in args[1:]
               if not (isinstance(a, SpecialForm) and a.form == "WHEN")]
        out = evaluate(els[0], batch) if els else _constant_block(
            Constant(expr.type, None), batch.capacity, batch.active.device)
        is_searched = isinstance(operand, Constant) and operand.value is True
        op_block = None if is_searched else evaluate(operand, batch)
        for wh in reversed(whens):
            cond_expr, res_expr = wh.arguments
            if is_searched:
                cv, cn = _bool(evaluate(cond_expr, batch))
            else:
                c = evaluate(cond_expr, batch)
                cv, cn = _bool(F.lookup("eq").fn(T.BOOLEAN, op_block, c))
            res = evaluate(res_expr, batch)
            out = _select(cv & ~cn, res, out, expr.type)
        return out
    # DEREFERENCE, ROW_CONSTRUCTOR and BIND: the reference raises too
    raise NotImplementedError(f"special form {form}")


def _select(take_a: torch.Tensor, a: Block, b: Block, ty: T.Type) -> Block:
    """Lane-select between two blocks of the same logical type."""
    if isinstance(a, Int128Column) or isinstance(b, Int128Column):
        # mixed representations happen (a long-decimal branch vs an
        # int64-lane literal of the same type): widen both to 128
        ah, al = F._as128(a)
        bh, bl = F._as128(b)
        return Int128Column(torch.where(take_a, ah, bh),
                            torch.where(take_a, al, bl),
                            torch.where(take_a, a.nulls, b.nulls), ty)
    if isinstance(a, StringColumn) or isinstance(b, StringColumn):
        w = max(a.max_len, b.max_len)
        ca, cb = pad_chars(a, w).chars, pad_chars(b, w).chars
        return StringColumn(torch.where(take_a[:, None], ca, cb),
                            torch.where(take_a, a.lengths, b.lengths),
                            torch.where(take_a, a.nulls, b.nulls), ty)
    av, bv = a.values, b.values
    if av.dtype != bv.dtype:
        dt = torch.promote_types(av.dtype, bv.dtype)
        av, bv = av.to(dt), bv.to(dt)
    return Column(torch.where(take_a, av, bv),
                  torch.where(take_a, a.nulls, b.nulls), ty)


def compile_filter(expr: RowExpression) -> Callable[[Batch], Batch]:
    """Rows failing the predicate (FALSE or NULL) become inactive; the
    selection stays a mask, no compaction."""
    def run(batch: Batch) -> Batch:
        out = evaluate(expr, batch)
        return batch.with_active(batch.active & out.values & ~out.nulls)
    return run


def compile_projections(exprs: Sequence[RowExpression]
                        ) -> Callable[[Batch], Batch]:
    """Each expression becomes an output column; the mask rides along."""
    def run(batch: Batch) -> Batch:
        return Batch(tuple(evaluate(e, batch) for e in exprs), batch.active)
    return run
