"""Concurrent-query batching: queries that differ only in literals, run
as one batch.

Counterpart of presto_tpu/exec/batching.py, every function of its
`__all__`: dashboards and point lookups send many small statements of a
few plan shapes, and each statement stages its scans and dispatches its
plan alone. Batching shares that cost among the queries of one shape.

  * Parameterization (`parameterize_plan`): a prepared plan's Filter
    and Project expressions are rewritten bottom-up, every Constant in
    a value position (an argument of a comparison or of arithmetic, a
    BETWEEN bound, an IN member; fixed-width types other than long
    decimals) lifted into a `BatchParam(index)` leaf. The rewritten
    tree is the template, the lifted values the query's parameter
    vector. Literals the lowering reads as structure (LIKE patterns,
    date_add units, strings) stay in the template.
  * The batch key: (plan_fingerprint(template), kernel mode, sf, join
    capacity, device). Queries co-batch only on equal keys.
  * The formation window: the first arrival of a HOT fingerprint leads
    a forming batch and waits `batch_window_ms` for followers (or until
    `batch_max_size`); while `max_inflight` batches of its key run it
    keeps collecting, up to `max_form_s`. Cold fingerprints never wait.
    Hotness is the fingerprint's recent submissions in this process
    plus its records in the query-history archive
    (server/history.py::batch_fingerprint_count), so a dashboard is hot
    from its first poll after a restart.
  * The batched dispatch. The reference traces the template once and
    runs `jax.jit(jax.vmap(...))` over the parameter axis. The port
    lowers a plan to Python closures (exec/planner.py), which hold no
    program to vmap, and its group-by scatters into unbatched buffers,
    so the port's dispatch is this: the template's scans are staged
    once for the batch (replayed from the staged cache while every
    leaf's connector reports the same `data_version`); the stacked
    parameters are copied to the device in one copy each, a [P, B]
    values tensor (int64; a floating value as its float64's bit
    pattern) and a [P, B] nulls tensor, B padded to a power of two; the
    cached template closure (exec/plan_cache.py) runs once for each
    real member, back to back on one stream under the entry's lock,
    each run binding its own column of the parameters
    (expr/compile.py::bound_params) with no host read between members
    (padded columns run nothing); each member's capacity flags and
    active-row count are reduced on the device and all B are read in
    ONE sync; the members' active rows are gathered on the device one
    member after another (a member's output has its plan's capacity,
    150,000 rows for a lookup on SF1 customer, of which one is active)
    and fetched to the host once, one copy per tensor of the output
    batch, then fanned out by each member's count. The host syncs of a
    batch do not grow with B. Every member's rows are bit-identical to
    its serial run.
  * Collapse: an overflow flag, the `dispatcher.batch_collapse`
    failpoint or an error of the batched dispatch runs every member
    through the serial `run_query` (counted per reason on
    presto_tpu_batch_collapses_total, one flight event each; an error
    also goes to record_suppressed): batching is a fast path, never a
    dependency of a result.

The executor runs on its caller's device, CUDA unless the caller names
another, and raises where there is none; it never carries on on the CPU
for a CUDA caller. Gating: the session property `query_batching`, the
process default from PRESTO_TPU_BATCHING (on), one of
exec/plan_cache.py's KERNEL_MODE_ENVS.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import types as T
from ..block import Batch, RowColumn, decoded
from ..expr import ir as E
from ..plan import nodes as N
from ..utils.locks import OrderedLock

__all__ = ["BATCHING_ENV", "batching_enabled", "parameterize_plan",
           "BatchingExecutor", "get_batching_executor",
           "set_batching_executor", "batching_totals",
           "batching_snapshot", "batch_size_of", "template_fp_of",
           "clear_batching"]

BATCHING_ENV = "PRESTO_TPU_BATCHING"

# literals masked for the hotness gate before planning: numbers and
# quoted strings collapse to "?", so the members of a parameterized
# family share one text shape without being planned
_SHAPE_RE = re.compile(r"'[^']*'|\b\d+(?:\.\d+)?\b")

# collapse reasons, each with a series from the first scrape on
COLLAPSE_REASONS = ("failpoint", "overflow", "error")


def batching_enabled(session) -> bool:
    """Session property `query_batching`; the process default from
    PRESTO_TPU_BATCHING (on). Both parse as the registry's bools, so
    'off', 'False' and 'no' turn it off as '0' does."""
    import os
    from ..utils.config import _parse_bool, session_flag
    env_on = _parse_bool(os.environ.get(BATCHING_ENV, "1"))
    return session_flag(session, "query_batching", env_on)


# ---------------------------------------------------------------------------
# plan parameterization
# ---------------------------------------------------------------------------

# calls whose Constant arguments are pure values, read lane by lane: a
# BatchParam stands in for them exactly. Every other call keeps its
# Constants in the template.
_SAFE_CALLS = frozenset({"eq", "ne", "lt", "le", "gt", "ge",
                         "add", "subtract", "multiply", "divide",
                         "modulus"})


def _parameterizable_type(ty: T.Type) -> bool:
    """Fixed-width scalar types, whose literal block is one value of
    the type's dtype broadcast: what a parameter reproduces. Strings
    and long decimals stay literal."""
    if ty.is_string or ty == T.UNKNOWN:
        return False
    if ty.base in ("array", "map", "row"):
        return False
    if ty.is_decimal and not ty.is_short_decimal:
        return False
    try:
        return ty.is_fixed_width
    except Exception:  # noqa: BLE001 - an exotic logical type
        return False


def _normalize_param(c: E.Constant) -> Tuple[object, bool]:
    """Constant -> (host value, is_null), converted as
    expr/compile.py converts a literal (a date spelled as a string
    becomes epoch days), so the parameter stages the literal's value."""
    if c.value is None:
        return (False if c.type.base == "boolean" else 0), True
    v = c.value
    if c.type.base == "date" and isinstance(v, str):
        v = int((np.datetime64(v)
                 - np.datetime64("1970-01-01")).astype(int))
    if c.type.base == "boolean":
        v = bool(v)
    return v, False


def _null_hint(args) -> Optional[T.Type]:
    """The type an untyped NULL literal (`x = NULL` plans a Constant of
    UNKNOWN type) is lifted at: its first typed sibling's. `x = NULL`
    then shares a template with `x = 42` and evaluates to the same
    all-NULL comparison."""
    for a in args:
        if a.type != T.UNKNOWN:
            return a.type
    return None


def _extract_expr(expr: E.RowExpression, params: List, liftable: bool,
                  hint: Optional[T.Type] = None) -> E.RowExpression:
    """One expression tree with its value-position Constants lifted
    into BatchParam leaves, in preorder."""
    if isinstance(expr, E.Constant):
        ty = expr.type
        if ty == T.UNKNOWN and expr.value is None and hint is not None:
            ty = hint
        if liftable and _parameterizable_type(ty):
            idx = len(params)
            params.append((_normalize_param(E.Constant(ty, expr.value)), ty))
            return E.BatchParam(ty, idx)
        return expr
    if isinstance(expr, E.Call):
        ok = expr.name.lower() in _SAFE_CALLS
        h = _null_hint(expr.arguments) if ok else None
        args = tuple(_extract_expr(a, params, ok, hint=h)
                     for a in expr.arguments)
        if all(a is b for a, b in zip(args, expr.arguments)):
            return expr
        return E.Call(expr.type, expr.name, args)
    if isinstance(expr, E.SpecialForm):
        if expr.form in ("BETWEEN", "IN"):
            # the probed value recurses as any argument; the bounds and
            # the members are values
            h = _null_hint(expr.arguments)
            args = tuple([_extract_expr(expr.arguments[0], params, False)]
                         + [_extract_expr(a, params, True, hint=h)
                            for a in expr.arguments[1:]])
        else:
            args = tuple(_extract_expr(a, params, False)
                         for a in expr.arguments)
        if all(a is b for a, b in zip(args, expr.arguments)):
            return expr
        return E.SpecialForm(expr.type, expr.form, args)
    # lambdas and their variables stay as they are
    return expr


def parameterize_plan(root: N.PlanNode
                      ) -> Tuple[N.PlanNode, List[Tuple[Tuple, T.Type]]]:
    """Prepared plan -> (template plan, parameter vector). The template
    shares every node the rewrite left alone (the scan leaves keep
    their lanes and identity); the parameters are ((value, is_null),
    type) in preorder of the expressions, so two plannings of one
    statement shape lift in one order. A plan with no liftable literal
    gives (root, []).

    A subtree the plan shares (one node id under two parents, as
    plan/nodes.py::from_json reads a repeated id) is rewritten at each
    appearance, lifting its literals again, as the reference lifts
    them in the copies its plan holds there: the template and its
    parameters are then the reference's. Such copies get ids of their
    own (`id.k`, from_json's rule for a repeated id with other
    content), since compile_plan runs one node per id."""
    params: List[Tuple[Tuple, T.Type]] = []
    unchanged: Dict[int, N.PlanNode] = {}
    copied = [False]
    seen: set = set()

    def walk(n: N.PlanNode) -> N.PlanNode:
        if id(n) in unchanged:
            return n
        if id(n) in seen:
            copied[0] = True
        seen.add(id(n))
        new_sources = [walk(s) for s in n.sources]
        src_changed = any(a is not b
                          for a, b in zip(new_sources, n.sources))
        if isinstance(n, N.FilterNode):
            pred = _extract_expr(n.predicate, params, False)
            if pred is not n.predicate or src_changed:
                out = dataclasses.replace(n, source=new_sources[0],
                                          predicate=pred)
            else:
                out = n
        elif isinstance(n, N.ProjectNode):
            exprs = [_extract_expr(e, params, False)
                     for e in n.expressions]
            if src_changed or any(a is not b for a, b
                                  in zip(exprs, n.expressions)):
                out = dataclasses.replace(n, source=new_sources[0],
                                          expressions=exprs)
            else:
                out = n
        elif src_changed:
            from ..plan.rules import _replace_sources
            out = _replace_sources(n, new_sources)
        else:
            out = n
        if out is n:
            unchanged[id(n)] = n
        return out

    template = walk(root)
    if copied[0]:
        template = N.from_json(N.to_json(template))
    return template, params


# ---------------------------------------------------------------------------
# process totals (server/metrics.py::batching_families reads these)
# ---------------------------------------------------------------------------

_TOTALS_LOCK = OrderedLock("batching._TOTALS_LOCK")
_TOTALS = {"batches": 0, "batched_queries": 0, "last_batch_size": 0,
           "max_batch_size": 0, "solo_dispatches": 0}
_COLLAPSES = {r: 0 for r in COLLAPSE_REASONS}

# query id -> the size of the batch that served it (absent: unbatched);
# system.queries' batch_size column reads it. Bounded.
_QUERY_BATCH: "collections.OrderedDict[str, int]" = \
    collections.OrderedDict()
# query id -> its template fingerprint (batchable queries, batched or
# not); the history archive stores it on the query's record
_QUERY_TEMPLATE: "collections.OrderedDict[str, str]" = \
    collections.OrderedDict()
_QUERY_MAP_MAX = 1024


def _note_query(table: "collections.OrderedDict", query_id: str,
                value) -> None:
    with _TOTALS_LOCK:
        table[query_id] = value
        table.move_to_end(query_id)
        while len(table) > _QUERY_MAP_MAX:
            table.popitem(last=False)


def batch_size_of(query_id: str) -> int:
    with _TOTALS_LOCK:
        return _QUERY_BATCH.get(query_id, 0)


def template_fp_of(query_id: str) -> Optional[str]:
    with _TOTALS_LOCK:
        return _QUERY_TEMPLATE.get(query_id)


def batching_totals() -> dict:
    with _TOTALS_LOCK:
        out = dict(_TOTALS)
        out["collapses"] = dict(_COLLAPSES)
        return out


def reset_batching_totals() -> None:
    """Zero the process counters, keeping the executor and its warm
    caches (phase boundaries that read deltas)."""
    with _TOTALS_LOCK:
        for k in _TOTALS:
            _TOTALS[k] = 0
        for k in _COLLAPSES:
            _COLLAPSES[k] = 0
        _QUERY_BATCH.clear()
        _QUERY_TEMPLATE.clear()


def clear_batching() -> None:
    """Zero the process counters and drop the executor."""
    global _EXECUTOR
    reset_batching_totals()
    with _EXEC_LOCK:
        _EXECUTOR = None


# ---------------------------------------------------------------------------
# the batched output: the members' active rows, gathered on the device
# one member after another and fetched once
# ---------------------------------------------------------------------------


def _cat(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The members' row tensors one after another, each zero-padded to
    the widest trailing shape (a wider string lane: the padded bytes lie
    past each string's length)."""
    tail = [max(t.shape[d] for t in tensors)
            for d in range(1, tensors[0].dim())]
    padded = []
    for t in tensors:
        if list(t.shape[1:]) != tail:
            z = t.new_zeros([t.shape[0], *tail])
            z[tuple(slice(0, s) for s in t.shape)] = t
            t = z
        padded.append(t)
    return torch.cat(padded)


def _gather_blocks(blocks: List, rows: List[torch.Tensor]):
    blocks = [decoded(b) for b in blocks]
    b0 = blocks[0]
    if isinstance(b0, RowColumn):
        return RowColumn(tuple(_gather_blocks([b.fields[k] for b in blocks],
                                              rows)
                               for k in range(len(b0.fields))),
                         _cat([b.nulls.index_select(0, r)
                               for b, r in zip(blocks, rows)]), b0.type)
    return dataclasses.replace(b0, **{
        f.name: _cat([getattr(b, f.name).index_select(0, r)
                      for b, r in zip(blocks, rows)])
        for f in dataclasses.fields(b0) if f.name != "type"})


def _gather_active(outs: List[Batch], counts: List[int]) -> Batch:
    """One batch of every member's active rows in row order, member
    after member (`counts[i]` of member i, read on the host already), so
    that nothing is synchronized here: a stable sort of each active mask
    puts its rows first."""
    act = torch.stack([o.active for o in outs])
    order = torch.argsort((~act).to(torch.uint8), dim=1, stable=True)
    rows = [order[i, :c] for i, c in enumerate(counts)]
    return Batch(tuple(_gather_blocks([o.columns[c] for o in outs], rows)
                       for c in range(outs[0].num_columns)),
                 torch.ones(sum(counts), dtype=torch.bool,
                            device=act.device))


def _map_tensors(b: Batch, fn) -> Batch:
    from ..parallel.exchange import map_block
    return Batch(tuple(map_block(c, fn) for c in b.columns), fn(b.active))


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------


class _Pending:
    """One member of a forming batch."""
    __slots__ = ("values", "root", "session", "query_id", "trace_id",
                 "event", "result", "error")

    def __init__(self, values, root, session, query_id, trace_id):
        self.values = values          # [(value, is_null), ...]
        self.root = root              # this query's own prepared plan
        self.session = session
        self.query_id = query_id
        self.trace_id = trace_id
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _Forming:
    """A batch being collected for one key (its leader waits)."""
    __slots__ = ("key", "entries", "sealed", "full")

    def __init__(self, key):
        self.key = key
        self.entries: List[_Pending] = []
        self.sealed = False
        self.full = threading.Event()


@dataclasses.dataclass
class _Template:
    """What a batch key compiles and runs: the template plan, its
    parameters' types, and once lowered its CompiledPlan and the plan
    cache entry's dispatch lock."""
    template: N.PlanNode
    types: List[T.Type]
    plan: object = None
    lock: object = None


class BatchingExecutor:
    """The process-wide batching executor of the statement dispatch
    path. `try_execute` returns a QueryResult when a formed batch served
    the query (as its leader or a follower), or None where the caller
    runs the serial path (not batchable, batching off, no batch
    formed). Thread-safe: the statement threads are its callers.

    `last_dispatch` holds the last batched dispatch's accounting: its
    size, the scans it staged (0 on a staged-cache hit) and the host
    walls in ms of its staging, execute (the parameter copies, the
    members' runs and the one flag read) and fetch."""

    def __init__(self, window_ms: float = 5.0, max_batch: int = 64,
                 hot_min: int = 2, hot_window_s: float = 30.0,
                 follower_timeout_s: float = 300.0,
                 max_form_s: float = 1.0, max_inflight: int = 8):
        self.window_ms = window_ms
        self.max_batch = max_batch
        self.hot_min = hot_min
        self.hot_window_s = hot_window_s
        self.follower_timeout_s = follower_timeout_s
        # the longest a leader keeps collecting behind running batches
        self.max_form_s = max_form_s
        # batches of one key allowed to run at once: while that many
        # run, a forming batch keeps collecting (occupancy adapts to
        # the load; the window bounds only the idle case)
        self.max_inflight = max_inflight
        self._lock = OrderedLock("batching.BatchingExecutor._lock")
        self._forming: Dict[tuple, _Forming] = {}
        self._inflight: Dict[tuple, int] = {}
        # fingerprint -> recent submission times (hotness)
        self._recent: "collections.OrderedDict[str, collections.deque]" \
            = collections.OrderedDict()
        # masked text shape -> recent submissions: the gate before
        # planning (a one-off statement pays one regex, not a planning)
        self._shape_recent: \
            "collections.OrderedDict[str, collections.deque]" = \
            collections.OrderedDict()
        # batch key -> its template and lowered closure
        self._templates: "collections.OrderedDict[tuple, _Template]" = \
            collections.OrderedDict()
        self._templates_max = 64
        # (batch key, data versions) -> the staged scan batches
        self._staged: "collections.OrderedDict[tuple, list]" = \
            collections.OrderedDict()
        self._staged_max = 16
        # exact statement text -> (prepared, template, values, key):
        # hot literals repeat verbatim, so the planning is paid once a
        # distinct text
        self._plan_memo: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        self._plan_memo_max = 2048
        # scan batches staged in all (staged-cache hits stage none)
        self.scans_staged = 0
        self.last_dispatch: Dict[str, float] = {}

    # -- knobs read per query ------------------------------------------

    def _window_s(self, session) -> float:
        from ..utils.config import session_value
        return float(session_value(session, "batch_window_ms",
                                   self.window_ms) or 0.0) / 1e3

    def _max_batch(self, session) -> int:
        from ..utils.config import session_value
        return max(int(session_value(session, "batch_max_size",
                                     self.max_batch)), 1)

    def _hot_min(self, session) -> int:
        from ..utils.config import session_value
        return int(session_value(session, "batch_hot_min", self.hot_min))

    # -- hotness -------------------------------------------------------

    def _note_window(self, table, key: str) -> int:
        """One event for `key` in a bounded sliding-window table; the
        recent count, this event included."""
        now = time.time()
        cutoff = now - self.hot_window_s
        with self._lock:
            q = table.get(key)
            if q is None:
                q = table[key] = collections.deque(maxlen=4096)
                while len(table) > 512:
                    table.popitem(last=False)
            else:
                table.move_to_end(key)
            q.append(now)
            while q and q[0] < cutoff:
                q.popleft()
            return len(q)

    def _hot(self, fp: str, session) -> bool:
        """Whether this fingerprint earns a formation window: its recent
        submissions in this process, plus its records in the history
        archive."""
        hot_min = self._hot_min(session)
        n = self._note_window(self._recent, fp)
        if hot_min <= 1 or n >= hot_min:
            return True
        try:
            from ..server.history import get_history_archive
            n += get_history_archive().batch_fingerprint_count(fp)
        except Exception as e:  # noqa: BLE001 - the archive is telemetry:
            # hotness falls back to this process's counts
            from ..server.metrics import record_suppressed
            record_suppressed("batching", "history_hotness", e)
        return n >= hot_min

    # -- the batch key -------------------------------------------------

    @staticmethod
    def _batch_key(template_fp: str, sf: float, join_capacity: int,
                   device=None) -> tuple:
        """(fingerprint, kernel mode, sf, join capacity, device): the
        identity the plan cache and the profiler key on, plus what
        selects the staged data and where it lives."""
        from .plan_cache import _kernel_mode
        return (template_fp, _kernel_mode(), float(sf), int(join_capacity),
                None if device is None else str(device))

    # -- the public seam -----------------------------------------------

    def try_execute(self, text: str, *, sf: float, session: Dict,
                    query_id: str, trace_id=None,
                    max_groups: Optional[int] = None,
                    join_capacity: Optional[int] = None,
                    catalog: Optional[str] = None, device=None):
        """Plan `text` and, where it is batchable and a batch forms, run
        it batched on `device` and return this query's QueryResult;
        None wherever the serial path should run instead."""
        if not batching_enabled(session):
            return None
        from ..block import resolve_device
        dev = resolve_device(device)
        hot_min = self._hot_min(session)
        if hot_min > 1 and \
                self._note_window(self._shape_recent,
                                  _SHAPE_RE.sub("?", text)) < hot_min:
            return None  # a cold text shape: not worth a planning
        try:
            prepared, template, values, key = self._prepare(
                text, sf=sf, session=session, max_groups=max_groups,
                join_capacity=join_capacity, catalog=catalog, device=dev)
        except Exception:  # noqa: BLE001 - unparseable or unsupported
            # SQL: the serial path owns producing the real error
            return None
        if template is None:
            return None
        _note_query(_QUERY_TEMPLATE, query_id, key[0])
        entry = _Pending(values, prepared, session, query_id, trace_id)
        hot = self._hot(key[0], session)
        window_s = self._window_s(session)
        max_batch = self._max_batch(session)

        with self._lock:
            g = self._forming.get(key)
            if g is not None and not g.sealed \
                    and len(g.entries) < max_batch:
                g.entries.append(entry)
                if len(g.entries) >= max_batch:
                    g.full.set()
                leader = False
            elif hot and window_s > 0:
                g = _Forming(key)
                g.entries.append(entry)
                self._forming[key] = g
                leader = True
            else:
                return None  # cold fingerprint: never pay the window

        if not leader:
            if not entry.event.wait(self.follower_timeout_s):
                return None  # a wedged leader: run serially
            if entry.error is not None:
                raise entry.error
            return entry.result

        # the leader collects followers until the batch fills, or once
        # the window has passed until its key has a free dispatch slot
        # (max_form_s bounds the wait)
        t_form = time.time()
        while True:
            g.full.wait(window_s)
            with self._lock:
                if len(g.entries) >= max_batch:
                    break
                elapsed = time.time() - t_form
                if elapsed >= window_s and \
                        self._inflight.get(key, 0) < self.max_inflight:
                    break
                if elapsed >= self.max_form_s:
                    break
        with self._lock:
            g.sealed = True
            if self._forming.get(key) is g:
                del self._forming[key]
            entries = list(g.entries)
            counted_inflight = len(entries) > 1
            if counted_inflight:
                self._inflight[key] = self._inflight.get(key, 0) + 1
        if len(entries) == 1:
            # no batch formed: a template already lowered (by a batch or
            # precompile) serves it as a batch of one; none is lowered
            # for a lone query, which the serial path owns
            with self._lock:
                have = self._templates.get(key)
                if have is None or have.plan is None:
                    return None
        try:
            self._execute_batch(key, entries, sf=sf, join_capacity=key[3],
                                device=dev)
        except BaseException as e:  # noqa: BLE001 - every waiting member
            # must wake, whatever broke
            for m in entries:
                if m.result is None and m.error is None:
                    m.error = e
        finally:
            if counted_inflight:
                with self._lock:
                    n = self._inflight.get(key, 0) - 1
                    if n > 0:
                        self._inflight[key] = n
                    else:
                        self._inflight.pop(key, None)
            for m in entries:
                m.event.set()
        if entry.error is not None:
            raise entry.error
        return entry.result

    def precompile(self, text: str, *, sf: float,
                   session: Optional[Dict] = None,
                   sizes: Optional[List[int]] = None,
                   join_capacity: Optional[int] = None,
                   catalog: Optional[str] = None, device=None) -> int:
        """Warm `text`'s template before a measured phase: lower it
        through the plan cache, stage its scans into the staged cache
        and run one member, which builds the kernels it launches. One
        closure serves every batch size in the port, so this warms all
        of the reference's power-of-two buckets (2 up to batch_max_size,
        or `sizes`) at once; returns their count (0: not batchable)."""
        from ..block import resolve_device
        sess = dict(session or {})
        dev = resolve_device(device)
        try:
            _prepared, template, values, key = self._prepare(
                text, sf=sf, session=sess, max_groups=None,
                join_capacity=join_capacity, catalog=catalog, device=dev)
        except Exception:  # noqa: BLE001 - unbatchable text: nothing
            return 0       # to warm
        if template is None:
            return 0
        tpl = self._compiled(key, key[3])
        batches = self._stage_inputs(key, tpl.plan, sf, dev)
        stub = _Pending(values, None, sess, "warm", None)
        self._dispatch(key, tpl, batches, [stub], dev)
        if sizes is None:
            sizes, s = [], 2
            while s <= self._max_batch(sess):
                sizes.append(s)
                s *= 2
        return len(sizes)

    def bench_dispatch(self, texts: List[str], *, sf: float,
                       session: Optional[Dict] = None, device=None):
        """Run co-batchable `texts` as ONE batched dispatch with no
        formation window and return their QueryResults in order: the
        dispatch path alone (benchmarks and white-box tests). Raises
        ValueError where the texts do not share a batch key."""
        from ..block import resolve_device
        sess = dict(session or {})
        dev = resolve_device(device)
        entries: List[_Pending] = []
        key0 = None
        for i, text in enumerate(texts):
            prepared, template, values, key = self._prepare(
                text, sf=sf, session=sess, max_groups=None,
                join_capacity=None, catalog=None, device=dev)
            if template is None:
                raise ValueError(f"not batchable: {text!r}")
            if key0 is None:
                key0 = key
            elif key != key0:
                raise ValueError("texts do not share a batch key")
            entries.append(_Pending(values, prepared, sess,
                                    f"bench-{i}", None))
        self._execute_batch(key0, entries, sf=sf, join_capacity=key0[3],
                            device=dev)
        for m in entries:
            if m.error is not None:
                raise m.error
        return [m.result for m in entries]

    def _prepare(self, text: str, *, sf: float, session: Dict,
                 max_groups: Optional[int], join_capacity: Optional[int],
                 catalog: Optional[str], device=None):
        """Plan, prepare and parameterize one statement, memoized by its
        exact text: (prepared plan, template or None, parameter values,
        batch key)."""
        from .plan_cache import _kernel_mode
        # the plan-shaping session properties key the memo too: two
        # sessions that shape plans apart must not share one
        sess_bits = tuple(
            (k, str((session or {}).get(k)))
            for k in ("iterative_optimizer", "join_reordering_strategy",
                      "stats_capacity_refinement",
                      "narrow_width_execution")
            if (session or {}).get(k) is not None)
        memo_key = (text, float(sf), max_groups, join_capacity, catalog,
                    _kernel_mode(), sess_bits,
                    None if device is None else str(device))
        with self._lock:
            hit = self._plan_memo.get(memo_key)
            if hit is not None:
                self._plan_memo.move_to_end(memo_key)
                return hit
        out = self._prepare_uncached(text, sf=sf, session=session,
                                     max_groups=max_groups,
                                     join_capacity=join_capacity,
                                     catalog=catalog, device=device)
        with self._lock:
            self._plan_memo[memo_key] = out
            self._plan_memo.move_to_end(memo_key)
            while len(self._plan_memo) > self._plan_memo_max:
                self._plan_memo.popitem(last=False)
        return out

    def _prepare_uncached(self, text: str, *, sf: float, session: Dict,
                          max_groups: Optional[int],
                          join_capacity: Optional[int],
                          catalog: Optional[str], device=None):
        from ..sql import plan_sql
        from .plan_cache import plan_fingerprint
        from .runner import prepare_plan
        kw = {}
        if max_groups is not None:
            kw["max_groups"] = int(max_groups)
        root = plan_sql(text, join_capacity=join_capacity,
                        catalog=catalog, **kw)
        inner = root.source if isinstance(root, N.OutputNode) else root
        if isinstance(inner, N.WRITE_ROOTS):
            return None, None, None, None
        # the members share the staged scans, so nothing may stage
        # different rows for different literals: scan predicate
        # pushdown and dynamic filters stay off (they only prune; the
        # Filter above applies either way)
        bsession = dict(session or {})
        bsession["scan_predicate_pushdown"] = False
        bsession["dynamic_filtering"] = False
        prepared = prepare_plan(root, sf=sf, mesh=None, session=bsession)
        template, params = parameterize_plan(prepared)
        values = [v for v, _ty in params]
        cap = join_capacity if join_capacity is not None else 1 << 16
        key = self._batch_key(plan_fingerprint(template), sf, cap, device)
        with self._lock:
            if key not in self._templates:
                self._templates[key] = _Template(
                    template, [ty for _v, ty in params])
            self._templates.move_to_end(key)
            while len(self._templates) > self._templates_max:
                self._templates.popitem(last=False)
        return prepared, template, values, key

    def _compiled(self, key, join_capacity: int) -> _Template:
        """The key's template lowered through the shared plan cache (so
        hits and misses count as a serial repeat's would)."""
        with self._lock:
            tpl = self._templates.get(key)
        if tpl is None:  # evicted between prepare and dispatch
            raise RuntimeError("batch template evicted before compile")
        if tpl.plan is None:
            from .plan_cache import cached_compile
            plan, lock, _hit = cached_compile(tpl.template, None,
                                              join_capacity)
            with self._lock:
                if tpl.plan is None:
                    tpl.plan, tpl.lock = plan, lock
        return tpl

    # -- the batched dispatch ------------------------------------------

    def _execute_batch(self, key, entries: List[_Pending], *, sf: float,
                       join_capacity: int, device) -> None:
        """Run one formed batch and fan its rows out to every member; an
        overflow flag, an injected collapse or an error of the batched
        dispatch runs the members serially instead."""
        from .. import failpoints
        from ..server.flight_recorder import record_event
        t0 = time.time()
        nbatch = len(entries)
        if failpoints.ARMED:
            try:
                # a formed batch forced back to serial dispatch: every
                # member must still match its serial rows
                failpoints.hit("dispatcher.batch_collapse")
            except Exception:  # noqa: BLE001 - any injected error class
                record_event("batch_collapse", reason="failpoint",
                             size=nbatch, query_id=entries[0].query_id)
                self._serial_fallback(entries, sf, "failpoint", device)
                return
        try:
            tpl = self._compiled(key, join_capacity)
            # one progress entry for the dispatch (the leader's)
            from .progress import begin as progress_begin
            prog = progress_begin(entries[0].query_id)
            try:
                prog.advance(stage="staging")
                t_stage = time.perf_counter()
                staged0 = self.scans_staged
                batches = self._stage_inputs(key, tpl.plan, sf, device)
                stage_ms = (time.perf_counter() - t_stage) * 1e3
                prog.advance(stage="execute")
                host, overflow, walls = self._dispatch(key, tpl, batches,
                                                       entries, device)
            finally:
                prog.release(state="FINISHED")
            if overflow:
                # a member overflowed a static capacity: the serial
                # ladder owns the reruns; the whole batch collapses
                record_event("batch_collapse", reason="overflow",
                             size=nbatch, query_id=entries[0].query_id)
                self._serial_fallback(entries, sf, "overflow", device)
                return
        except Exception as e:  # noqa: BLE001 - a corner of the batched
            # dispatch that the serial path handles must not fail the
            # members; it is counted and recorded, never hidden
            from ..server.metrics import record_suppressed
            record_suppressed("batching", "batched_dispatch", e)
            record_event("batch_collapse", reason="error", size=nbatch,
                         query_id=entries[0].query_id,
                         error=f"{type(e).__name__}: {e}"[:200])
            self._serial_fallback(entries, sf, "error", device)
            return
        device_us = int((time.time() - t0) * 1e6)
        self.last_dispatch = {"size": nbatch, "stage_ms": stage_ms,
                              "scans_staged": self.scans_staged - staged0,
                              **walls}
        self._fan_out(host, tpl.template, entries, device_us)
        self._account(key, entries, device_us)

    def _stage_inputs(self, key, plan, sf: float, device) -> list:
        """The template's scan batches on `device`, replayed from the
        staged cache while every leaf's connector proves its data
        unchanged (`data_version`; a connector without one stages
        afresh every batch)."""
        versions: Optional[list] = []
        for s in plan.scan_nodes:
            if isinstance(s, N.ValuesNode):
                versions.append(("values",))  # part of the fingerprint
                continue
            if not isinstance(s, N.TableScanNode):
                versions = None
                break
            from ..connectors import catalog
            fn = getattr(catalog(s.connector), "data_version", None)
            if fn is None:
                versions = None
                break
            versions.append((s.connector, s.table, fn(s.table)))
        ckey = (key, tuple(versions), str(device)) \
            if versions is not None else None
        if ckey is not None:
            with self._lock:
                hit = self._staged.get(ckey)
                if hit is not None:
                    self._staged.move_to_end(ckey)
                    return hit
        from .runner import _scan_batch
        batches = [_scan_batch(s, sf, device) for s in plan.scan_nodes]
        with self._lock:
            self.scans_staged += len(batches)
        if ckey is not None:
            with self._lock:
                self._staged[ckey] = batches
                self._staged.move_to_end(ckey)
                while len(self._staged) > self._staged_max:
                    self._staged.popitem(last=False)
        return batches

    def _stack_params(self, entries: List[_Pending],
                      types: List[T.Type]) -> Tuple[np.ndarray, np.ndarray]:
        """The members' parameter vectors as [P, B] int64 values (a
        floating value as its float64's bit pattern) and [P, B] nulls,
        B padded to a power of two (at least 2) with copies of member
        0, as the reference pads its buckets. A parameterless batch
        (identical literal-free statements) gets one zero row."""
        nbatch = len(entries)
        padded = 2
        while padded < nbatch:
            padded *= 2
        nparams = max(len(types), 1)
        vals = np.zeros((nparams, padded), dtype=np.int64)
        nulls = np.zeros((nparams, padded), dtype=bool)
        for pi, ty in enumerate(types):
            floating = np.dtype(ty.to_dtype()).kind == "f"
            for b in range(padded):
                v, null = entries[b if b < nbatch else 0].values[pi]
                if floating:
                    vals[pi, b] = np.float64(v).view(np.int64)
                else:
                    vals[pi, b] = int(v)
                nulls[pi, b] = bool(null)
        return vals, nulls

    def _dispatch(self, key, tpl: _Template, batches: list,
                  entries: List[_Pending], device):
        """Run the template once per real member over the shared staged
        batches; returns ((the members' active rows on the host, each
        member's count), whether any member overflowed, {execute_ms,
        fetch_ms}). The host syncs: the two parameter copies, one read
        of all B flags and counts, one copy per tensor of the output."""
        from ..expr.compile import bound_params, shared_constants
        t0 = time.perf_counter()
        vals_np, nulls_np = self._stack_params(entries, tpl.types)
        vals = torch.from_numpy(vals_np).to(device)
        nulls = torch.from_numpy(nulls_np).to(device)
        nparams = len(tpl.types)
        outs, flags, counts = [], [], []
        with tpl.lock, shared_constants():
            for b in range(len(entries)):
                with bound_params([(vals[i, b], nulls[i, b])
                                   for i in range(nparams)]):
                    out, f = tpl.plan.fn(batches)
                outs.append(out)
                flags.append(f.any().to(torch.int64))
                counts.append(out.active.sum())
            # every member's overflow flag and active-row count: one read
            read = torch.stack([torch.stack(flags),
                                torch.stack(counts)]).tolist()
        overflow, counts = any(read[0]), read[1]
        t1 = time.perf_counter()
        host = None
        if not overflow:
            host = _map_tensors(_gather_active(outs, counts),
                                lambda t: t.cpu())
        walls = {"execute_ms": (t1 - t0) * 1e3,
                 "fetch_ms": (time.perf_counter() - t1) * 1e3}
        return (host, counts), overflow, walls

    def _fan_out(self, fetched, template: N.PlanNode,
                 entries: List[_Pending], device_us: int) -> None:
        """Member i takes its own rows of the fetched batch (its count of
        them, after the members before it); its result is built from
        them as the serial fetch builds it from its active rows."""
        from .runner import _batch_to_result
        from .stats import QueryStats
        host, counts = fetched
        nbatch = len(entries)
        start = 0
        for i, m in enumerate(entries):
            lo, start = start, start + counts[i]
            res = _batch_to_result(
                _map_tensors(host, lambda t, lo=lo, hi=start: t[lo:hi]),
                template)
            qs = QueryStats()
            qs.wall_us = device_us
            qs.output_rows = res.row_count
            qs.counters["batched_queries"] = 1
            qs.counters["batch_size"] = nbatch
            res.query_stats = qs
            res.stats = {"batch_size": nbatch, "batch_device_us": device_us}
            m.result = res
            _note_query(_QUERY_BATCH, m.query_id, nbatch)

    def _account(self, key, entries: List[_Pending], device_us: int) -> None:
        nbatch = len(entries)
        with _TOTALS_LOCK:
            if nbatch > 1:
                _TOTALS["batches"] += 1
                _TOTALS["batched_queries"] += nbatch
                _TOTALS["last_batch_size"] = nbatch
                _TOTALS["max_batch_size"] = max(
                    _TOTALS["max_batch_size"], nbatch)
            else:
                # a batch of one on a lowered template: counted apart,
                # so that occupancy keeps meaning co-batched
                _TOTALS["solo_dispatches"] += 1
        # the profiler folds the batch once under the template's
        # fingerprint, and links every member's query id to it
        from .profiler import note_query_kernel, record_call
        first = entries[0]
        tid = _trace_str(first.trace_id, first.query_id)
        record_call(key[0], label=f"batched[{nbatch}]", device_us=device_us,
                    rows_out=sum(m.result.row_count for m in entries
                                 if m.result),
                    query_id=first.query_id, trace_id=tid)
        note_query_kernel(key[0], [m.query_id for m in entries[1:]])
        if nbatch > 1:
            from ..server.metrics import observe_histogram
            observe_histogram("presto_tpu_batch_occupancy_queries",
                              float(nbatch), trace_id=tid)

    def _serial_fallback(self, entries: List[_Pending], sf: float,
                         reason: str, device) -> None:
        """A collapse: every member through the serial run_query on this
        thread, each result exactly the unbatched one; a member's error
        stays its own."""
        with _TOTALS_LOCK:
            _COLLAPSES[reason] = _COLLAPSES.get(reason, 0) + 1
        from .runner import run_query
        for m in entries:
            try:
                m.result = run_query(
                    m.root, sf=sf, device=device, session=m.session,
                    query_id=m.query_id, prepared=True,
                    trace_id=m.trace_id)
            except BaseException as e:  # noqa: BLE001 - delivered to the
                m.error = e             # member's waiting thread

    def snapshot(self) -> dict:
        """The live view of /v1/cluster: the forming queues and the
        process totals."""
        with self._lock:
            pending = [{"fingerprint": k[0][:12], "queued": len(g.entries)}
                       for k, g in self._forming.items()]
        t = batching_totals()
        avg = (t["batched_queries"] / t["batches"]) if t["batches"] \
            else 0.0
        return {"batchesDispatched": t["batches"],
                "queriesBatched": t["batched_queries"],
                "soloDispatches": t["solo_dispatches"],
                "collapses": t["collapses"],
                "lastBatchSize": t["last_batch_size"],
                "maxBatchSize": t["max_batch_size"],
                "avgOccupancy": round(avg, 2),
                "forming": pending}


def _trace_str(trace_id, query_id: str) -> str:
    from ..server.tracing import TraceContext
    if isinstance(trace_id, TraceContext):
        return trace_id.trace_id
    return str(trace_id or query_id)


_EXEC_LOCK = OrderedLock("batching._EXEC_LOCK")
_EXECUTOR: Optional[BatchingExecutor] = None


def get_batching_executor() -> BatchingExecutor:
    global _EXECUTOR
    with _EXEC_LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = BatchingExecutor()
        return _EXECUTOR


def set_batching_executor(executor: Optional[BatchingExecutor]) -> None:
    global _EXECUTOR
    with _EXEC_LOCK:
        _EXECUTOR = executor


def batching_snapshot() -> dict:
    return get_batching_executor().snapshot()
