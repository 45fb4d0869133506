"""EXPLAIN: textual plan rendering + EXPLAIN ANALYZE annotation.

Counterpart of presto_tpu/plan/explain.py (`explain`, `explain_analyze`,
`explain_distributed`): the same node lines with their `estRows`, and
for EXPLAIN ANALYZE the executed tree annotated from the collected
QueryStats, then the stages, counters, kernels, datapath, accuracy and
timeline sections.

EXPLAIN ANALYZE executes the SHAPED plan (exec/runner.py::prepare_plan,
the tree that lowers, exchanges included). Host-visible nodes (scans,
the output root) carry measured rows/bytes/wall micros; the interior
nodes run inside the plan's execution, whose per-operator device times
the ledgers do not separate, so they carry the planner's row estimate
and a `fused` marker, as in the reference.

There is no `-- regions --` tail and no `[region=...]` tag: the
reference cuts a plan into XLA programs (its exec/regions.py) and
reports how; the port lowers a plan to closures that launch their
kernels one by one, and forms no regions to report.
"""

from __future__ import annotations

from typing import List

from . import nodes as N
from .fragment import fragment_plan

__all__ = ["explain", "explain_analyze", "explain_distributed"]


def _node_line(n: N.PlanNode) -> str:
    if isinstance(n, N.TableScanNode):
        extra = ""
        if n.physical_dtypes:
            from .widths import widths_summary
            w = widths_summary(n)
            if w:
                extra = f" widths={{{w}}}"
        return (f"TableScan[{n.connector}.{n.table} "
                f"columns={n.columns}{extra}]")
    if isinstance(n, N.ValuesNode):
        return f"Values[{len(n.rows)} rows]"
    if isinstance(n, N.FilterNode):
        return f"Filter[{n.predicate}]"
    if isinstance(n, N.ProjectNode):
        exprs = ", ".join(str(e) for e in n.expressions)
        return f"Project[{exprs}]"
    if isinstance(n, N.AggregationNode):
        aggs = ", ".join(f"{a.name}({'*' if a.input_channel is None else f'ch{a.input_channel}'})"
                         for a in n.aggregates)
        return (f"Aggregate[{n.step} keys=ch{n.group_channels} {aggs} "
                f"maxGroups={n.max_groups}]")
    if isinstance(n, N.JoinNode):
        return (f"Join[{n.join_type.upper()} {n.distribution} "
                f"left{n.left_keys}=right{n.right_keys}]")
    if isinstance(n, N.SemiJoinNode):
        return f"SemiJoin[ch{n.source_key} IN filteringSource ch{n.filtering_key}]"
    if isinstance(n, N.SortNode):
        return f"Sort[{_keys(n.keys)}]"
    if isinstance(n, N.TopNNode):
        return f"TopN[{n.count} by {_keys(n.keys)}]"
    if isinstance(n, N.LimitNode):
        return f"Limit[{n.count}]"
    if isinstance(n, N.DistinctNode):
        return f"Distinct[keys={n.key_channels or 'all'}]"
    if isinstance(n, N.ExchangeNode):
        part = f" by ch{n.partition_channels}" if n.partition_channels else ""
        return f"{n.scope.title()}Exchange[{n.kind}{part}]"
    if isinstance(n, N.OutputNode):
        return f"Output[{n.names}]"
    return type(n).__name__


def _keys(keys) -> str:
    return ", ".join(f"ch{c} {'DESC' if d else 'ASC'}"
                     f"{' NULLS LAST' if nl else ' NULLS FIRST'}"
                     for c, d, nl in keys)


def explain(root: N.PlanNode, *, session=None, sf: float = 0.01,
            mesh=None, prepare: bool = False) -> str:
    """Single-plan tree rendering (EXPLAIN (TYPE LOGICAL) analog), each
    node with its planner row estimate. With ``prepare=True`` the plan
    is first shaped as execution shapes it (prepare_plan under
    `session`), which the statement tier's EXPLAIN does: the
    reference's ``explain(..., regions=True)`` shapes it the same way
    before it adds its region tags."""
    from ..exec.accuracy import est_rows_of
    if prepare and not _is_write_root(root):
        from ..exec.runner import prepare_plan
        root = prepare_plan(root, sf=sf, mesh=mesh, session=session)
    lines: List[str] = []

    def walk(n: N.PlanNode, depth: int):
        tag = ""
        # the stamped estimate on a prepared tree, else computed fresh:
        # one pure function of (node, sf) either way
        est = est_rows_of(n, sf)
        if est is not None:
            tag += f"  estRows={est:.0f}"
        lines.append("    " * depth + "- " + _node_line(n) + tag)
        for s in n.sources:
            walk(s, depth + 1)

    walk(root, 0)
    return "\n".join(lines)


def _is_write_root(root: N.PlanNode) -> bool:
    """Write/DDL roots run on the host; their inner SELECT is prepared
    when the writer re-enters run_query."""
    inner = root.source if isinstance(root, N.OutputNode) else root
    return isinstance(inner, N.WRITE_ROOTS)


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 30:
        return f"{n / (1 << 30):.2f}GB"
    if n >= 1 << 20:
        return f"{n / (1 << 20):.2f}MB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}KB"
    return f"{n}B"


def _annotated_tree(root: N.PlanNode, qs, sf: float) -> str:
    from ..exec.planner import scan_leaves
    from .stats import estimate_rows

    scan_index = {id(n): i for i, n in enumerate(scan_leaves(root))}
    ops = qs.operators if qs is not None else {}
    lines: List[str] = []
    seen = set()

    def annotate(n: N.PlanNode, is_root: bool) -> str:
        from ..exec.runner import _scan_key
        op = None
        if id(n) in scan_index:
            op = ops.get(_scan_key(scan_index[id(n)], n))
        elif is_root:
            op = ops.get("output")
        if op is not None:
            return (f"  [rows={op.output_rows} "
                    f"bytes={_fmt_bytes(op.output_bytes)} "
                    f"wall={op.wall_us}us"
                    + (f" tasks={op.task_count}" if op.task_count > 1
                       else "") + "]")
        if isinstance(n, N.ExchangeNode) and n.scope == "REMOTE":
            return "  [collective: fused into execute stage]"
        est = None
        try:
            est = estimate_rows(n, sf)
        except Exception:  # noqa: BLE001 - estimates are best-effort
            est = None
        if est is not None:
            return f"  [est. {int(est)} rows, fused]"
        return "  [fused]"

    def walk(n: N.PlanNode, depth: int, is_root: bool):
        line = "    " * depth + "- " + _node_line(n)
        if id(n) in seen:
            lines.append(line + "  [shared subtree]")
            return
        seen.add(id(n))
        lines.append(line + annotate(n, is_root))
        for s in n.sources:
            walk(s, depth + 1, False)

    walk(root, 0, True)
    return "\n".join(lines)


def explain_analyze(root: N.PlanNode, sf: float = 0.01, **kwargs) -> str:
    """EXPLAIN ANALYZE: shape the plan exactly as execution will
    (prepare_plan), run it (run_query's keyword arguments pass through:
    device, mesh, session, ...), and annotate the executed tree with
    the collected QueryStats, then the sections below it."""
    from ..exec.runner import prepare_plan, run_query

    session = dict(kwargs.pop("session", None) or {})
    mesh = kwargs.get("mesh")
    executed = prepare_plan(root, sf=sf, mesh=mesh, session=session)
    res = run_query(executed, sf=sf, session=session, prepared=True,
                    **kwargs)
    qs = res.query_stats
    lines = [_annotated_tree(executed, qs, sf)]
    if qs is not None:
        lines += ["", "-- stages --"]
        for name in ("staging", "compile", "execute", "exchange", "fetch"):
            st = qs.stages.get(name)
            if st is None:
                continue
            extra = ""
            if st.compile_us:
                extra += f" compile={st.compile_us}us"
            if st.flops:
                extra += f" flops={st.flops:.3g}"
            if st.bytes_accessed:
                extra += f" bytesAccessed={st.bytes_accessed:.3g}"
            if st.rows:
                extra += f" rows={st.rows}"
            if st.bytes:
                extra += f" bytes={_fmt_bytes(st.bytes)}"
            lines.append(f"{name}: wall={st.wall_us}us{extra}")
        if qs.counters:
            lines += ["", "-- collectives --"]
            for k in sorted(qs.counters):
                lines.append(f"{k}: {qs.counters[k]}")
        lines.append("")
        lines.append(f"output rows: {res.row_count}, "
                     f"peak memory: {_fmt_bytes(qs.peak_memory_bytes)}, "
                     f"wall: {qs.wall_us}us")
    else:
        lines += ["", f"output rows: {res.row_count}"]
    lines.extend(_kernel_lines(executed, session))
    lines.extend(_datapath_lines(qs))
    lines.extend(_accuracy_lines(qs))
    lines.extend(_timeline_lines(qs))
    # the flat named counters (QueryResult.stats: one value each in
    # the port, where the reference keeps total/count/max)
    if res.stats:
        lines += ["", "-- runtime counters --"]
        for name, v in sorted(res.stats.items()):
            lines.append(f"{name}: {v}")
    return "\n".join(lines)


def _kernel_lines(executed: N.PlanNode, session,
                  top: int = 3) -> List[str]:
    """EXPLAIN ANALYZE's continuous-profiler tail: the top-k hottest
    plans in this process's registry (exec/profiler.py) by device time,
    with the one this very plan executed marked."""
    from ..exec.profiler import profile_snapshot, profiling_enabled
    if not profiling_enabled(session):
        return []
    try:
        from ..exec.plan_cache import plan_fingerprint
        this_fp = plan_fingerprint(executed)
        rows = profile_snapshot(top=top)
        if not any(r["fingerprint"] == this_fp for r in rows):
            # this query's kernel may be outside the process top-k;
            # always show it (that is the question being asked)
            rows += [r for r in profile_snapshot()
                     if r["fingerprint"] == this_fp]
    except Exception:  # noqa: BLE001 - profiler annotation is garnish;
        # EXPLAIN ANALYZE output must never fail on it
        return []
    if not rows:
        return []
    lines = ["", f"-- kernels (top {top} device time, process-wide) --"]
    for r in rows:
        marker = "  <- this query" \
            if r["fingerprint"] == this_fp else ""
        mean_us = r["device_us"] // max(r["calls"], 1)
        lines.append(
            f"{r['fingerprint'][:12]} device={r['device_us']}us "
            f"calls={r['calls']} mean={mean_us}us "
            f"retraces={r['retraces']} rows_out={r['rows_out']} "
            f"{r['label']}{marker}")
    return lines


def _datapath_lines(qs) -> List[str]:
    """EXPLAIN ANALYZE's data-path waterfall tail (exec/datapath.py):
    one line per hop THIS query exercised -- bytes, wall, achieved
    rate, utilization of the hop's measured ceiling -- closed by the
    named bottleneck verdict (the hop with max wall share below band).
    The first call in a process pays the one-shot ceilings probe."""
    try:
        from ..exec.datapath import (HOP_CEILING, HOPS, achieved_b_per_s,
                                     bottleneck_verdict, probe_ceilings)
        if qs is None or not qs.datapath:
            return []
        ceilings = probe_ceilings()
        lines = ["", "-- datapath --"]
        total_wall = sum(h.wall_us for h in qs.datapath.values())
        for hop in HOPS:
            h = qs.datapath.get(hop)
            if h is None:
                continue
            achieved = achieved_b_per_s(h.bytes, h.wall_us)
            ceiling = ceilings.get(HOP_CEILING.get(hop, ""), 0.0)
            util = achieved / ceiling if ceiling > 0 else 0.0
            share = h.wall_us / total_wall if total_wall else 0.0
            lines.append(
                f"{hop}: bytes={_fmt_bytes(h.bytes)} "
                f"wall={h.wall_us}us ({share:.0%}) "
                f"rate={achieved / 1e9:.3f}GB/s "
                f"util={util:.0%} of {HOP_CEILING.get(hop, '?')}")
        verdict = bottleneck_verdict(qs.datapath, ceilings)
        if verdict is not None:
            qual = "below band" if verdict["belowBand"] else \
                "at ceiling; largest wall share"
            lines.append(
                f"bottleneck: {verdict['hop']} "
                f"(wall share {verdict['wallShare']:.0%}, "
                f"util {verdict['utilization']:.0%}, {qual})")
        return lines
    except Exception:  # noqa: BLE001 - the waterfall is garnish here;
        # EXPLAIN ANALYZE output must never fail on it
        return []


def _accuracy_lines(qs) -> List[str]:
    """EXPLAIN ANALYZE's estimate-accuracy tail (exec/accuracy.py):
    one line per recorded plan node -- the planner's estimate beside
    what the runtime measured, folded into a q-error with direction --
    closed by the named misestimate verdict."""
    try:
        from ..exec.accuracy import (direction_of, misestimate_verdict,
                                     q_error)
        if qs is None or not qs.accuracy:
            return []
        lines = ["", "-- accuracy --"]
        for node in sorted(qs.accuracy):
            r = qs.accuracy[node]
            q = q_error(r.est, r.actual)
            est_s = f"{r.est:.0f}" if r.est is not None else "?"
            act_s = f"{r.actual:.0f}" if r.actual is not None else "?"
            q_s = (f"{q:.2f}x {direction_of(r.est, r.actual)}"
                   if q is not None else "-")
            lines.append(f"{node}: est={est_s} actual={act_s} "
                         f"q={q_s} [{r.unit}]")
        verdict = misestimate_verdict(qs.accuracy)
        if verdict is not None:
            qual = "within band" if verdict["withinBand"] \
                else "MISESTIMATE"
            lines.append(f"verdict: {verdict['message']} ({qual})")
        return lines
    except Exception:  # noqa: BLE001 - the ledger is garnish here;
        # EXPLAIN ANALYZE output must never fail on it
        return []


def _timeline_lines(qs) -> List[str]:
    """EXPLAIN ANALYZE's execution-timeline tail (exec/timeline.py):
    an ASCII Gantt per lane over THIS query's recorded intervals,
    closed by the occupancy summary, the bubble verdict naming the
    hop the device spent its idle wall waiting on, and a line saying
    what the device lane measures in the port."""
    try:
        from ..exec.timeline import ascii_gantt, bubble_verdict, occupancy
        if qs is None or qs.timeline.is_empty():
            return []
        intervals = qs.timeline.intervals
        occ = occupancy(intervals)
        if occ is None:
            return []
        lines = ["", "-- timeline --"]
        lines.extend(ascii_gantt(intervals))
        lines.append(
            f"wall={occ['wallUs']}us "
            f"overlap={occ['overlapFraction']:.0%} "
            f"device_idle={occ['deviceIdleUs']}us "
            f"({occ['deviceIdleFraction']:.0%})"
            + (f" dropped={qs.timeline.dropped}"
               if qs.timeline.dropped else ""))
        verdict = bubble_verdict(intervals, occ)
        if verdict is not None:
            lines.append(f"verdict: {verdict['message']}")
        lines.append("device lane: dispatch spans (stream time between "
                     "events around each dispatch, host enqueue waits "
                     "included), not device busy time")
        return lines
    except Exception:  # noqa: BLE001 - the Gantt is garnish here;
        # EXPLAIN ANALYZE output must never fail on it
        return []


def explain_distributed(root: N.PlanNode) -> str:
    """Fragment-by-fragment rendering (EXPLAIN (TYPE DISTRIBUTED) analog)."""
    out: List[str] = []
    for frag in fragment_plan(root):
        out.append(f"Fragment {frag.id} [{frag.partitioning}]"
                   + (f" <- fragments {frag.remote_sources}"
                      if frag.remote_sources else ""))
        out.append(explain(frag.root))
        out.append("")
    return "\n".join(out).rstrip()
