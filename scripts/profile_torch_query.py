"""Where the time of the PyTorch port's queries goes, on one CUDA card.

    python3 scripts/profile_torch_query.py [--sf 1.0] [--join-sf 10.0]
                                           [--queries NAMES] [--out PATH]

TPC-H q1 (in both limb forms: narrow takes the fused_limb_sums kernel,
wide the per-tile limb_partial_sums kernel) and q6 at --sf, q3 and q14
at --join-sf, and q5, q7, q8 and q9 of the committed SF1 corpus
(presto_tpu_torch/queries/tpch_sf1.json: small aggregations above join
chains); --queries names others (a comma list of those four and any
corpus entry: a two-stage plan such as q1_two_stage, an aggregate
statement such as agg_hash, a TPC-DS query as tpcds_q51, its timed
plan of presto_tpu_torch/queries/tpcds.json, or a timed statement of
presto_tpu_torch/queries/functions.json such as fn_arrays, its SF1
plan). Stages each query's scans once on the card, runs it once
through the overflow ladder (so the capacities that fit are known),
then:

* times every operator of the plan on its own (Filter, Project, each
  LIKE inside them and each projected expression over arrays, maps,
  rows or lambdas, Unnest, Join, SemiJoin, the group-by (small-table ids +
  pooled sums + kernel, the sorted large-table path, or the hash-slot
  path with its probe rounds timed apart), a FINAL step's
  merge_partials, finalize, Sort, TopN, Limit, Distinct, MarkDistinct,
  Union, AssignUniqueId, Window, RowNumber, GroupId, the result fetch; an exchange is the identity
  on one card; a shared subtree once): host clock around a synced
  call, median of 5 after a warm-up, each fed its input computed once
  beforehand; the hash path's probe rounds and host reads of its exit
  flag go to `hash_stats`;
* records one `execute` under torch.profiler: the device time of every
  kernel, their launch counts, the hand-written kernels' launches, and
  the device's idle share of the execute wall;
* where the ladder fitted its capacity nodes unequally, runs the plan
  also with every capacity at the largest factor (the reference
  ladder's plan, which raises them all): host wall of both in turns
  (fitted, uniform, uniform, fitted; median of 5 each) and one profiled
  run of each.

Prints one JSON object per query and the card's name and power limit;
with --out also writes them to PATH. Needs a CUDA device. It takes its
plans and timers from chip_smoke.py, and stands in for the
observability ledgers until they are ported.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _likes(expr):
    from presto_tpu_torch.expr import ir as E
    if isinstance(expr, E.Call) and expr.name.lower() == "like":
        yield expr
    for c in expr.children():
        yield from _likes(c)


def _nested(expr):
    """Whether the expression holds a lambda or a value of an array,
    map or row type."""
    from presto_tpu_torch.expr import ir as E
    if isinstance(expr, E.Lambda) or \
            expr.type.base in ("array", "map", "row"):
        return True
    return any(_nested(c) for c in expr.children())


def _stages(root, batches, limb_form):
    """(label, fn, inputs) per operator, each fed its input batches
    (computed once, outside the timed calls)."""
    from presto_tpu_torch.exec.planner import compile_plan
    from presto_tpu_torch.exec.runner import _batch_to_result
    from presto_tpu_torch.expr.compile import (compile_filter,
                                               compile_projections, evaluate)
    from presto_tpu_torch.ops import aggregation as A
    from presto_tpu_torch import types as T
    from presto_tpu_torch.block import Batch, Column, concat_batches
    from presto_tpu_torch.ops.join import hash_join, semi_join_mask
    from presto_tpu_torch.ops.misc import (distinct, group_id, limit,
                                           mark_distinct)
    from presto_tpu_torch.ops.sort import sort_batch, top_n
    from presto_tpu_torch.ops.unnest import unnest
    from presto_tpu_torch.ops.window import WindowSpec, specs_of, window
    from presto_tpu_torch.plan import nodes as N
    import torch

    inputs = {n.id: b for n, b in zip(compile_plan(root).scan_nodes,
                                      batches)}
    out = []
    hash_stats = []
    done = {}  # node id -> output: a shared subtree is timed once

    def add(label, fn, *args):
        n = sum(1 for lb, _, _ in out if lb.split(" #")[0] == label)
        out.append((f"{label} #{n + 1}" if n else label, fn, args))
        return fn(*args)

    def walk(node):
        if node.id not in done:
            done[node.id] = walk_node(node)
        return done[node.id]

    def with_column(b, values, ty):
        return Batch(b.columns + (Column(values, torch.zeros_like(
            b.active), ty),), b.active)

    def walk_node(node):
        if isinstance(node, N.TableScanNode):
            return inputs[node.id]
        if isinstance(node, (N.FilterNode, N.ProjectNode)):
            b = walk(node.source)
            exprs = [node.predicate] if isinstance(node, N.FilterNode) \
                else node.expressions
            for e in exprs:
                for like in _likes(e):
                    add(f"LIKE {like.arguments[1].value!r}",
                        lambda x, l=like: evaluate(l, x), b)
                if _nested(e) and isinstance(node, N.ProjectNode):
                    what = getattr(e, "name", None) or getattr(e, "form")
                    add(f"expression {what}",
                        lambda x, e=e: evaluate(e, x), b)
            if isinstance(node, N.FilterNode):
                label = f"filter {node.source.table}" if isinstance(
                    node.source, N.TableScanNode) else "filter"
                return add(label, compile_filter(node.predicate), b)
            return add("project", compile_projections(node.expressions), b)
        if isinstance(node, N.SemiJoinNode):
            def semi(src, filt, n=node):
                m, mnull = semi_join_mask(
                    src, filt, n.source_key if isinstance(
                        n.source_key, list) else [n.source_key],
                    n.filtering_key if isinstance(
                        n.filtering_key, list) else [n.filtering_key],
                    n.null_keys_match)
                return Batch(src.columns + (Column(m, mnull, T.BOOLEAN),),
                             src.active)
            return add("semi join", semi, walk(node.source),
                       walk(node.filtering_source))
        if isinstance(node, N.LimitNode):
            return add("limit", lambda x, n=node: limit(x, n.count),
                       walk(node.source))
        if isinstance(node, N.DistinctNode):
            return add("distinct", lambda x, n=node: distinct(
                x, n.key_channels if n.key_channels is not None
                else range(x.num_columns)), walk(node.source))
        if isinstance(node, N.MarkDistinctNode):
            return add("mark distinct", lambda x, n=node: with_column(
                x, mark_distinct(x, n.key_channels), T.BOOLEAN),
                walk(node.source))
        if isinstance(node, N.UnionNode):
            return add("union", lambda *xs: concat_batches(xs),
                       *[walk(s) for s in node.inputs])
        if isinstance(node, N.AssignUniqueIdNode):
            return add("assign unique id", lambda x: with_column(
                x, torch.arange(x.capacity, device=x.active.device),
                T.BIGINT), walk(node.source))
        if isinstance(node, N.JoinNode):
            label = "join" if node.join_type == "inner" \
                else f"join ({node.join_type})"
            return add(label, lambda l, r, n=node: hash_join(
                l, r, n.left_keys, n.right_keys,
                n.out_capacity, n.join_type,
                n.right_output_channels).batch,
                walk(node.left), walk(node.right))
        if isinstance(node, N.AggregationNode):
            b = walk(node.source)
            keys, mg, aggs = node.group_channels, node.max_groups, \
                node.aggregates
            merge = node.step in ("FINAL", "INTERMEDIATE")
            if merge:  # the merge aggregates over the state table's keys
                keys, specs, ch = list(range(len(keys))), [], len(keys)
                for a in aggs:
                    specs.extend(A.merge_spec(a, ch))
                    ch += A.state_width(a)
            else:
                specs = aggs
            if not keys:
                path = "keyless, one slot"
            elif mg <= A.SMALL_G:
                path = "ids + pooled sums + kernel"
                add("group_ids", lambda x: A._group_ids(
                    [x.column(c) for c in keys], x.active, mg), b)
            elif A._sorted_capable(b, keys, specs):
                path = "sorted"
            else:
                path = "hash"
                add("hash rounds (group ids)", lambda x: A._group_ids(
                    [x.column(c) for c in keys], x.active, mg), b)
                hash_stats.append(dict(A.HASH_STATS))
            if merge:
                table = add(f"merge_partials ({path})",
                            lambda x, n=node: A.merge_partials(
                                x, len(n.group_channels), n.aggregates,
                                n.max_groups, limb_form).batch, b)
            else:
                table = add(f"group_by ({path})", lambda x, n=node:
                            A.group_by(x, n.group_channels, n.aggregates,
                                       n.max_groups, limb_form).batch, b)
            if node.step == "PARTIAL":
                return table
            return add("finalize", lambda t, n=node: A.finalize_states(
                t, len(n.group_channels), n.aggregates), table)
        if isinstance(node, N.ExchangeNode):
            return walk(node.source)
        if isinstance(node, N.SortNode):
            return add("sort", lambda x, k=node.keys: sort_batch(x, k),
                       walk(node.source))
        if isinstance(node, N.TopNNode):
            return add("top_n", lambda x, n=node: top_n(x, n.keys, n.count),
                       walk(node.source))
        if isinstance(node, N.WindowNode):
            return add("window", lambda x, n=node: window(
                x, n.partition_channels, n.order_keys,
                specs_of(n.functions)), walk(node.source))
        if isinstance(node, N.RowNumberNode):
            def row_number(x, n=node):
                out = window(x, n.partition_channels, n.order_keys,
                             [WindowSpec("row_number")])
                if n.max_rows_per_partition is None:
                    return out
                rn = out.column(out.num_columns - 1).values
                return out.with_active(
                    out.active & (rn <= n.max_rows_per_partition))
            return add("row_number", row_number, walk(node.source))
        if isinstance(node, N.UnnestNode):
            return add("unnest", lambda x, n=node: unnest(
                x, n.array_channel, n.out_capacity
                or x.capacity * 4 * n.capacity_factor,
                n.with_ordinality)[0], walk(node.source))
        if isinstance(node, N.GroupIdNode):
            return add("group_id", lambda x, n=node: group_id(
                x, n.grouping_sets, n.key_channels), walk(node.source))
        if isinstance(node, N.OutputNode):
            b = walk(node.source)
            add("result fetch", lambda x: _batch_to_result(x, root), b)
            return b
        raise NotImplementedError(type(node).__name__)

    walk(root)
    return out, hash_stats


def _profile(run):
    """One run() under torch.profiler, after one unprofiled run."""
    import torch
    from presto_tpu_torch.ops import kernels as K
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, e in spans:  # union of kernel intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e.name, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {"execute_wall_us": wall_us, "device_busy_us": busy,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernel_launches": len(kernels),
            "hand_written_launches": dict(K.LAUNCHES),
            "kernel_time_us": sum(v[1] for v in by_name.values()),
            "top_by_time": [{"kernel": k[:120], "launches": v[0],
                             "us": v[1]} for k, v in top[:15]],
            "top_by_launches": [
                {"kernel": k[:120], "launches": v[0], "us": v[1]}
                for k, v in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:10]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--join-sf", type=float, default=10.0)
    ap.add_argument("--queries", default="q1,q6,q3,q14,q5,q7,q8,q9",
                    help="comma list: q1, q6, q3, q14, corpus entries, "
                         "tpcds_qN and timed function statements (fn_*)")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_query: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from presto_tpu_torch.exec import runner
    from presto_tpu_torch.exec.planner import compile_plan
    from presto_tpu_torch.exec.runner import capacity_plan, execute
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.plan.stats import capacity_nodes, scale_capacities
    from presto_tpu_torch.plan.widths import annotate_widths
    from presto_tpu_torch.queries import (load_corpus, load_functions_corpus,
                                          load_tpcds_corpus)
    chip_smoke.install_host_cache()
    dev = torch.device("cuda")
    gpu = chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"])
    corpus = load_corpus()
    reports = []
    own = {"q1": (chip_smoke.q1_plan, args.sf, ("narrow", "wide")),
           "q6": (chip_smoke.q6_plan, args.sf, ("narrow",)),
           "q3": (chip_smoke.q3_plan, args.join_sf, ("narrow",)),
           "q14": (chip_smoke.q14_plan, args.join_sf, ("narrow",))}
    tpcds = load_tpcds_corpus() if "tpcds_" in args.queries else {}
    functions = load_functions_corpus()["timed"]

    def entry(q):
        """(name, plan maker, sf, limb forms, default join capacity)."""
        if q in own:
            return (q, *own[q], 1 << 16)
        if q.startswith("tpcds_"):
            e = tpcds[q[len("tpcds_"):]]
            return (q, lambda: from_json(e["plan_timed"]), e["timed_sf"],
                    ("narrow",), e["timed_join_capacity"])
        if q in functions:
            e = functions[q]
            return (q, lambda: from_json(e["plan_sf1"]), e["sf1"],
                    ("narrow",), 1 << 16)
        return (q, lambda: from_json(corpus[q]["plan"]), corpus[q]["sf"],
                ("narrow",), 1 << 16)

    for name, make, sf, forms, jc in map(entry, args.queries.split(",")):
        root = annotate_widths(make(), sf)
        # pruned by run_query's dynamic filters, as run_query stages
        batches = chip_smoke.run_query_batches(root, sf, dev)
        # climbs the ladder once; the memo keeps the capacities
        execute(root, batches, default_join_capacity=jc)
        factors = runner._CAPACITY_FEEDBACK.get(runner._fingerprint(root),
                                                (1,))
        scaled = capacity_plan(root, jc)
        uniform = scale_capacities(
            root, {n.id: max(factors) for n in capacity_nodes(root)}, jc)
        for form in forms:
            stage_list, hash_stats = _stages(scaled, batches, form)
            stages = {label: chip_smoke.wall_ms(lambda f=fn, a=args_: f(*a))
                      for label, fn, args_ in stage_list}
            rep = {"query": name, "limb_form": form, "sf": sf, "gpu": gpu,
                   "capacity_factors": list(factors), "stage_ms": stages,
                   "hash_stats": hash_stats,
                   "profile": _profile(
                       lambda: execute(root, batches, form, jc))}
            if len(set(factors)) > 1:
                fitted_fn = compile_plan(scaled, form, jc).fn
                uniform_fn = compile_plan(uniform, form, jc).fn
                try:
                    turns = [chip_smoke.wall_ms(lambda f=f: f(batches))
                             for f in (fitted_fn, uniform_fn, uniform_fn,
                                       fitted_fn)]
                    rep["fitted_vs_uniform"] = {
                        "execute_ms_in_turns": turns,
                        "uniform_profile": _profile(
                            lambda: uniform_fn(batches))}
                except torch.OutOfMemoryError as ex:
                    # the reference ladder's plan, every capacity at the
                    # largest factor, need not fit the card
                    rep["fitted_vs_uniform"] = {
                        "uniform": f"out of memory: {str(ex)[:120]}"}
                    torch.cuda.empty_cache()
            print(json.dumps(rep))
            reports.append(rep)
        del batches
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
