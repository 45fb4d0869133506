"""Where the time of the PyTorch port's q1/q6 goes, on one CUDA card.

    python3 scripts/profile_torch_query.py [--sf 1.0] [--out PATH]

Stages each query's lineitem scan once on the card, then:

* times every operator of the plan on its own (Filter, Project, the
  group-id rounds, the pooled sums with the limb_partial_sums kernel,
  finalize, Sort, the result fetch): host clock around a synced call,
  median of 5 after a warm-up;
* records one `execute` under torch.profiler: the device time of every
  kernel, their launch counts, and the device's idle share of the
  execute wall.

Prints one JSON object per query and the card's name and power limit;
with --out also writes them to PATH. Needs a CUDA device. It takes
its plans and timers from chip_smoke.py, and stands in for the
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


def _stages(root, batch):
    """(name, fn) per operator, each fed the previous operator's output
    (computed once, outside the timed calls)."""
    from presto_tpu_torch.exec.runner import _batch_to_result
    from presto_tpu_torch.expr.compile import (compile_filter,
                                               compile_projections)
    from presto_tpu_torch.ops.aggregation import (_group_ids,
                                                  finalize_states, group_by)
    from presto_tpu_torch.ops.sort import sort_batch
    from presto_tpu_torch.plan import nodes as N

    chain = []
    node = root
    while not isinstance(node, N.TableScanNode):
        chain.append(node)
        node = node.source
    out = []
    cur = batch
    for node in reversed(chain):
        if isinstance(node, N.FilterNode):
            fn = (lambda b, p=node.predicate: compile_filter(p)(b))
            out.append(("filter", fn, cur))
        elif isinstance(node, N.ProjectNode):
            fn = (lambda b, e=node.expressions: compile_projections(e)(b))
            out.append(("project", fn, cur))
        elif isinstance(node, N.AggregationNode):
            keys = node.group_channels
            mg = node.max_groups if keys else 1
            out.append(("group_ids", lambda b, k=keys, m=mg: _group_ids(
                [b.column(c) for c in k], b.active, m), cur))
            out.append(("group_by (ids + pooled sums + kernel)",
                        lambda b, n=node: group_by(
                            b, n.group_channels, n.aggregates, n.max_groups),
                        cur))
            table = group_by(cur, node.group_channels, node.aggregates,
                             node.max_groups).batch
            out.append(("finalize", lambda b, n=node: finalize_states(
                b, len(n.group_channels), n.aggregates), table))
            cur = finalize_states(table, len(node.group_channels),
                                  node.aggregates)
            continue
        elif isinstance(node, N.SortNode):
            fn = (lambda b, k=node.keys: sort_batch(b, k))
            out.append(("sort", fn, cur))
        elif isinstance(node, N.OutputNode):
            out.append(("result fetch", lambda b, r=root:
                        _batch_to_result(b, r), cur))
            continue
        cur = out[-1][1](cur)
    return out


def _profile(root, batches):
    import torch
    from presto_tpu_torch.exec.runner import execute
    from torch.profiler import ProfilerActivity, profile
    execute(root, batches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        execute(root, batches)
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
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_query: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from presto_tpu_torch.exec.runner import stage_scans
    from presto_tpu_torch.plan.widths import annotate_widths
    dev = torch.device("cuda")
    gpu = chip_smoke._run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"])
    reports = []
    for name, make in (("q1", chip_smoke.q1_plan), ("q6", chip_smoke.q6_plan)):
        root = annotate_widths(make(), args.sf)
        batches = stage_scans(root, args.sf, dev)
        stages = {label: chip_smoke.wall_ms(lambda f=fn, b=inp: f(b))
                  for label, fn, inp in _stages(root, batches[0])}
        rep = {"query": name, "sf": args.sf, "gpu": gpu, "stage_ms": stages,
               "profile": _profile(root, batches)}
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
