"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out PATH]

Builds the port's CUDA kernels from the sources in this checkout,
holds each against its plain PyTorch version at the shapes of the main
path, then runs TPC-H q1 and q6 at scale factor 1 (6,000,000 lineitem
rows) through `presto_tpu_torch.exec.run_query` on the card and checks
their rows exactly against numpy oracles written here. Prints one JSON
line per kernel table, the card's name and power limit, and as its last
line {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA device, when the package is missing, or when any
phase fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

SF = 1.0
Q1_CUTOFF = "1998-09-02"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
WARMUP = 3
REPEATS = 10
QUERY_REPEATS = 5


def _days(iso: str) -> int:
    return int((np.datetime64(iso) - np.datetime64("1970-01-01")).astype(int))


def _run(cmd):
    p = subprocess.run(cmd, capture_output=True, text=True)
    return (p.stdout + p.stderr).strip()


# ---------------------------------------------------------------------------
# plans, built from the port's own nodes
# ---------------------------------------------------------------------------

def q1_plan():
    from presto_tpu_torch import types as T
    from presto_tpu_torch.connectors import tpch
    from presto_tpu_torch.expr import call, const, input_ref
    from presto_tpu_torch.ops.aggregation import AggSpec
    from presto_tpu_torch.plan import (AggregationNode, FilterNode,
                                       OutputNode, ProjectNode, SortNode,
                                       TableScanNode)
    d2 = T.decimal(12, 2)
    cols = ["returnflag", "linestatus", "quantity", "extendedprice",
            "discount", "tax", "shipdate"]
    scan = TableScanNode("tpch", "lineitem", cols,
                         [tpch.column_type("lineitem", c) for c in cols])
    qty, price = input_ref(2, d2), input_ref(3, d2)
    disc, tax = input_ref(4, d2), input_ref(5, d2)
    one = const(100, d2)
    filt = FilterNode(scan, call("le", T.BOOLEAN, input_ref(6, T.DATE),
                                 const(Q1_CUTOFF, T.DATE)))
    disc_price = call("multiply", T.decimal(24, 4), price,
                      call("subtract", d2, one, disc))
    charge = call("multiply", T.decimal(36, 6), disc_price,
                  call("add", d2, one, tax))
    proj = ProjectNode(filt, [input_ref(0, T.char(1)),
                              input_ref(1, T.char(1)), qty, price,
                              disc_price, charge, disc])
    aggs = [AggSpec("sum", 2, T.decimal(38, 2)),
            AggSpec("sum", 3, T.decimal(38, 2)),
            AggSpec("sum", 4, T.decimal(38, 4)),
            AggSpec("sum", 5, T.decimal(38, 6)),
            AggSpec("avg", 2, d2), AggSpec("avg", 3, d2),
            AggSpec("avg", 6, d2),
            AggSpec("count_star", None, T.BIGINT)]
    agg = AggregationNode(proj, [0, 1], aggs, max_groups=16)
    return OutputNode(SortNode(agg, [(0, False, True), (1, False, True)]),
                      ["returnflag", "linestatus", "sum_qty",
                       "sum_base_price", "sum_disc_price", "sum_charge",
                       "avg_qty", "avg_price", "avg_disc", "count_order"])


def q6_plan():
    from presto_tpu_torch import types as T
    from presto_tpu_torch.connectors import tpch
    from presto_tpu_torch.expr import call, const, input_ref, special
    from presto_tpu_torch.ops.aggregation import AggSpec
    from presto_tpu_torch.plan import (AggregationNode, FilterNode,
                                       OutputNode, ProjectNode,
                                       TableScanNode)
    d2 = T.decimal(12, 2)
    cols = ["shipdate", "discount", "quantity", "extendedprice"]
    scan = TableScanNode("tpch", "lineitem", cols,
                         [tpch.column_type("lineitem", c) for c in cols])
    ship = input_ref(0, T.DATE)
    disc, qty, price = input_ref(1, d2), input_ref(2, d2), input_ref(3, d2)
    filt = FilterNode(scan, special(
        "AND", T.BOOLEAN,
        call("ge", T.BOOLEAN, ship, const("1994-01-01", T.DATE)),
        call("lt", T.BOOLEAN, ship, const("1995-01-01", T.DATE)),
        special("BETWEEN", T.BOOLEAN, disc, const(5, d2), const(7, d2)),
        call("lt", T.BOOLEAN, qty, const(2400, d2))))
    proj = ProjectNode(filt, [call("multiply", T.decimal(24, 4), price,
                                   disc)])
    agg = AggregationNode(proj, [], [AggSpec("sum", 0, T.decimal(38, 4))])
    return OutputNode(agg, ["revenue"])


# ---------------------------------------------------------------------------
# numpy oracles (independent of the engine's code)
# ---------------------------------------------------------------------------

def _avg(s: int, c: int) -> int:
    """Decimal average at the input's scale, rounded half away from 0."""
    q = (2 * abs(s) + c) // (2 * c)
    return q if s >= 0 else -q


def numpy_q1(cols):
    m = cols["shipdate"] <= _days(Q1_CUTOFF)
    rf, ls = cols["returnflag"][m], cols["linestatus"][m]
    qty = cols["quantity"][m]
    price = cols["extendedprice"][m]
    disc, tax = cols["discount"][m], cols["tax"][m]
    key = np.char.add(rf.astype(str), ls.astype(str))
    uniq, inv = np.unique(key, return_inverse=True)
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    rows = []
    for i, k in enumerate(uniq):
        g = inv == i
        c = int(g.sum())
        sq, sp = int(qty[g].sum()), int(price[g].sum())
        rows.append((k[0], k[1], sq, sp, int(disc_price[g].sum()),
                     int(charge[g].sum()), _avg(sq, c), _avg(sp, c),
                     _avg(int(disc[g].sum()), c), c))
    return rows


def numpy_q6(cols):
    ship, disc = cols["shipdate"], cols["discount"]
    m = ((ship >= _days("1994-01-01")) & (ship < _days("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (cols["quantity"] < 2400))
    return [(int((cols["extendedprice"][m] * disc[m]).sum()),)]


def _plain_rows(res):
    return [tuple(v.item() if isinstance(v, np.generic) else v for v in row)
            for row in res.rows()]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def cuda_ms(fn, repeats=REPEATS, warmup=WARMUP):
    """Median milliseconds of fn() over `repeats` event-timed runs."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_ms(fn, repeats=QUERY_REPEATS):
    """Median host wall milliseconds of fn() (which ends synced) after
    one warm-up run."""
    import torch
    fn()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment():
    import torch
    from presto_tpu_torch.ops import kernels as K
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(_run([K._nvcc(), "--version"]).splitlines()[-1])
    print(f"gpu: {_run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'])}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    so = K.build_library("limb_partial_sums")
    build_s = time.perf_counter() - t0
    print(f"built {os.path.basename(so)} in {build_s:.1f} s")
    with open(so[:-3] + ".log") as f:
        print(f.read().strip())
    return build_s


def _q1_like_ids(n, groups, gen, device):
    """Group ids with q1's skew: four live groups, filtered rows parked
    in the last slot."""
    import torch
    u = torch.rand(n, generator=gen, device=device)
    ids = torch.full((n,), groups - 1, dtype=torch.int32, device=device)
    for g, hi in enumerate((0.25, 0.26, 0.74, 0.985)):
        ids = torch.where((u < hi) & (ids == groups - 1),
                          torch.tensor(g, dtype=torch.int32, device=device),
                          ids)
    return ids


def _limbs(n, L, form, gen, device):
    import torch
    if form == "int16x8":
        return torch.randint(-128, 256, (n, L), generator=gen, device=device,
                             dtype=torch.int16)
    return torch.randint(-8191, 8192, (n, L), generator=gen,
                         device=device).to(torch.float32)


def phase_kernels(seed, q1_shapes):
    """limb_partial_sums against its plain version: exact equality at
    q1's shapes, a ragged n with out-of-range ids and the chunked G=64
    table, and the worst-case tiles. Returns the kernel table rows."""
    import torch
    from presto_tpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def check(ids, limbs, groups, what):
        got = K.limb_partial_sums(ids, limbs, groups)
        want = K.limb_partial_sums_reference(ids, limbs, groups)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not torch.equal(got, want):
            raise AssertionError(f"limb_partial_sums {what}: max abs err "
                                 f"{err}")
        print(f"kernel exact: {what}")
        return err

    # ragged n, ids outside [0, G), G = 64 (more than one column chunk)
    for form in ("int16x8", "f32x13"):
        n, groups = 1_000_003, 64
        ids = torch.randint(-2, groups + 6, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
        check(ids, _limbs(n, 71, form, gen, dev), groups,
              f"{form} ragged n={n} G={groups} L=71 with ids outside [0, G)")
    # worst case: every limb at the form's extreme over full tiles
    for form, top in (("int16x8", 255), ("f32x13", 8191)):
        n, groups, L = 3 * K.SUM_TILE, 16, 71
        dt = torch.int16 if form == "int16x8" else torch.float32
        ids = torch.zeros(n, dtype=torch.int32, device=dev)
        ids[K.SUM_TILE:] = groups - 1
        for sign in (1, -1):
            limbs = torch.full((n, L), sign * top, dtype=dt, device=dev)
            check(ids, limbs, groups, f"{form} worst case {sign * top} x "
                  f"{K.SUM_TILE} rows per tile")

    rows = []
    for form, (n, groups, L) in q1_shapes.items():
        ids = _q1_like_ids(n, groups, gen, dev)
        limbs = _limbs(n, L, form, gen, dev)
        err = check(ids, limbs, groups, f"{form} q1 shape n={n} G={groups} "
                    f"L={L}")
        tiles = -(-n // K.SUM_TILE)
        flat = (torch.arange(n, device=dev) // K.SUM_TILE) * groups \
            + ids.to(torch.int64)
        lf = limbs.to(torch.float32)

        def library():
            return torch.zeros(tiles * groups, L, dtype=torch.float32,
                               device=dev).index_add_(0, flat, lf)

        if not torch.equal(library().reshape(tiles, groups, L),
                           K.limb_partial_sums(ids, limbs, groups)):
            raise AssertionError("index_add_ yardstick disagrees")
        ms = cuda_ms(lambda: K.limb_partial_sums(ids, limbs, groups))
        plain_ms = cuda_ms(
            lambda: K.limb_partial_sums_reference(ids, limbs, groups))
        library_ms = cuda_ms(library)
        nbytes = n * 4 + limbs.numel() * limbs.element_size() \
            + tiles * groups * L * 4
        rows.append({
            "name": "limb_partial_sums", "form": form, "route": "cuda",
            "source": "presto_tpu_torch/ops/csrc/limb_partial_sums.cu",
            "replaces": "presto_tpu/ops/pallas_kernels.py:141",
            "launches": 0, "max_abs_err": err, "exact": err == 0.0,
            "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": library_ms,
            "library": "torch.Tensor.index_add_ (float32, flat index "
                       "tile*G+id precomputed)",
            "shape": {"n": n, "G": groups, "L": L,
                      "dtype": str(limbs.dtype).replace("torch.", "")},
            "bytes": nbytes})
        print(f"{form}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"index_add_ {library_ms:.4f} ms, bound "
              f"{rows[-1]['bound_ms']:.4f} ms")
        del ids, limbs, flat, lf
        torch.cuda.empty_cache()
    return rows


def _count_syncs(fn):
    """Host-device synchronizations fn() makes (torch's sync debug mode
    warns once per synchronizing call)."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def phase_query(name, plan_fn, oracle, columns, limb_forms):
    """Run one query at SF1 through run_query on the card, once per limb
    form; check the rows exactly against the oracle and count kernel
    launches; then time it."""
    import torch
    from presto_tpu_torch.connectors import tpch
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.exec.runner import execute, stage_scans
    from presto_tpu_torch.ops import kernels as K
    from presto_tpu_torch.plan.widths import annotate_widths

    host = tpch.generate_columns("lineitem", SF, columns)
    want = oracle(host)
    rows_in = tpch.table_row_count("lineitem", SF)
    report = {"query": name, "sf": SF, "rows": rows_in}
    for form in limb_forms:
        K.LAUNCHES["limb_partial_sums"] = 0
        res, syncs = _count_syncs(
            lambda: run_query(plan_fn(), sf=SF, limb_form=form))
        launches = K.LAUNCHES["limb_partial_sums"]
        got = _plain_rows(res)
        if got != want:
            raise AssertionError(f"{name} ({form}) rows differ from the "
                                 f"oracle:\n got  {got}\n want {want}")
        print(f"{name} ({form}) equals its numpy oracle: {len(got)} rows; "
              f"kernel launches {launches}; host syncs {syncs}")
        report.setdefault("launches", {})[_FORM_OF[form]] = launches
        report.setdefault("host_syncs", {})[_FORM_OF[form]] = syncs
    report["result"] = [list(map(str, r)) for r in want]

    root = annotate_widths(plan_fn(), SF)
    batches = stage_scans(root, SF, torch.device("cuda"))
    staged = sum(t.numel() * t.element_size()
                 for b in batches for col in b.columns
                 for t in vars(col).values() if isinstance(t, torch.Tensor)) \
        + sum(b.active.numel() for b in batches)
    report["staged_mb"] = staged / 1e6
    report["execute_ms"] = wall_ms(lambda: execute(root, batches))
    report["run_query_ms"] = wall_ms(lambda: run_query(plan_fn(), sf=SF))
    report["rows_per_s_execute"] = rows_in / (report["execute_ms"] / 1e3)
    report["rows_per_s_run_query"] = rows_in / (report["run_query_ms"] / 1e3)
    print(f"{name}: staged {report['staged_mb']:.1f} MB; execute "
          f"{report['execute_ms']:.3f} ms ({report['rows_per_s_execute']:.0f}"
          f" rows/s); run_query incl. generation and staging "
          f"{report['run_query_ms']:.1f} ms")
    del batches
    torch.cuda.empty_cache()
    return report


Q1_COLUMNS = ["returnflag", "linestatus", "quantity", "extendedprice",
              "discount", "tax", "shipdate"]
Q6_COLUMNS = ["shipdate", "discount", "quantity", "extendedprice"]

# the limb matrix q1 at SF1 hands the kernel: the same 39 requests as the
# reference's fused pool (31 thirteen-bit sums and 8 one-bit counts, one
# count per aggregate); narrow splits each 13-bit sum into two 8-bit limbs
Q1_KERNEL_SHAPES = {"int16x8": (6_000_000, 16, 70),
                    "f32x13": (6_000_000, 16, 39)}
_FORM_OF = {"narrow": "int16x8", "wide": "f32x13"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the report JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import presto_tpu_torch  # noqa: F401  (fails outside the checkout)
    from presto_tpu_torch.ops import kernels as K

    t_start = time.perf_counter()
    build_s = phase_environment()
    kernel_rows = phase_kernels(args.seed, Q1_KERNEL_SHAPES)

    # the shapes the main path really hands the kernel
    seen = []
    launch = K.limb_partial_sums

    def recording(ids, limbs, groups):
        if limbs.is_cuda:
            seen.append((limbs.shape[0], groups, limbs.shape[1],
                         str(limbs.dtype)))
        return launch(ids, limbs, groups)

    K.limb_partial_sums = recording
    try:
        q1 = phase_query("q1", q1_plan, numpy_q1, Q1_COLUMNS,
                         ("narrow", "wide"))
    finally:
        K.limb_partial_sums = launch
    print(f"main path kernel shapes: {sorted(set(seen))}")
    for row in kernel_rows:
        form = row["form"]
        want = Q1_KERNEL_SHAPES[form]
        if not any(s[:3] == want for s in seen):
            raise AssertionError(f"q1 did not hand the kernel {want} ({form})")
        row["launches"] = q1["launches"][form]
        if row["launches"] < 1:
            raise AssertionError(f"q1 never launched limb_partial_sums ({form})")
    q6 = phase_query("q6", q6_plan, numpy_q6, Q6_COLUMNS, ("narrow",))

    gpu = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    report = {"kernels": kernel_rows, "queries": [q1, q6],
              "build_s": build_s, "gpu": gpu, "torch": torch.__version__,
              "cuda": torch.version.cuda,
              "total_s": time.perf_counter() - t_start}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernel_rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
