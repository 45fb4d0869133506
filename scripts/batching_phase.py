"""chip_smoke.py's phase_batching: concurrent-query batching on one CUDA
card, at SF1.

    python3 scripts/batching_phase.py [--seed N] [--out PATH] [--profile]

Alone it builds the kernels (chip_smoke.phase_environment) first;
chip_smoke.py runs `phase_batching(chip_smoke_module, seed)` after
phase_observe. The three families of scripts/loadgen.py's workload, on
`cuda:0`:

  lookup     SELECT custkey, name, acctbal FROM customer
             WHERE custkey = k                    (150,000 rows)
  dashboard  SELECT orderpriority, count(*), sum(totalprice) FROM orders
             WHERE custkey = k GROUP BY orderpriority
             ORDER BY orderpriority               (1,500,000 rows, 5
                                                   groups: fused_limb_sums)
  batch      SELECT sum(extendedprice * discount) FROM lineitem WHERE
             discount BETWEEN 0.05 AND 0.07
             AND quantity < k                     (6,000,000 rows)

Keys are drawn from the seed; one dashboard key is one that no order
has (its member has no rows). Each family is warmed once
(BatchingExecutor.precompile), then runs as formed batches through
`bench_dispatch` at B = 5 (padded to 8) and B = 64 (the default
batch_max_size), the staged cache emptied before each so that each
batch stages the template's scans once, with the serial run_query of
four members of the B = 5 batch timed in turns between them. Checks:
every member's rows equal a numpy oracle; the four members equal their
serial run_query bit for bit; fused_limb_sums launches exactly B times
per dashboard batch and its first call equals its plain version; no
`error` or `overflow` collapse; each batch stages its scans once; the
host syncs of a batch are equal at B = 5 and B = 64. Then one batch of
three dashboard statements formed by the statement server's threads
(`try_execute`, a 400 ms window, batch_hot_min 1), and the dashboard
with fusion off (the region executor: rows equal to the fused ones,
one fused_limb_sums launch). Prints, per family and B, the staging ms,
the batch's execute and fetch ms, ms per member and the serial
run_query ms; the plan cache's hits and misses; the region counts.
With --profile, alone, it then profiles one warm dashboard batch of 64
(torch.profiler): device events, their summed and union ms, against
the batch's execute wall.
"""

import argparse
import json
import os
import statistics
import sys
import threading
import time

import numpy as np

SF = 1.0
DEVICE = "cuda:0"
SIZES = (5, 64)
SERIAL_MEMBERS = 4

LOOKUP = "SELECT custkey, name, acctbal FROM customer WHERE custkey = {}"
DASH = ("SELECT orderpriority, count(*) AS orders, sum(totalprice) AS s "
        "FROM orders WHERE custkey = {} "
        "GROUP BY orderpriority ORDER BY orderpriority")
BATCH = ("SELECT sum(extendedprice * discount) FROM lineitem "
         "WHERE discount BETWEEN 0.05 AND 0.07 AND quantity < {}")


class Oracles:
    """numpy answers of the three families on the host tables."""

    def __init__(self, C):
        cu = C.host_columns("customer", SF, ["custkey", "name", "acctbal"])
        od = C.host_columns("orders", SF,
                            ["custkey", "orderpriority", "totalprice"])
        li = C.host_columns("lineitem", SF,
                            ["extendedprice", "discount", "quantity"])
        self.customer = cu
        order = np.argsort(od["custkey"], kind="stable")
        self.o_key = od["custkey"][order]
        self.o_prio = od["orderpriority"][order]
        self.o_price = od["totalprice"][order]
        m = (li["discount"] >= 5) & (li["discount"] <= 7)
        qty = li["quantity"][m]
        rev = li["extendedprice"][m] * li["discount"][m]
        by_qty = np.argsort(qty, kind="stable")
        self.l_qty = qty[by_qty]
        self.l_cum = np.cumsum(rev[by_qty])

    def lookup(self, k):
        cu = self.customer
        if not 1 <= k <= len(cu["custkey"]):
            return []
        i = k - 1
        return [[int(cu["custkey"][i]), str(cu["name"][i]),
                 int(cu["acctbal"][i])]]

    def dashboard(self, k):
        lo = np.searchsorted(self.o_key, k, "left")
        hi = np.searchsorted(self.o_key, k, "right")
        prio, price = self.o_prio[lo:hi], self.o_price[lo:hi]
        return [[str(p), int((prio == p).sum()), int(price[prio == p].sum())]
                for p in sorted(set(prio.tolist()))]

    def batch(self, k):
        n = np.searchsorted(self.l_qty, 100 * k, "left")
        return [[int(self.l_cum[n - 1]) if n else None]]

    def missing_custkey(self, start):
        """The first custkey from `start` up that no order has."""
        have = set(np.unique(self.o_key).tolist())
        k = start
        while k in have:
            k += 1
        return k


def _keys(rng, oracles):
    n_cust = len(oracles.customer["custkey"])
    dash = rng.integers(1, n_cust + 1, size=max(SIZES)).tolist()
    dash[3] = oracles.missing_custkey(int(dash[3]))
    return {"lookup": rng.integers(1, n_cust + 1, size=max(SIZES)).tolist(),
            "dashboard": dash,
            "batch": rng.integers(1, 51, size=max(SIZES)).tolist()}


def _first_fused_call():
    """A wrapper of ops.kernels.fused_limb_sums that keeps its first
    call on the card (the check against the plain version) and no
    other: the batch's members would hold B sets of lanes."""
    from presto_tpu_torch.ops import kernels as K
    real, first = K.fused_limb_sums, []

    def recording(ids, sources, requests, groups, **kw):
        if ids.is_cuda and not first:
            first.append((ids, sources, requests, groups))
        return real(ids, sources, requests, groups, **kw)
    return real, recording, first


def _batch(C, ex, family, texts, want, dev):
    """One timed batch of `texts` through bench_dispatch: rows against
    the oracle, launches, syncs, the dispatch's walls."""
    import torch
    from presto_tpu_torch.ops import kernels as K
    ex._staged.clear()  # the batch stages its scans itself, once
    real, recording, first = _first_fused_call()
    C._reset_launches()
    K.fused_limb_sums = recording
    try:
        t0 = time.perf_counter()
        results, syncs = C._count_syncs(lambda: ex.bench_dispatch(
            texts, sf=SF, device=dev))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = K.LAUNCHES["fused_limb_sums"]
        err = C.check_fused(*first[0], f"batched {family}") if first \
            else None
    finally:
        K.fused_limb_sums = real
        del first[:]
    got = [C._exact_rows(r) for r in results]
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        raise AssertionError(f"batched {family}[{len(texts)}] member {bad}: "
                             f"{got[bad]} != {want[bad]}")
    d = dict(ex.last_dispatch)
    if d.get("size") != len(texts) or d.get("scans_staged") != 1:
        raise AssertionError(f"batched {family}[{len(texts)}]: {d}")
    if family == "dashboard" and (launches != len(texts) or err != 0.0):
        raise AssertionError(f"batched dashboard[{len(texts)}] launched "
                             f"fused_limb_sums {launches} times")
    return {"B": len(texts), "syncs": syncs, "launches": launches,
            "fused_max_abs_err": err, "stage_ms": d["stage_ms"],
            "execute_ms": d["execute_ms"], "fetch_ms": d["fetch_ms"],
            "wall_ms": wall_ms, "ms_per_member": wall_ms / len(texts)}, \
        results


def _serial(C, texts, batched, dev):
    """The serial run_query of each text (through sql()), timed, each
    equal to its batched rows bit for bit."""
    import torch
    from presto_tpu_torch import sql
    times = []
    for text, b in zip(texts, batched):
        t0 = time.perf_counter()
        res = sql(text, sf=SF, device=dev,
                  session={"query_batching": False})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if C._exact_rows(res) != C._exact_rows(b) or \
                res.names != b.names:
            raise AssertionError(f"serial {text!r} differs from its "
                                 f"batched rows")
    return times


def statement_batch(C, keys, oracles):
    """Three dashboard statements formed into one batch by the
    statement server's threads on the card."""
    from presto_tpu_torch.client import execute
    from presto_tpu_torch.server.statement import StatementServer
    session = {"sf": str(SF), "batch_window_ms": "400",
               "batch_hot_min": "1"}
    texts = [DASH.format(k) for k in keys]
    out = [None] * len(texts)
    with StatementServer(sf=SF, device=DEVICE) as srv:
        def run(i):
            out[i] = execute(srv.url, texts[i], session=session)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(texts))]
        t0 = time.perf_counter()
        threads[0].start()
        time.sleep(0.1)
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(120)
        wall = (time.perf_counter() - t0) * 1e3
        sizes = [C._get_json(f"{srv.url}/v1/query/{c.query_id}")["batchSize"]
                 for c in out]
        cluster = C._get_json(f"{srv.url}/v1/cluster")["batching"]
    for k, c in zip(keys, out):
        if c.data != C._rendered(oracles.dashboard(k), c.columns):
            raise AssertionError(f"statement dashboard {k}: {c.data}")
    if sizes != [len(texts)] * len(texts):
        raise AssertionError(f"statement batch sizes {sizes}")
    print(f"batching statement: {len(texts)} dashboard statements served by "
          f"one batch through POST /v1/statement ({wall:.1f} ms from the "
          f"first POST to the last row); /v1/cluster batching {cluster}")
    return {"wall_ms": wall, "batch_sizes": sizes, "cluster": cluster}


def fusion_off(C, k, want, dev):
    """The dashboard with fusion off: the region executor, one region
    per operator, its rows equal to the fused rows, one fused_limb_sums
    launch (the aggregation's region)."""
    import torch
    from presto_tpu_torch import sql
    from presto_tpu_torch.ops import kernels as K
    C._reset_launches()
    t0 = time.perf_counter()
    res = sql(DASH.format(k), sf=SF, device=dev,
              session={"fusion": False, "query_batching": False})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = K.LAUNCHES["fused_limb_sums"]
    regions = res.stats.get("fusion_regions")
    if C._exact_rows(res) != want or not regions or launches != 1:
        raise AssertionError(f"dashboard with fusion off: {regions} "
                             f"regions, {launches} launches, rows "
                             f"{C._exact_rows(res)} != {want}")
    per_region = {k_: v for k_, v in res.stats.items()
                  if k_.startswith("fusion_region_")}
    print(f"batching fusion off: dashboard {k} in {regions} regions, equal "
          f"to the fused rows, one fused_limb_sums launch, {ms:.1f} ms; "
          f"region device us {per_region}")
    return {"regions": regions, "launches": launches, "ms": ms,
            "region_device_us": per_region}


def phase_batching(C, seed=0):
    """The phase (module docstring). `C` is chip_smoke's module, whose
    host-table cache and helpers it uses. Returns the report, with the
    phase's seconds."""
    import torch
    from presto_tpu_torch.exec.batching import (BatchingExecutor,
                                                batching_totals,
                                                clear_batching)
    from presto_tpu_torch.exec.plan_cache import cache_stats
    t_phase = time.perf_counter()
    dev = DEVICE
    oracles = Oracles(C)
    keys = _keys(np.random.default_rng(seed), oracles)
    clear_batching()
    cache0 = cache_stats()
    ex = BatchingExecutor()
    families = {"lookup": (LOOKUP, oracles.lookup),
                "dashboard": (DASH, oracles.dashboard),
                "batch": (BATCH, oracles.batch)}
    out = {"families": {}}
    for family, (template, oracle) in families.items():
        ks = keys[family]
        t0 = time.perf_counter()
        buckets = ex.precompile(template.format(ks[0]), sf=SF, device=dev)
        warm_ms = (time.perf_counter() - t0) * 1e3
        rep = {"precompile_buckets": buckets, "warm_ms": warm_ms}
        for i, B in enumerate(SIZES):
            texts = [template.format(k) for k in ks[:B]]
            want = [oracle(k) for k in ks[:B]]
            rep[f"B{B}"], results = _batch(C, ex, family, texts, want, dev)
            if i == 0:  # in turns: the serial members between the sizes
                rep["serial_ms"] = _serial(
                    C, texts[:SERIAL_MEMBERS], results[:SERIAL_MEMBERS],
                    dev)
            del results
        if rep["B5"]["syncs"] != rep["B64"]["syncs"]:
            raise AssertionError(f"batched {family}: host syncs "
                                 f"{rep['B5']['syncs']} at B = 5, "
                                 f"{rep['B64']['syncs']} at B = 64")
        serial = statistics.mean(rep["serial_ms"])
        for B in SIZES:
            r = rep[f"B{B}"]
            print(f"batching {family} B={B}: staging {r['stage_ms']:.2f} ms "
                  f"(scans staged once), execute {r['execute_ms']:.2f} ms, "
                  f"fetch {r['fetch_ms']:.2f} ms, {r['ms_per_member']:.3f} "
                  f"ms per member against serial run_query "
                  f"{serial:.2f} ms; {r['syncs']} host syncs, "
                  f"fused_limb_sums launches {r['launches']}")
        out["families"][family] = rep
    torch.cuda.empty_cache()
    out["statement"] = statement_batch(C, keys["dashboard"][5:8], oracles)
    out["fusion_off"] = fusion_off(C, keys["dashboard"][0],
                                   oracles.dashboard(keys["dashboard"][0]),
                                   dev)
    totals = batching_totals()
    if totals["collapses"]["error"] or totals["collapses"]["overflow"]:
        raise AssertionError(f"batching collapsed: {totals}")
    cache1 = cache_stats()
    out["plan_cache"] = {"hits": cache1["hits"] - cache0["hits"],
                         "misses": cache1["misses"] - cache0["misses"],
                         "entries": cache1["entries"]}
    out["totals"] = totals
    clear_batching()
    del ex
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t_phase
    print(f"batching: plan cache {out['plan_cache']}; totals {totals}; the "
          f"phase took {out['s']:.1f} s")
    return out


def profile_dashboard(C, keys, dev):
    """Where a batched dashboard member's time goes: one batch of 64
    members (warm: its texts planned, its scans in the staged cache)
    inside a torch.profiler window. Prints the batch's execute wall
    (the members' runs and the one flag read, host clock), the device
    work of the window (its events other than host <-> device copies:
    count, summed and union ms) and both per member."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from presto_tpu_torch.exec.batching import BatchingExecutor
    ex = BatchingExecutor()
    texts = [DASH.format(k) for k in keys[:max(SIZES)]]
    ex.bench_dispatch(texts, sf=SF, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ex.bench_dispatch(texts, sf=SF, device=dev)
        torch.cuda.synchronize()
    d = dict(ex.last_dispatch)
    work = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "HtoD" not in e.name and "DtoH" not in e.name]
    union_us, end = 0, None
    for e in sorted(work, key=lambda e: e.time_range.start):
        t0, t1 = e.time_range.start, e.time_range.end
        if end is None or t0 > end:
            union_us, end = union_us + t1 - t0, t1
        elif t1 > end:
            union_us, end = union_us + t1 - end, t1
    n = len(texts)
    out = {"B": n, "execute_ms": d["execute_ms"],
           "staged_scans": d["scans_staged"], "work_events": len(work),
           "work_sum_ms": sum(e.time_range.elapsed_us() for e in work)
           / 1e3, "work_union_ms": union_us / 1e3}
    print(f"batching profile: dashboard B={n}, execute {d['execute_ms']:.2f}"
          f" ms ({d['execute_ms'] / n:.3f} a member); device work "
          f"{len(work)} events ({len(work) / n:.1f} a member), summed "
          f"{out['work_sum_ms']:.3f} ms, union {out['work_union_ms']:.3f} "
          f"ms ({out['work_union_ms'] / n:.4f} a member)")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the report here")
    ap.add_argument("--profile", action="store_true",
                    help="then profile one warm dashboard batch of 64")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("batching_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as C
    t0 = time.perf_counter()
    C.install_host_cache()
    C.phase_environment()
    rep = phase_batching(C, args.seed)
    if args.profile:
        oracles = Oracles(C)
        keys = _keys(np.random.default_rng(args.seed), oracles)
        rep["profile"] = profile_dashboard(C, keys["dashboard"], DEVICE)
    gpu = C._run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    print(gpu)
    rep.update(gen_s=C.GEN_S, total_s=time.perf_counter() - t0, gpu=gpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1, default=str)
    print(f"batching phase {rep['s']:.1f} s; host generation {C.GEN_S}; "
          f"TOTAL {rep['total_s']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
