"""chip_smoke.py's phase_batching: concurrent-query batching on one CUDA
card, at SF1, each batch ONE program over a member axis.

    python3 scripts/batching_phase.py [--seed N] [--out PATH] [--profile]
                                      [--op-overhead]
    python3 scripts/batching_phase.py --against DIR [--out PATH]

Alone it builds the kernels (chip_smoke.phase_environment) first;
chip_smoke.py runs `phase_batching(chip_smoke_module, seed)` after
phase_observe. The three families of scripts/loadgen.py's workload and
a dashboard keyed by a DOUBLE, on `cuda:0`:

  lookup     SELECT custkey, name, acctbal FROM customer
             WHERE custkey = k                    (150,000 rows)
  dashboard  SELECT orderpriority, count(*), sum(totalprice) FROM orders
             WHERE custkey = k GROUP BY orderpriority
             ORDER BY orderpriority               (1,500,000 rows, 5
                                                   groups)
  bands      SELECT floor(CAST(totalprice AS double) / 100000) AS band,
             count(*), sum(totalprice) FROM orders WHERE custkey = k
             GROUP BY band ORDER BY band          (1,500,000 rows, up
                                                   to 6 bands; the
                                                   hash-slot group-by)
  batch      SELECT sum(extendedprice * discount) FROM lineitem WHERE
             discount BETWEEN 0.05 AND 0.07
             AND quantity < k                     (6,000,000 rows)

Keys are drawn from the seed; one dashboard key is one that no order
has (its member has no rows). Each family is warmed once
(BatchingExecutor.precompile), then runs as formed batches through
`bench_dispatch` at B = 5 and B = 64 (the default batch_max_size), the
staged cache emptied before each so that each batch stages the
template's scans once, with the serial run_query of four members of
the B = 5 batch timed in turns between them. A batch is one vmapped
program (exec/batching.py): the dashboard's group-by and the batch
family's keyless sum launch fused_limb_sums_batched ONCE per batch and
fused_limb_sums never, the lookup and the bands (their sums are
index_add over the hash slots) neither. Checks: every member's rows
equal a numpy oracle; the four members equal their serial run_query
bit for bit; the launches above, the batched launch of each B = 5
batch equal to its plain version; one program per dispatch; no `error` or
`overflow` collapse; each batch stages its scans once; the host syncs
of a batch are equal at B = 5 and B = 64. Then, per family, one
torch.profiler window over one more (warm) batch of each size: the
batch's device ops. Then one batch of three dashboard statements formed
by the statement server's threads (`try_execute`, a 400 ms window,
batch_hot_min 1), and the dashboard with fusion off (the region
executor: rows equal to the fused ones, one fused_limb_sums launch).
Prints, per family and B, the staging ms, the batch's execute and fetch
ms, ms per member, the serial run_query ms, device ops, host syncs and
the device memory peak; the plan cache's hits and misses; the region
counts. The dashboard's and the lineitem family's B = 64 batched calls
come back under `dashboard_call` and `lineitem_call` (chip_smoke.py's
two kernel rows of the batched entry).

With --profile, alone, it then profiles one warm dashboard batch of 64
(torch.profiler): device events, their summed and union ms, against
the batch's execute wall. With --op-overhead, alone, it then times
TPC-H q1's execute at SF1 with the group-by entering fused_limb_sums
through the custom op (as it does) and through a direct call of the
wrapper, in turns (op, direct, direct, op).

--against DIR (DIR: an unpacked `git archive` of another commit, in a
git-ignored directory such as `.archive/`) times the four families at
B = 5 and 64 through each checkout's own BatchingExecutor in turns, one
process a turn: DIR, this, this, DIR. Each process (`--side ROOT`)
imports ROOT's presto_tpu_torch, builds its kernels, warms each family
and prints, per family and B, the median ms a member over three
batches, the host syncs and the device memory peak, each batch's rows
against the numpy oracle.
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
# a dashboard whose GROUP BY and ORDER BY key is a DOUBLE (a customer's
# orders in price bands of 100,000), with no capacity hint: the hash-slot
# group-by over key words that are IEEE bit casts of values carrying the
# member axis
BANDS = ("SELECT floor(CAST(totalprice AS double) / 100000) AS band, "
         "count(*) AS c, sum(totalprice) AS s FROM orders "
         "WHERE custkey = {} "
         "GROUP BY floor(CAST(totalprice AS double) / 100000) ORDER BY band")


class Oracles:
    """numpy answers of the families on the host tables."""

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

    def bands(self, k):
        lo = np.searchsorted(self.o_key, k, "left")
        hi = np.searchsorted(self.o_key, k, "right")
        price = self.o_price[lo:hi]
        band = np.floor(price / 100.0 / 100000.0)
        return [[float(b).hex(), int((band == b).sum()),
                 int(price[band == b].sum())] for b in np.unique(band)]

    def families(self):
        """Each family's template and oracle, in the order they run."""
        return {"lookup": (LOOKUP, self.lookup),
                "dashboard": (DASH, self.dashboard),
                "bands": (BANDS, self.bands),
                "batch": (BATCH, self.batch)}

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
            "bands": rng.integers(1, n_cust + 1, size=max(SIZES)).tolist(),
            "batch": rng.integers(1, 51, size=max(SIZES)).tolist()}


def _first_batched_call():
    """A wrapper of ops.kernels.fused_limb_sums_batched that keeps its
    first call on the card (the check against the plain version, and
    the kernel row's lanes) and no other."""
    from presto_tpu_torch.ops import kernels as K
    real, first = K.fused_limb_sums_batched, []

    def recording(ids, sources, requests, groups, batch, **kw):
        if ids.is_cuda and not first:
            first.append((ids, sources, requests, groups, batch))
        return real(ids, sources, requests, groups, batch, **kw)
    return real, recording, first


# batched launches a batch of each family makes: the dashboard's
# group-by and the batch family's keyless sum, one each (the bands'
# hash-slot group-by sums by index_add)
BATCHED_LAUNCHES = {"lookup": 0, "dashboard": 1, "bands": 0, "batch": 1}

# the families whose batched call of B = 64 comes back for chip_smoke's
# kernel rows, and under which key
KEPT_CALLS = {"dashboard": "dashboard_call", "batch": "lineitem_call"}


def _batch(C, ex, family, texts, want, dev, keep_call=False, check=True):
    """One timed batch of `texts` through bench_dispatch: rows against
    the oracle, launches, syncs, the device memory peak, the dispatch's
    walls; with `check`, the batched entry's call against its plain
    version; with keep_call, that call comes back too."""
    import torch
    from presto_tpu_torch.ops import kernels as K
    ex._staged.clear()  # the batch stages its scans itself, once
    real, recording, first = _first_batched_call()
    C._reset_launches()
    K.fused_limb_sums_batched = recording
    peak = {}
    try:
        with C._peak_mb(peak):
            t0 = time.perf_counter()
            results, syncs = C._count_syncs(lambda: ex.bench_dispatch(
                texts, sf=SF, device=dev))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        launches = dict(K.LAUNCHES)
    finally:
        K.fused_limb_sums_batched = real
    err = C.check_fused_batched(*first[0], f"batched {family}") \
        if first and check else None
    call = first[0] if keep_call and first else None
    del first[:]
    got = [C._exact_rows(r) for r in results]
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        raise AssertionError(f"batched {family}[{len(texts)}] member {bad}: "
                             f"{got[bad]} != {want[bad]}")
    d = dict(ex.last_dispatch)
    if d.get("size") != len(texts) or d.get("scans_staged") != 1 or \
            d.get("programs") != 1:
        raise AssertionError(f"batched {family}[{len(texts)}]: {d}")
    want_launches = BATCHED_LAUNCHES[family]
    if launches["fused_limb_sums_batched"] != want_launches or \
            launches["fused_limb_sums"] != 0 or err not in (None, 0.0) or \
            (want_launches and check and err is None):
        raise AssertionError(f"batched {family}[{len(texts)}] launched "
                             f"{launches}, not fused_limb_sums_batched "
                             f"{want_launches} times and fused_limb_sums "
                             f"never (max abs err {err})")
    return {"B": len(texts), "syncs": syncs, "launches": launches,
            "batched_max_abs_err": err, "stage_ms": d["stage_ms"],
            "execute_ms": d["execute_ms"], "fetch_ms": d["fetch_ms"],
            "wall_ms": wall_ms, "ms_per_member": wall_ms / len(texts),
            "peak_mb": peak["peak_mb"]}, results, call


def _device_ops(fns, tries=3):
    """Device ops of each fn() (its kernels and memsets on the card,
    host <-> device copies left out), all in one torch.profiler window,
    split at marker kernels (torch.cuda._sleep's spin_kernel) as
    chip_smoke.device_times splits, the window opened with two
    unmeasured calls and closed with one (a trace that is starting can
    miss a kernel): [(count, union ms), ...]. Up to `tries` windows are
    taken for one that shows every marker."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def mark():
        torch.cuda.synchronize()
        time.sleep(0.002)
        torch.cuda._sleep(1000)

    seen = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fns[0]()
            fns[0]()
            for fn in fns:
                mark()
                fn()
            mark()
            fns[-1]()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA
                         and "HtoD" not in e.name and "DtoH" not in e.name),
                        key=lambda e: e.time_range.start)
        groups, markers = None, 0
        for e in events:
            if "spin_kernel" in e.name:
                markers += 1
                groups = [] if groups is None else groups
                groups.append([])
            elif groups is not None:
                groups[-1].append(e)
        seen.append(markers)
        if markers != len(fns) + 1:
            continue
        out = []
        for g in groups[:len(fns)]:
            union_us, end = 0, None
            for e in g:
                t0, t1 = e.time_range.start, e.time_range.end
                if end is None or t0 > end:
                    union_us, end = union_us + t1 - t0, t1
                elif t1 > end:
                    union_us, end = union_us + t1 - end, t1
            out.append((len(g), union_us / 1e3))
        return out
    raise AssertionError(f"{tries} profiler windows showed {seen} markers, "
                         f"not {len(fns) + 1}")


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
    families = oracles.families()
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
            keep = family in KEPT_CALLS and B == max(SIZES)
            # the plain version of B = 64 members costs seconds: the
            # batch of 5 is held to it here, the dashboard's and the
            # lineitem's batches of 64 by chip_smoke.batched_row, every
            # batch by its rows
            rep[f"B{B}"], results, call = _batch(C, ex, family, texts, want,
                                                 dev, keep_call=keep,
                                                 check=i == 0)
            if keep:
                out[KEPT_CALLS[family]] = call
            if i == 0:  # in turns: the serial members between the sizes
                rep["serial_ms"] = _serial(
                    C, texts[:SERIAL_MEMBERS], results[:SERIAL_MEMBERS],
                    dev)
            del results, call
        if rep["B5"]["syncs"] != rep["B64"]["syncs"]:
            raise AssertionError(f"batched {family}: host syncs "
                                 f"{rep['B5']['syncs']} at B = 5, "
                                 f"{rep['B64']['syncs']} at B = 64")
        # the device ops of one more batch of each size (warm: the scans
        # staged by the B = 64 batch serve both sizes' key)
        ops = _device_ops([
            lambda B=B: ex.bench_dispatch(
                [template.format(k) for k in ks[:B]], sf=SF, device=dev)
            for B in SIZES])
        serial = statistics.mean(rep["serial_ms"])
        for B, (n_ops, union_ms) in zip(SIZES, ops):
            r = rep[f"B{B}"]
            r["device_ops"], r["device_union_ms"] = n_ops, union_ms
            print(f"batching {family} B={B}: one program, {n_ops} device "
                  f"ops ({union_ms:.3f} ms of device work), staging "
                  f"{r['stage_ms']:.2f} ms (scans staged once), execute "
                  f"{r['execute_ms']:.2f} ms, fetch {r['fetch_ms']:.2f} ms, "
                  f"{r['ms_per_member']:.3f} ms per member against serial "
                  f"run_query {serial:.2f} ms; {r['syncs']} host syncs, "
                  f"peak {r['peak_mb']:.1f} MB, launches "
                  f"{ {k: v for k, v in r['launches'].items() if v} }")
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


def op_overhead(C, repeats=10):
    """TPC-H q1's execute at SF1 (the staged batches run_query stages,
    narrow limbs) with the group-by entering fused_limb_sums through the
    custom op and through a direct call of the wrapper, in turns: op,
    direct, direct, op, each the median host wall of `repeats`
    executes. The outputs of both forms are equal."""
    import torch
    from presto_tpu_torch.exec.runner import execute
    from presto_tpu_torch.parallel.exchange import map_block
    from presto_tpu_torch.ops import kernels as K
    from presto_tpu_torch.plan.widths import annotate_widths
    root = annotate_widths(C.q1_plan(), SF)
    batches = C.run_query_batches(root, SF)
    op = K.fused_limb_sums_op

    def direct(ids, sources, requests, groups):
        return K.fused_limb_sums(ids, sources, requests, groups)

    def tensors(batch):
        found = []
        for c in batch.columns:
            map_block(c, lambda t: found.append(t.cpu()) or t)
        return found + [batch.active.cpu()]

    def run(form):
        K.fused_limb_sums_op = op if form == "op" else direct
        try:
            out = tensors(execute(root, batches))
            return C.wall_ms(lambda: execute(root, batches),
                             repeats=repeats), out
        finally:
            K.fused_limb_sums_op = op

    turns = [(form, *run(form)) for form in ("op", "direct", "direct", "op")]
    first = turns[0][2]
    if any(len(out) != len(first) or not all(map(torch.equal, out, first))
           for _f, _ms, out in turns):
        raise AssertionError("q1's output differs between the op and the "
                             "direct call")
    out = {"turns_ms": [(f, ms) for f, ms, _r in turns],
           "op_ms": statistics.mean(ms for f, ms, _r in turns if f == "op"),
           "direct_ms": statistics.mean(ms for f, ms, _r in turns
                                        if f == "direct")}
    print(f"batching op overhead: q1 execute at SF1 {out['op_ms']:.3f} ms "
          f"through the custom op, {out['direct_ms']:.3f} ms through the "
          f"wrapper directly (in turns {out['turns_ms']})")
    return out


def side_run(C, seed, batches=3):
    """One turn of --against, in a process whose presto_tpu_torch is the
    checkout under test: the four families at each B, `batches`
    batches each after one warm batch; per family and B the median ms a
    member, the host syncs and the device memory peak."""
    import torch
    from presto_tpu_torch.exec.batching import BatchingExecutor
    oracles = Oracles(C)
    keys = _keys(np.random.default_rng(seed), oracles)
    ex = BatchingExecutor()
    families = oracles.families()
    out = {}
    for family, (template, oracle) in families.items():
        ks = keys[family]
        ex.precompile(template.format(ks[0]), sf=SF, device=DEVICE)
        for B in SIZES:
            texts = [template.format(k) for k in ks[:B]]
            want = [oracle(k) for k in ks[:B]]
            ex.bench_dispatch(texts, sf=SF, device=DEVICE)  # warm
            walls, peak = [], {}
            for _ in range(batches):
                with C._peak_mb(peak):
                    t0 = time.perf_counter()
                    results, syncs = C._count_syncs(
                        lambda: ex.bench_dispatch(texts, sf=SF,
                                                  device=DEVICE))
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                if [C._exact_rows(r) for r in results] != want:
                    raise AssertionError(f"{family}[{B}]: rows differ from "
                                         "the oracle")
                del results
            out[f"{family}/B{B}"] = {
                "ms_per_member": statistics.median(walls) / B,
                "syncs": syncs, "peak_mb": peak["peak_mb"]}
        torch.cuda.empty_cache()
    return out


def against(dirs, out_dir):
    """--against: the side runs in turns, DIR, this, this, DIR, one
    process each; the medians of each side's two turns."""
    import subprocess
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    order = [dirs, here, here, dirs]
    turns = []
    os.makedirs(out_dir, exist_ok=True)
    for i, root in enumerate(order):
        path = os.path.join(out_dir, f"batching_side_{i}.json")
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--side", root, "--out", path],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"side run {i} ({root}) failed:\n"
                               f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        with open(path) as f:
            turns.append(json.load(f)["side"])
    out = {"turns": [{"root": r, **t} for r, t in zip(order, turns)]}
    for cell in turns[0]:
        mine = [turns[1][cell], turns[2][cell]]
        theirs = [turns[0][cell], turns[3][cell]]
        row = {k: (statistics.mean(t[k] for t in mine),
                   statistics.mean(t[k] for t in theirs))
               for k in ("ms_per_member", "syncs", "peak_mb")}
        out[cell] = row
        mine_ms, theirs_ms = row["ms_per_member"]
        print(f"batching against {cell}: ms a member {mine_ms:.3f} (this) "
              f"against {theirs_ms:.3f} (DIR); "
              f"host syncs {row['syncs'][0]} against {row['syncs'][1]}; peak "
              f"{row['peak_mb'][0]:.1f} MB against {row['peak_mb'][1]:.1f} "
              f"MB; turns ms a member "
              f"{[round(t[cell]['ms_per_member'], 4) for t in turns]}")
    return out


def _load_chip_smoke():
    """This checkout's chip_smoke.py as a module (a side run's
    presto_tpu_torch may be another checkout's)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the report here")
    ap.add_argument("--profile", action="store_true",
                    help="then profile one warm dashboard batch of 64")
    ap.add_argument("--op-overhead", action="store_true",
                    help="then time q1's execute through the custom op "
                         "and the direct call, in turns")
    ap.add_argument("--against", metavar="DIR",
                    help="time the families of DIR's checkout and this "
                         "one's in turns, one process a turn")
    ap.add_argument("--side", metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("batching_phase: no CUDA device", file=sys.stderr)
        return 2
    if args.against:
        out_dir = os.path.dirname(os.path.abspath(args.out)) if args.out \
            else os.getcwd()
        rep = against(os.path.abspath(args.against), out_dir)
        gpu = _load_chip_smoke()._run(["nvidia-smi",
                                       "--query-gpu=name,power.limit",
                                       "--format=csv,noheader"])
        print(gpu)
        rep["gpu"] = gpu
        if args.out:
            with open(args.out, "w") as f:
                json.dump(rep, f, indent=1, default=str)
        return 0
    root = os.path.abspath(args.side) if args.side else \
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    C = _load_chip_smoke()
    t0 = time.perf_counter()
    C.install_host_cache()
    C.phase_environment()
    if args.side:
        rep = {"side": side_run(C, args.seed)}
    else:
        rep = phase_batching(C, args.seed)
        for key in KEPT_CALLS.values():
            rep.pop(key, None)
        if args.profile:
            oracles = Oracles(C)
            keys = _keys(np.random.default_rng(args.seed), oracles)
            rep["profile"] = profile_dashboard(C, keys["dashboard"], DEVICE)
        if args.op_overhead:
            rep["op_overhead"] = op_overhead(C)
    gpu = C._run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    print(gpu)
    rep.update(gen_s=C.GEN_S, total_s=time.perf_counter() - t0, gpu=gpu)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1, default=str)
    if "s" in rep:
        print(f"batching phase {rep['s']:.1f} s; host generation "
              f"{C.GEN_S}; TOTAL {rep['total_s']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
