"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out PATH]

Builds the port's CUDA kernels from the sources in this checkout (one
nvcc per source, started together) and holds each against its plain
PyTorch version at the shapes of its path:

* limb_partial_sums (the per-tile kernel) at TPC-H q1's shapes, and
  fused_limb_sums (limb split and per-group sums in one pass) on every
  lane kind, a ragged n with ids outside [0, G), G = 2, 16 and 64, and
  the worst case at the kernel's row limit; its batched entry
  fused_limb_sums_batched (the vmapped kernel's member axis, a tile of
  members a block) at B = 1, 3, 64, the tile's M - 1 and M + 1, and 65,
  G = 1, 5, 16 and 64, lanes shared and per member and the sources
  mixed (a per-member 128-bit pair, a per-member source under a shared
  mask, shared sources under member masks), a member with no row, two
  members at the row limit in one block each, and its refusals of a bad
  B or stride by return code;
* q1 (in both limb forms: narrow takes fused_limb_sums, wide the
  per-tile kernel) and q6 at scale factor 1 (6,000,000 lineitem rows)
  through `presto_tpu_torch.exec.run_query`; fused_limb_sums again on
  the very lanes q1 handed it, timed beside its plain version and the
  unfused path it replaces;
* contains_bytes bit for bit on SF1 lineitem.comment, SF10 part.type,
  periodic rows and edge cases (needle lengths across 4-byte words,
  bytes >= 0x80 and NUL over zero padding, unaligned bases, one row a
  tile, every length at every start, the refusals), timed by its
  kernel's device time; then its path: `expr.functions.contains_pattern`
  over the staged columns, checked against `_like`;
* TPC-H q3 and q14 at scale factor 10 (60,000,000 lineitem rows;
  joins, sorted group-by, top-N, LIKE, CASE) through `run_query`;
* the corpus: the 18 other TPC-H queries (q2, q4, q5, q7-q13, q15-q22;
  semi joins, left joins, AssignUniqueId, count(DISTINCT),
  OR/IN/COALESCE, year/substr/not, the supplier/partsupp/nation/region
  tables, min/max), the probes of q11 and q18 (the one constant moved
  that leaves them empty at SF1) and five statements of the reference's
  verifier corpus (INTERSECT, UNION, count(DISTINCT) over a varchar,
  RIGHT JOIN, FULL OUTER JOIN) at scale factor 1, each from the plan
  the reference prepared for it, through `run_query`; fused_limb_sums
  again on the lanes q9 handed it (32 groups), timed beside its plain
  version;
* the two-stage plans of q1 and q3 (the reference's add_exchanges:
  PARTIAL -> exchange -> FINAL, the exchange the identity on one
  device) at scale factor 1 against the numpy oracles; two-stage q1
  launches fused_limb_sums in its PARTIAL and its FINAL;
* the mesh (phase_mesh): four workers on the card
  (`make_mesh(4, devices=("cuda:0",) * 4)`), each REMOTE exchange
  moving rows between them: q1 at SF1 through the port's own
  add_exchanges against numpy_q1, fused_limb_sums launched in each
  worker's PARTIAL and FINAL, its execute timed in turns with
  one-device q1; q3 and q14 at SF10 with PARTITIONED joins against
  their oracles, each worker's rows received by each exchange (all
  non-zero), the reruns, the peak and execute; the 22 two-stage plans
  at SF1 against their single plans' committed rows;
* the aggregate statements of the committed corpus: the hash-slot
  group-by (min_by, max_by, checksum, corr, geometric_mean over 6.0M
  rows and 200,000 groups; a 524,288-slot table) alone and two-stage,
  the variance family and bool_or on the sorted path, approx_distinct
  grouped and global; doubles of the moments within rel 1e-9; then
  approx_percentile through group_by against numpy;
* the scalar function library (phase_functions): every statement of
  presto_tpu_torch/queries/functions.json
  (scripts/make_functions_corpus.py) at sf 0.01 against the reference's
  rows (the flat statements of its function tests: math, dates,
  timestamps and zones, strings, varbinary, JSON, regex, VALUES), and
  nine statements of the library over TPC-H columns at SF1 (a
  SampleNode among them) against the reference's SF1 rows, each with
  its execute time, host syncs, fused_limb_sums launches, peak memory
  and the wall time of its regex DFA scans and per-row host kernels;
* the nested half of the library (phase_nested): the 20 statements
  over arrays and lambdas of the function corpus at sf 0.01 against the
  reference's rows; fn_arrays (every nested name the reference's SQL
  plans) and fn_unnest (UNNEST WITH ORDINALITY of 6.0M arrays into 24M
  rows, then a group-by) at SF1 against the reference's SF1 rows, each
  launching fused_limb_sums; and 6,000,000-row maps (K 8), rows and a
  dictionary column built on the card, run through element_at,
  cardinality, map_keys, map_values, the map lambdas, row_field, an
  unnest of the map and a group-by over the dictionary, each held to
  the port's CPU result on the same tensors;
* the 99 TPC-DS queries (phase_tpcds): each at its suite scale factor
  against the reference's rows committed in
  presto_tpu_torch/queries/tpcds.json (scripts/make_tpcds_corpus.py),
  each timed at SF1 (q72 at 0.2), and the 22 with a Window or GroupId
  node held to the port's own CPU rows of the same SF1 plan, computed
  by worker processes (--tpcds-cpu-rows) that run beside the card's
  last phases;
* exec/ off the main path (phase_exec): dynamic filtering on and off
  in pairs on every SF1 TPC-H corpus entry in which it finds a filter,
  q3 and q14 at SF10 and TPC-DS q3, q42, q52, q55 (equal rows, no more
  bytes staged on than off); q1's aggregation streamed in splits of
  4,194,304 rows at SF1 (against numpy_q1 and the unsplit run) and
  SF10 (its totals against numpy; the peaks); at SF1 the spilled
  aggregation (200,000 groups, 8
  buckets), the spilled join of lineitem and orders (4 buckets) and
  the external sort of orders, each against the unspilled run; CTAS
  of q1's lineitem columns into the memory connector, q1 over it
  (numpy_q1, one fused_limb_sums launch) and a DELETE;
* the port's own SQL front door (phase_sql): every corpus entry with
  SQL text planned and prepared through presto_tpu_torch.sql's
  planner (the 23 two-stage entries prepared for a mesh, through the
  port's add_exchanges), each plan equal to the committed one (the
  reference's);
  then statements typed as text through `presto_tpu_torch.sql` at SF1:
  q1 (one fused_limb_sums launch) and q6 against numpy, q3 and q14
  against the committed rows, TPC-DS q47 against the card's rows of
  its committed plan, two function statements against the reference's
  SF1 rows, q6 as PREPARE/EXECUTE, SHOW COLUMNS, and CTAS into
  memory.l, q1 over it (one launch) and DROP TABLE;
* the file connectors (phase_files): SF1 customer written as CSV,
  read through the localfile connector and joined with SF1 orders,
  grouped by market segment (5 groups, one fused_limb_sums launch),
  against the same statement over tpch.customer; where pyarrow
  imports, SF1 lineitem's q1 and q6 columns written as parquet (row
  groups of 1,048,576 rows): q1 and q6 as text over parquet.lineitem
  against numpy_q1 and numpy_q6, a count whose orderkey range prunes
  row groups, a CTAS of q1's columns into parquet and q1 over it, and
  q6 over an ORC copy, each with its row groups read and decode ms
  (without pyarrow the import error is printed and those parts alone
  are skipped);
* the statement tier (phase_statement): a StatementServer on the card
  answering the full q1 text at SF1 over POST /v1/statement (its
  rendered rows against numpy_q1, one fused_limb_sums launch equal to
  the plain version, the wall from the POST to the last nextUri
  against sql() in turns), q6 through a DB-API cursor, START
  TRANSACTION and COMMIT, SHOW CATALOGS, system.queries, and a
  rejection by a full resource-group queue; after its q1 the server's
  ledger routes (/v1/metrics, /v1/cluster, /v1/profile, /v1/history,
  /v1/datapath, /v1/accuracy, /v1/timeline) and q1's trace
  (/v1/trace/{queryId}) are read, no new query run;
* the observability ledgers (phase_observe): q1 at SF1 through
  run_query with every ledger on (rows against numpy_q1, one
  fused_limb_sums launch equal to the plain version), its stage walls
  (staging, compile, execute, fetch), datapath hops, timeline
  occupancy and bubble verdict, profiler row and estimate-vs-actual
  records printed; the ledgers on against off (continuous_profiling
  and timeline off) in 3 pairs in turns, run_query_ms, host syncs and
  launches of each (launches equal, the fewest syncs of each mode
  equal); EXPLAIN
  ANALYZE of q1 and q3 from their text at SF1, every section present;
* concurrent-query batching (phase_batching, scripts/batching_phase.py):
  the lookup, dashboard and lineitem families of scripts/loadgen.py and
  a dashboard grouped and ordered by a DOUBLE (price bands, the
  hash-slot group-by) at SF1 as formed batches of 5 and 64 through
  BatchingExecutor.bench_dispatch, each batch ONE program over a
  member axis (torch.func.vmap of the template), every member against a
  numpy oracle, four a family against their serial run_query bit for
  bit, fused_limb_sums_batched launched once per dashboard and lineitem
  batch and fused_limb_sums never (each batch of 5's launch against the
  plain version), no error or overflow collapse, the scans staged once
  a batch, the host syncs of a batch equal at both sizes, the batch's
  device ops and memory peak; a batch of three dashboard statements
  formed by the statement server's threads, and the dashboard with
  fusion off through the region executor; then the kernel rows of
  fused_limb_sums_batched on the lanes of the dashboard's and of the
  lineitem family's batches of 64 (against their plain versions and 64
  fused_limb_sums launches);
* the kernel audit and buffer donation (phase_audit,
  scripts/audit_phase.py): q1 at SF1 with `kernel_audit` on (the
  audit's seconds on a memo miss and a hit, rows equal to the
  unaudited run's, fused_limb_sums launched by the audit's run and by
  the dispatch, no finding), q1's closure traced under torch's sync
  debug mode (K002's host round trips equal to the syncs it counts;
  K005's estimate at most the allocator's peak; every K002 site, and
  agg_hash's exit-flag read, a site of the static lint's H001), the
  corpus gate over
  the 22 TPC-H queries at sf 0.1 on the local, mesh and batch tiers
  against the committed baseline (q1's batch trace records the
  fused_limb_sums_batched launch), and the phase_batching dashboard
  and TPC-H q10 with fusion off, buffer donation on against off in
  turns (equal rows, peak MB);
* with the lock-order witness (utils/locks.py) armed around both, 0
  violations required, and every ordered pair it sees an edge of the
  static lock graph (presto_tpu_torch/lint/LOCK_ORDER.json, the lint's
  C002 artifact):
* the worker tier (phase_cluster): a DiscoveryServer and two
  HTTP workers (presto_tpu_torch.server.TpuWorkerServer) on the card,
  the Coordinator scheduling plan fragments on the workers discovery
  finds, rows moving between them as SerializedPages over HTTP: q1 at
  SF1 through distribute_simple_agg (each worker's PARTIAL over its
  half of lineitem launches fused_limb_sums once, the FINAL over the
  pulled pages 1-3 times; one call of each against the plain version),
  in turns with q1 on one device; q3 at SF1 with PARTITIONED joins
  across the workers against numpy_q3, then the serde on its largest
  task's pages (pack and unpack by the host library against numpy in
  turns, and lz4 against zstd: bytes, serialize and decode ms); q1
  from add_exchanges (HASH exchange, FINAL, a SORTED gather merged on
  the host) against numpy_q1 in order; "all_at_once" against
  "phased"; a task failed once by the worker.run_task failpoint and
  retried; and a worker in a child process (`chip_smoke.py --cluster-worker URL`). Each task's
  rows, page bytes, pages pulled, serialize and pull ms and execute ms
  are printed, and the coordinator's wall; after q1 the coordinator's
  merged QueryStats and its stitched trace (task spans from both
  workers) are checked and both workers' ledger routes read;
* the cluster operations (phase_fleet, last), q1 at SF1 throughout:
  discovery, two workers on the card and the Coordinator with one
  shared secret (JWT bearers) and TLS where cryptography imports, q1
  through distribute_simple_agg with lz4 pages (5 fused_limb_sums
  launches; the first lz4 page round trips), a request without a
  bearer answered 401, a task's status as thrift against its JSON;
  q1's PARTIALs on both workers, then a drain of one into the other
  (POST /v1/worker/drain): its lz4 pages migrated once (stream
  checksums), DRAINED, out of alive_nodes, and the FINAL pulling them
  through the redirect; a router in front of a primary and a standby statement server whose
  dispatchers admit against a resource manager: q1 through the router,
  then a wedged primary whose heartbeats are lost
  (coordinator.heartbeat_lapse) and the standby adopting its q1 once;
  a catalog server as the remote catalog rtpch (SHOW TABLES, DESCRIBE,
  row counts, a refused scan).

Each query runs once to climb its overflow ladder, then once more with
every kernel count set to 0 just before: that second run starts at the
capacities the first found, makes one attempt, and returns the rows, so
its counts (and the kernel calls captured from it) are those of the
path that produced the result.

q1, q3, q6 and q14 are checked against numpy oracles written here; the
corpus queries against the reference's own rows, committed in
presto_tpu_torch/queries/tpch_sf1.json (scripts/make_tpch_corpus.py).
Host tables are generated once per process and cached here. Prints a
JSON line per query, one JSON line with the kernel table, the card's
name and power limit, and as its last line {"ok": true, "device":
{...}}. Exits non-zero, printing no result, when there is no CUDA
device, when the package is missing, or when any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

SF = 1.0
SF_JOIN = 10.0  # q3 and q14: BASELINE config 2
Q1_CUTOFF = "1998-09-02"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1.979e15  # H100 SXM data sheet, dense int8 tensor cores
WARMUP = 3
REPEATS = 10
QUERY_REPEATS = 3


def _days(iso: str) -> int:
    return int((np.datetime64(iso) - np.datetime64("1970-01-01")).astype(int))


def _run(cmd):
    p = subprocess.run(cmd, capture_output=True, text=True)
    return (p.stdout + p.stderr).strip()


# ---------------------------------------------------------------------------
# plans, built from the port's own nodes
# ---------------------------------------------------------------------------

def q1_plan(connector="tpch", table="lineitem"):
    """TPC-H q1 over `connector`'s `table` (lineitem's columns)."""
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
    scan = TableScanNode(connector, table, cols,
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


Q3_DATE = "1995-03-15"
Q14_FROM, Q14_TO = "1995-09-01", "1995-10-01"


def q3_plan():
    """TPC-H q3 in the shape presto_tpu's prepare_plan(plan_sql(q3))
    gives it: lineitem probes orders, that result probes customer, then
    a sorted group-by on (orderkey, orderdate, shippriority) and a top 10
    by revenue desc, orderdate."""
    from presto_tpu_torch import types as T
    from presto_tpu_torch.connectors import tpch
    from presto_tpu_torch.expr import call, const, input_ref
    from presto_tpu_torch.ops.aggregation import AggSpec
    from presto_tpu_torch.plan import (AggregationNode, FilterNode, JoinNode,
                                       OutputNode, ProjectNode,
                                       TableScanNode, TopNNode)

    def scan(table, cols):
        return TableScanNode("tpch", table, cols,
                             [tpch.column_type(table, c) for c in cols])

    d2, d4 = T.decimal(12, 2), T.decimal(38, 4)
    day = const(_days(Q3_DATE), T.DATE)
    cust = FilterNode(scan("customer", ["custkey", "mktsegment"]),
                      call("eq", T.BOOLEAN, input_ref(1, T.varchar(10)),
                           const("BUILDING", T.varchar(8))))
    orders = FilterNode(scan("orders", ["orderdate", "shippriority",
                                        "custkey", "orderkey"]),
                        call("lt", T.BOOLEAN, input_ref(0, T.DATE), day))
    line = FilterNode(scan("lineitem", ["orderkey", "extendedprice",
                                        "discount", "shipdate"]),
                      call("gt", T.BOOLEAN, input_ref(3, T.DATE), day))
    j1 = JoinNode(line, orders, [0], [3], "inner", "partitioned", [0, 1, 2])
    j2 = JoinNode(j1, cust, [6], [0], "inner", "partitioned", [])
    revenue = call("multiply", d4, input_ref(1, d2),
                   call("subtract", T.decimal(38, 2), const(1, T.BIGINT),
                        input_ref(2, d2)))
    proj = ProjectNode(j2, [input_ref(0, T.BIGINT), input_ref(4, T.DATE),
                            input_ref(5, T.INTEGER), revenue])
    agg = AggregationNode(proj, [0, 1, 2], [AggSpec("sum", 3, d4)])
    order = ProjectNode(agg, [input_ref(0, T.BIGINT), input_ref(3, d4),
                              input_ref(1, T.DATE), input_ref(2, T.INTEGER),
                              input_ref(1, T.DATE)])
    top = TopNNode(order, [(1, True, True), (4, False, True)], 10)
    out = ProjectNode(top, [input_ref(0, T.BIGINT), input_ref(1, d4),
                            input_ref(2, T.DATE), input_ref(3, T.INTEGER)])
    return OutputNode(out, ["orderkey", "revenue", "orderdate",
                            "shippriority"])


def q14_plan():
    """TPC-H q14 in the shape presto_tpu's prepare_plan(plan_sql(q14))
    gives it: lineitem probes part, CASE WHEN type LIKE 'PROMO%', two
    keyless 128-bit sums and a division to double."""
    from presto_tpu_torch import types as T
    from presto_tpu_torch.connectors import tpch
    from presto_tpu_torch.expr import call, const, input_ref, special
    from presto_tpu_torch.ops.aggregation import AggSpec
    from presto_tpu_torch.plan import (AggregationNode, FilterNode, JoinNode,
                                       OutputNode, ProjectNode,
                                       TableScanNode)

    def scan(table, cols):
        return TableScanNode("tpch", table, cols,
                             [tpch.column_type(table, c) for c in cols])

    d2, d4 = T.decimal(12, 2), T.decimal(38, 4)
    ship = input_ref(3, T.DATE)
    line = FilterNode(
        scan("lineitem", ["extendedprice", "discount", "partkey",
                          "shipdate"]),
        special("AND", T.BOOLEAN,
                call("ge", T.BOOLEAN, ship, const(_days(Q14_FROM), T.DATE)),
                call("lt", T.BOOLEAN, ship, const(_days(Q14_TO), T.DATE))))
    join = JoinNode(line, scan("part", ["type", "partkey"]), [2], [1],
                    "inner", "partitioned", [0])
    revenue = call("multiply", d4, input_ref(0, d2),
                   call("subtract", T.decimal(38, 2), const(1, T.BIGINT),
                        input_ref(1, d2)))
    promo = call("like", T.BOOLEAN, input_ref(4, T.varchar(25)),
                 const("PROMO%", T.varchar(6)))
    case = special("SWITCH", d4, const(True, T.BOOLEAN),
                   special("WHEN", d4, promo, revenue),
                   call("cast", d4, const(0, T.BIGINT)))
    agg = AggregationNode(ProjectNode(join, [case, revenue]), [],
                          [AggSpec("sum", 0, d4), AggSpec("sum", 1, d4)])
    ratio = call("divide", T.DOUBLE,
                 call("multiply", T.decimal(38, 6),
                      const(10000, T.decimal(38, 2)), input_ref(0, d4)),
                 input_ref(1, d4))
    return OutputNode(ProjectNode(agg, [ratio]), ["promo_revenue"])


# ---------------------------------------------------------------------------
# numpy oracles (independent of the engine's code)
# ---------------------------------------------------------------------------

def _avg(s: int, c: int) -> int:
    """Decimal average at the input's scale, rounded half away from 0."""
    q = (2 * abs(s) + c) // (2 * c)
    return q if s >= 0 else -q


def numpy_q1(t):
    cols = t["lineitem"]
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


def numpy_q6(t):
    cols = t["lineitem"]
    ship, disc = cols["shipdate"], cols["discount"]
    m = ((ship >= _days("1994-01-01")) & (ship < _days("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (cols["quantity"] < 2400))
    return [(int((cols["extendedprice"][m] * disc[m]).sum()),)]


def numpy_q3(t):
    """Top 10 orders by revenue: BUILDING customers, orders before and
    lineitems shipped after 1995-03-15. Keys are dense (key = row + 1);
    revenue ties break by orderdate, then by orderkey, as the engine's
    stable top-N over its key-ordered group table does."""
    day = _days(Q3_DATE)
    li, od, cu = t["lineitem"], t["orders"], t["customer"]
    building = np.concatenate([[False], cu["mktsegment"] == "BUILDING"])
    o_ok = (od["orderdate"] < day) & building[od["custkey"]]
    ok = (li["shipdate"] > day) & o_ok[li["orderkey"] - 1]
    okey = li["orderkey"][ok]
    rev = li["extendedprice"][ok] * (100 - li["discount"][ok])
    order = np.argsort(okey, kind="stable")
    okey, rev = okey[order], rev[order]
    first = np.flatnonzero(np.r_[True, okey[1:] != okey[:-1]])
    keys, sums = okey[first], np.add.reduceat(rev, first)
    date = od["orderdate"][keys - 1]
    top = np.lexsort((keys, date, -sums))[:10]
    return [(int(keys[i]), int(sums[i]), int(date[i]),
             int(od["shippriority"][keys[i] - 1])) for i in top]


def _to_f64(v: int, scale: int) -> float:
    """A long decimal to double as both packages convert it: through
    its magnitude's 64-bit words, each rounded once."""
    m = abs(v)
    f = float(m >> 64) * 2.0 ** 64 + float(m & ((1 << 64) - 1))
    return (-f if v < 0 else f) / 10 ** scale


def numpy_q14(t):
    """100 * promo revenue / revenue for lineitems shipped in 1995-09,
    computed exactly in integers and converted to double as the engine
    converts decimal(38, 6) / decimal(38, 4)."""
    li, part = t["lineitem"], t["part"]
    ship = li["shipdate"]
    ok = (ship >= _days(Q14_FROM)) & (ship < _days(Q14_TO))
    rev = li["extendedprice"][ok] * (100 - li["discount"][ok])
    promo = np.char.startswith(part["type"].astype(str), "PROMO")
    is_promo = promo[li["partkey"][ok] - 1]
    s_promo, s_all = int(rev[is_promo].sum()), int(rev.sum())
    if s_all == 0:
        return [(None,)]
    return [(_to_f64(10000 * s_promo, 6) / _to_f64(s_all, 4),)]


def _plain_rows(res):
    return [tuple(v.item() if isinstance(v, np.generic) else v for v in row)
            for row in res.rows()]


def _exact_rows(res):
    """A result's rows in the corpus's exact form."""
    from presto_tpu_torch.queries import exact_rows
    return exact_rows(res.columns, res.nulls, res.types, res.row_count)


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


def device_times(fns, kernel, repeats=REPEATS, tries=3):
    """Median device milliseconds of each fn's kernel, the CUDA kernel
    whose name holds `kernel` (each call of each fn launches one): every
    fn called once to warm up, then `repeats` times each, one fn after
    the other, in a single torch.profiler window (a process that opens
    many windows finds them dropping kernels). Before each group, and
    after the last, the window syncs, pauses 2 ms and launches a marker
    (torch.cuda._sleep's spin_kernel); the kernels are split into groups
    at the markers, not at gaps in time, so a host that stalls between
    two launches cannot split a group. The window opens with two
    unmeasured calls and closes with one (a trace that is starting can
    miss a kernel), which fall outside the markers. A window counts if
    it shows every marker and every group holds `repeats` kernels; up
    to `tries` windows are taken for one. If none counts, the last
    window that shows every marker and at least half of each group
    stands (a kernel the trace dropped leaves its group short, and the
    median of the rest is still its time); else this raises. The
    garbage collector is paused meanwhile: a collection over the cached
    host tables (millions of str objects) stalls the host."""
    import gc
    import torch
    from torch.profiler import ProfilerActivity, profile

    def mark():
        torch.cuda.synchronize()
        time.sleep(0.002)
        torch.cuda._sleep(1000)

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    fallback, seen = None, []
    gc.disable()
    try:
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fns[0]()
                fns[0]()
                for fn in fns:
                    mark()
                    for _ in range(repeats):
                        fn()
                mark()
                fns[-1]()
                torch.cuda.synchronize()
            events = sorted(
                (e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and (kernel in e.name or "spin_kernel" in e.name)),
                key=lambda e: e.time_range.start)
            groups = None  # the kernels before the first marker: unmeasured
            markers = 0
            for e in events:
                if "spin_kernel" in e.name:
                    markers += 1
                    groups = [] if groups is None else groups
                    groups.append([])
                elif groups is not None:
                    groups[-1].append(e)
            groups = (groups or [])[:-1]  # after the last marker: unmeasured
            seen.append([len(g) for g in groups])
            if markers != len(fns) + 1:
                continue
            times = [statistics.median(e.time_range.elapsed_us() / 1e3
                                       for e in g) if g else None
                     for g in groups]
            if all(len(g) == repeats for g in groups):
                return times
            if all(2 * len(g) >= repeats and len(g) <= repeats
                   for g in groups):
                fallback = times
    finally:
        gc.enable()
    if fallback is not None:
        print(f"device_times {kernel}: groups of {seen} launches in "
              f"{tries} windows, not {len(fns)} of {repeats}; the last "
              "window with at least half of each stands")
        return fallback
    raise AssertionError(f"the profiler saw groups of {seen} launches of "
                         f"{kernel} in {tries} windows, not {len(fns)} of "
                         f"{repeats}")


def device_ms(fn, kernel, repeats=REPEATS):
    """Median device milliseconds of fn()'s kernel (device_times)."""
    return device_times([fn], kernel, repeats)[0]


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
    """Print the toolchain and the card; build every kernel, one nvcc per
    source, all started together. Returns the build seconds."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from presto_tpu_torch.ops import kernels as K
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(_run([K._nvcc(), "--version"]).splitlines()[-1])
    print(f"gpu: {_run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'])}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(K.KERNELS)) as pool:
        built = list(pool.map(K.build_library, K.KERNELS))
    build_s = time.perf_counter() - t0
    for so in built:
        print(f"built {os.path.basename(so)}")
        with open(so[:-3] + ".log") as f:
            print(f.read().strip())
    print(f"kernels built in {build_s:.1f} s")
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


def _fused_lanes(n, groups, gen, dev, extreme=0):
    """(ids, sources, requests) of fused_limb_sums on every lane kind:
    random ids in [-2, G + 2) and random values, or with extreme = +1 /
    -1 every row in group G - 1 and every lane at its maximum / minimum
    (the 128-bit pair at +-(10^38 - 1)). Requests: a count, whole-lane
    sums, and the 13-bit limb splits of every lane (the descriptors of
    the port's 128-bit sums), masked and not."""
    import torch
    from presto_tpu_torch.ops import kernels as K
    R = K.LimbRequest
    if extreme:
        ids = torch.full((n,), groups - 1, dtype=torch.int32, device=dev)
    else:
        ids = torch.randint(-2, groups + 2, (n,), generator=gen, device=dev,
                            dtype=torch.int32)
    sources = []
    for dt in (torch.int8, torch.int16, torch.int32, torch.int64):
        info = torch.iinfo(dt)
        if extreme:
            v = torch.full((n,), info.max if extreme > 0 else info.min,
                           dtype=dt, device=dev)
        else:
            v = torch.randint(info.min, info.max, (n,), generator=gen,
                              device=dev, dtype=torch.int64).to(dt)
        sources.append(v)
    big = 10 ** 38 - 1
    if extreme:
        x = big if extreme > 0 else -big
        hi = torch.full((n,), x >> 64, dtype=torch.int64, device=dev)
        lo_bits = x & ((1 << 64) - 1)
        lo = torch.full((n,), lo_bits - (1 << 64) if lo_bits >> 63
                        else lo_bits, dtype=torch.int64, device=dev)
        mask = torch.ones(n, dtype=torch.bool, device=dev)
    else:
        hi = torch.randint(-(1 << 62), 1 << 62, (n,), generator=gen,
                           device=dev)
        lo = torch.randint(-(1 << 63), (1 << 63) - 1, (n,), generator=gen,
                           device=dev)
        mask = torch.rand(n, generator=gen, device=dev) < 0.6
    sources += [(hi, lo), mask]
    reqs = [R(5, -1, 0, 1, True)]
    for i, width in enumerate((8, 16, 32, 64, 128)):
        if width <= 64:
            reqs.append(R(i, 5, 0, width, True))
        nl = -(-width // 13)
        reqs += [R(i, 5 if k % 2 else -1, 13 * k, 13, k == nl - 1)
                 for k in range(nl)]
    return ids, sources, reqs


def _source_bytes(ids, sources):
    return ids.numel() * 4 + sum(
        t.numel() * t.element_size() for s in sources
        for t in (s if isinstance(s, tuple) else (s,)))


def check_fused(ids, sources, reqs, groups, what, **kw):
    """fused_limb_sums against its plain version, bit for bit; returns
    the max abs error (0)."""
    import torch
    from presto_tpu_torch.ops import kernels as K
    got = K.fused_limb_sums(ids, sources, reqs, groups, **kw)
    want = K.fused_limb_sums_reference(ids, sources, reqs, groups)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:8].tolist()
        raise AssertionError(f"fused_limb_sums {what} {kw}: differs at "
                             f"(group, request) {bad}")
    print(f"fused_limb_sums exact: {what} {kw}")
    return err


def _member_lanes(ids, sources, groups, batch, gen, empty=None):
    """The lanes of _fused_lanes as a batch of `batch` members: the ids,
    the int64 lane and the mask per member ((batch, n), each member's
    own draw), the other lanes shared ((n,)); member `empty`, if any,
    has no row in [0, G) and a mask that is all False."""
    import torch
    n, dev = ids.shape[0], ids.device
    ids_b = torch.randint(-2, groups + 2, (batch, n), generator=gen,
                          device=dev, dtype=torch.int32)
    i64 = torch.randint(-(1 << 63), (1 << 63) - 1, (batch, n),
                        generator=gen, device=dev)
    mask = torch.rand((batch, n), generator=gen, device=dev) < 0.6
    if empty is not None:
        ids_b[empty] = -1
        mask[empty] = False
    out = list(sources)
    out[3], out[5] = i64, mask
    return ids_b, out


def _mixed_member_lanes(ids, sources, reqs, groups, batch, gen, empty=None,
                        member_pair=True):
    """The lanes of _fused_lanes as a batch whose sources mix the ways
    the batched entry takes them: the ids, the int32 lane and (with
    `member_pair`) the 128-bit pair per member, the int8, int16 and
    int64 lanes, the mask (and the pair) shared, and a second mask per
    member (a seventh source); the
    requests of _fused_lanes (so a per-member source under the shared
    mask) and more under the member mask: a count of it, shared sources
    and the shared pair's fields under it. Member `empty`, if any, has
    no row in [0, G) and a member mask that is all False."""
    import torch
    from presto_tpu_torch.ops import kernels as K
    R = K.LimbRequest
    n, dev = ids.shape[0], ids.device
    ids_b = torch.randint(-2, groups + 2, (batch, n), generator=gen,
                          device=dev, dtype=torch.int32)
    i32 = torch.randint(-(1 << 31), (1 << 31) - 1, (batch, n),
                        generator=gen, device=dev).to(torch.int32)
    hi = torch.randint(-(1 << 62), 1 << 62, (batch, n), generator=gen,
                       device=dev)
    lo = torch.randint(-(1 << 63), (1 << 63) - 1, (batch, n),
                       generator=gen, device=dev)
    mask2 = torch.rand((batch, n), generator=gen, device=dev) < 0.4
    if empty is not None:
        ids_b[empty] = -1
        mask2[empty] = False
    out = list(sources)
    out[2] = i32
    if member_pair:
        out[4] = (hi, lo)
    out.append(mask2)
    more = [R(6, -1, 0, 1, True), R(0, 6, 0, 8, True),
            R(3, 6, 13, 13, False), R(3, 6, 52, 12, True),
            R(1, 6, 0, 16, True), R(4, 6, 64, 13, False),
            R(4, 6, 117, 11, True)]
    return ids_b, out, list(reqs) + more


def fused_plan():
    """What the last launch of fused_limb_sums.cu chose: members a tile,
    tiles, items a warp, work items, shared memory, blocks an SM, chunk
    ranges, classes of shared columns."""
    import ctypes
    from presto_tpu_torch.ops import kernels as K
    got = (ctypes.c_int * 8)()
    K._library("fused_limb_sums").fused_limb_sums_last_plan(got)
    return dict(zip(("members", "tiles", "items_a_warp", "items", "smem",
                     "blocks_per_sm", "chunk_ranges", "classes"), list(got)))


def check_fused_batched(ids, sources, reqs, groups, batch, what, **kw):
    """fused_limb_sums_batched against its plain version (the members'
    plain versions, stacked), bit for bit; returns the max abs error
    (0)."""
    import torch
    from presto_tpu_torch.ops import kernels as K
    got = K.fused_limb_sums_batched(ids, sources, reqs, groups, batch, **kw)
    want = K.fused_limb_sums_batched_reference(ids, sources, reqs, groups,
                                               batch)
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:8].tolist()
        raise AssertionError(f"fused_limb_sums_batched {what} {kw}: differs "
                             f"at (member, group, request) {bad}")
    print(f"fused_limb_sums_batched exact: {what} {kw}; plan "
          f"{fused_plan()}")
    return err


def check_batched_refusals(groups=16):
    """The batched C entry refuses, by its return code and before any
    launch, a batch outside [1, 65535], a negative member stride and
    strides that misalign a member's rows."""
    import ctypes
    import torch
    from presto_tpu_torch.ops import kernels as K
    lib = K._library("fused_limb_sums")
    n = 4096
    ids = torch.zeros(n, dtype=torch.int32, device="cuda")
    v = torch.zeros(n, dtype=torch.int32, device="cuda")
    out = torch.zeros((4, groups, 1, 5), dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(batch, ids_stride, lane_stride):
        ptrs = (ctypes.c_void_p * 2)(v.data_ptr(), v.data_ptr())
        strides = (ctypes.c_longlong * 2)(lane_stride, 0)
        return lib.fused_limb_sums_batched(
            ids.data_ptr(), ids_stride, n, groups, 1, ptrs, strides,
            (ctypes.c_int * 1)(3), 1, (ctypes.c_int * 5)(0, -1, 0, 32, 1),
            5, batch, out.data_ptr(), 0, stream)

    cases = {"batch 0": (call(0, 0, 0), -1),
             "batch 65536": (call(65536, 0, 0), -1),
             "a negative lane stride": (call(2, 0, -n), -1),
             "an ids stride of one row (4 bytes)": (call(2, 1, 0), -3),
             "a lane stride of 3 rows (12 bytes)": (call(2, 0, 3), -3)}
    for what, (got, want) in cases.items():
        if got != want:
            raise AssertionError(f"fused_limb_sums_batched with {what}: "
                                 f"returned {got}, not {want}")
    torch.cuda.synchronize()
    if out.any():
        raise AssertionError("a refused batched call wrote its output")
    print(f"fused_limb_sums_batched refuses by return code: "
          f"{ {k: g for k, (g, _w) in cases.items()} }")


def phase_fused(seed):
    """fused_limb_sums against its plain version on the card: every
    lane kind at a ragged n with ids outside [0, G) for G = 2, 16 and
    64, and the worst case: every row in one group, every lane at its
    extreme, one block summing the kernel's row limit. Then its batched
    entry, fused_limb_sums_batched, against its plain version: B = 1, 3
    and 64, lanes shared and per member (a ragged n, whose per-member
    lanes the wrapper pads to aligned member strides), a member with no
    row, shared ids; the sources mixed (_mixed_member_lanes: a
    per-member 128-bit pair, a per-member source under a shared mask,
    shared sources under a member mask) at B = 64 (G 64), M - 1 and
    M + 1 (G 16; M the members of the kernel's tile at B = 64) and 65
    (G 1); two members at the row limit in one block each; and its
    refusals by return code."""
    import torch
    from presto_tpu_torch.ops import kernels as K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for groups in (2, 16, 64):
        n = 1_000_003
        ids, sources, reqs = _fused_lanes(n, groups, gen, dev)
        check_fused(ids, sources, reqs, groups,
                    f"ragged n={n} G={groups} ids outside [0, G)")
        check_fused(ids[:777], [tuple(t[:777] for t in s)
                                if isinstance(s, tuple) else s[:777]
                                for s in sources], reqs, groups,
                    "n=777, one chunk, one block")
    n = K.FUSED_MAX_ROWS_PER_BLOCK
    for extreme in (1, -1):
        ids, sources, reqs = _fused_lanes(n, 64, gen, dev, extreme)
        check_fused(ids, sources, reqs, 64,
                    f"worst case {'max' if extreme > 0 else 'min'}: "
                    f"{n} rows in group 63, one block", blocks=1)
    del ids, sources
    torch.cuda.empty_cache()
    for batch, n, groups in ((1, 1_000_003, 16), (3, 1_000_003, 64),
                             (64, 100_003, 5)):
        ids, sources, reqs = _fused_lanes(n, groups, gen, dev)
        ids_b, member = _member_lanes(ids, sources, groups, batch, gen,
                                      empty=batch // 2)
        check_fused_batched(ids_b, member, reqs, groups, batch,
                            f"B={batch} n={n} G={groups}, ids, int64 lane "
                            f"and mask per member, member {batch // 2} "
                            "empty")
        check_fused_batched(ids, member, reqs, groups, batch,
                            f"B={batch} n={n} G={groups}, shared ids")
    del ids, ids_b, sources, member
    torch.cuda.empty_cache()
    # the sources mixed, B around the kernel's tile of members
    n = 100_003
    ids, sources, reqs = _fused_lanes(n, 16, gen, dev)
    ids_b, member, mreqs = _mixed_member_lanes(ids, sources, reqs, 16, 64,
                                               gen, empty=5,
                                               member_pair=False)
    check_fused_batched(ids_b, member, mreqs, 16, 64,
                        f"B=64 n={n} G=16, sources mixed, member 5 empty")
    m = fused_plan()["members"]
    for batch, groups, n, pair in ((max(m - 1, 1), 16, 300_007, False),
                                   (m + 1, 16, 300_007, False),
                                   (64, 64, 100_003, True),
                                   (65, 1, 100_003, False)):
        ids, sources, reqs = _fused_lanes(n, groups, gen, dev)
        ids_b, member, mreqs = _mixed_member_lanes(
            ids, sources, reqs, groups, batch, gen, empty=batch // 2,
            member_pair=pair)
        check_fused_batched(ids_b, member, mreqs, groups, batch,
                            f"B={batch} n={n} G={groups}, sources mixed"
                            f"{', the pair per member' if pair else ''}, "
                            f"member {batch // 2} empty (tile of {m} at "
                            "B=64, G=16)")
        check_fused_batched(ids, member, mreqs, groups, batch,
                            f"B={batch} n={n} G={groups}, sources mixed, "
                            "shared ids")
    del ids, ids_b, sources, member
    torch.cuda.empty_cache()
    # two members at the row limit, one block each: every row in group
    # 63, the shared lanes at their maximum, the member lanes at theirs
    n = K.FUSED_MAX_ROWS_PER_BLOCK
    ids, sources, reqs = _fused_lanes(n, 64, gen, dev, 1)
    ids_b = ids.expand(2, n).contiguous()
    member = list(sources)
    member[3] = sources[3].expand(2, n).contiguous()
    member[5] = sources[5].expand(2, n).contiguous()
    check_fused_batched(ids_b, member, reqs, 64, 2,
                        f"worst case max: 2 members of {n} rows in group "
                        "63, one block each", blocks=1)
    del ids, ids_b, sources, member
    torch.cuda.empty_cache()
    check_batched_refusals()


def _unfused_narrow(ids, contribs, groups):
    """The path fused_limb_sums replaces, from materialised requests:
    8-bit limbs stacked as an (n, L) int16 matrix, the per-tile kernel,
    the tiles added in int64 and the limbs recombined by shifts."""
    import torch
    from presto_tpu_torch.int128 import limbs_of_i64
    from presto_tpu_torch.ops import kernels as K
    cols, spans = [], []
    for x, bits in contribs:
        nl = max(-(-bits // 8), 1)
        spans.append((len(cols), nl))
        cols.extend(limbs_of_i64(x, 8, nl) if nl > 1 else [x])
    lm = torch.stack([c.to(torch.int16) for c in cols], dim=1)
    tot = K.limb_partial_sums(ids, lm, groups).to(torch.int64).sum(dim=0)
    shifts = 8 * torch.arange(max(nl for _, nl in spans), dtype=torch.int64,
                              device=ids.device)
    return torch.stack([(tot[:, a:a + nl] << shifts[:nl]).sum(dim=1)
                        for a, nl in spans], dim=1)


def fused_row(call, launches, query="q1"):
    """Time fused_limb_sums on the lanes `query` handed it on the main
    path, beside its plain version and the unfused path; the kernel
    table's row."""
    import torch
    from presto_tpu_torch.ops import kernels as K
    ids, sources, reqs, groups = call
    err = check_fused(ids, sources, reqs, groups, f"{query}'s own lanes")
    contribs = []
    for r in reqs:
        x = K.source_field(sources[r.source], r.shift, r.bits, r.remainder)
        if r.mask != -1:
            x = torch.where(sources[r.mask], x, 0)
        contribs.append((x, r.bits))
    want = K.fused_limb_sums(ids, sources, reqs, groups)
    if not torch.equal(_unfused_narrow(ids, contribs, groups), want):
        raise AssertionError("the unfused narrow path disagrees")
    call_ms = cuda_ms(lambda: K.fused_limb_sums(ids, sources, reqs, groups))
    ms = device_ms(lambda: K.fused_limb_sums(ids, sources, reqs, groups),
                   "fused_limb_sums_kernel")
    plain_ms = cuda_ms(lambda: K.fused_limb_sums_reference(
        ids, sources, reqs, groups))
    standin_ms = cuda_ms(lambda: _unfused_narrow(ids, contribs, groups))
    n = ids.shape[0]
    J = max(K.limb_count(r.bits) for r in reqs)
    nbytes = _source_bytes(ids, sources) + groups * len(reqs) * J * 8
    L = sum(K.limb_count(r.bits) for r in reqs)
    ops = 2 * n * (16 * -(-groups // 16)) * (8 * -(-L // 8))
    bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
    row = {
        "name": "fused_limb_sums",
        "form": f"narrow (s8 7-bit limbs, fused), {query}'s lanes",
        "route": "cuda",
        "source": "presto_tpu_torch/ops/csrc/fused_limb_sums.cu",
        "replaces": "presto_tpu/ops/pallas_kernels.py:141",
        "launches": launches, "max_abs_err": err, "exact": err == 0.0,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= ops / INT8_OPS_PER_S else "operations",
        "library_ms": None, "standin_ms": standin_ms,
        "call_ms": call_ms,
        "timing": "ms: the kernel's device time (torch.profiler); "
                  "call_ms: CUDA events around the wrapper call (zeroed "
                  "output, launch, limb recombination, host gaps); "
                  "plain_ms and standin_ms: CUDA events",
        "library": "none: no single PyTorch call splits limbs and sums "
                   "them per group; standin_ms is the unfused path it "
                   "replaces (8-bit limb split, torch.stack, the per-tile "
                   "kernel, the tile sum) from materialised requests",
        "shape": {"n": n, "G": groups, "requests": len(reqs), "L": L,
                  "sources": len(sources),
                  "bytes_per_row": _source_bytes(ids, sources) / n},
        "bytes": nbytes, "int8_ops": ops}
    print(f"fused_limb_sums on {query}'s lanes: kernel {ms:.4f} ms (device), "
          f"wrapper call {call_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, unfused stand-in {standin_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({row['bound_by']})")
    return row


def batched_row(call, launches, what="the dashboard's batch of 64",
                plain_repeats=3):
    """Time fused_limb_sums_batched on the lanes `what` handed it on the
    main path (phase_batching), beside its plain version (`plain_repeats`
    event-timed runs, no warm-up: the members' plain versions cost
    seconds) and the per-member form it replaces (B launches of
    fused_limb_sums, one a member, as the batched dispatch ran before it
    was one program); the kernel table's row."""
    import torch
    from presto_tpu_torch.ops import kernels as K
    ids, sources, reqs, groups, batch = call
    err = check_fused_batched(ids, sources, reqs, groups, batch,
                              f"{what}'s own lanes")

    def member(t, m):
        return t[m] if t.dim() == 2 else t

    members = [(member(ids, m),
                [tuple(member(t, m) for t in s) if isinstance(s, tuple)
                 else member(s, m) for s in sources]) for m in range(batch)]

    def per_member():
        return [K.fused_limb_sums(i, srcs, reqs, groups)
                for i, srcs in members]

    want = K.fused_limb_sums_batched(ids, sources, reqs, groups, batch)
    if not torch.equal(torch.stack(per_member()), want):
        raise AssertionError("the per-member launches disagree with the "
                             "batched entry")
    ms = device_ms(lambda: K.fused_limb_sums_batched(ids, sources, reqs,
                                                     groups, batch),
                   "fused_limb_sums_kernel")
    call_ms = cuda_ms(lambda: K.fused_limb_sums_batched(
        ids, sources, reqs, groups, batch))
    plan = fused_plan()  # what the batched entry chose for these lanes
    plain_ms = cuda_ms(lambda: K.fused_limb_sums_batched_reference(
        ids, sources, reqs, groups, batch), repeats=plain_repeats, warmup=0)
    standin_ms = cuda_ms(per_member)
    lanes = [ids] + [t for s in sources
                     for t in (s if isinstance(s, tuple) else (s,))]
    shared = [t for t in lanes if t.dim() == 1]
    J = max(K.limb_count(r.bits) for r in reqs)
    n = ids.shape[-1]
    # every lane read once: a shared lane once for all members
    nbytes = sum(t.numel() * t.element_size() for t in lanes) + \
        batch * groups * len(reqs) * J * 8
    L = sum(K.limb_count(r.bits) for r in reqs)
    ops = 2 * batch * n * (16 * -(-groups // 16)) * (8 * -(-L // 8))
    bound = max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3
    row = {
        "name": "fused_limb_sums_batched",
        "form": f"batched (the vmapped kernel's member axis, tiles of "
                f"members a block), {what}",
        "route": "cuda",
        "source": "presto_tpu_torch/ops/csrc/fused_limb_sums.cu",
        "replaces": "presto_tpu/ops/pallas_kernels.py:163",
        "launches": launches, "max_abs_err": err, "exact": err == 0.0,
        "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
        >= ops / INT8_OPS_PER_S else "operations",
        "library_ms": None, "standin_ms": standin_ms, "call_ms": call_ms,
        "timing": "ms: the kernel's device time (torch.profiler); "
                  "call_ms: CUDA events around the wrapper call; plain_ms "
                  f"(the members' plain versions, median of {plain_repeats} "
                  "runs, no warm-up) and standin_ms (B fused_limb_sums "
                  "launches, one a member): CUDA events",
        "plan": plan,
        "library": "none: no single PyTorch call splits limbs and sums "
                   "them per group and member; standin_ms is the "
                   "per-member form this entry replaces",
        "shape": {"B": batch, "n": n, "G": groups, "requests": len(reqs),
                  "L": L, "sources": len(sources),
                  "shared_lanes": len(shared),
                  "member_lanes": len(lanes) - len(shared)},
        "bytes": nbytes, "int8_ops": ops}
    print(f"fused_limb_sums_batched on {what}'s lanes (B={batch}, n={n}, "
          f"G={groups}, {len(reqs)} requests): kernel {ms:.4f} ms "
          f"(device), wrapper call {call_ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, {batch} fused_limb_sums launches {standin_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({row['bound_by']})")
    return row


def _count_syncs(fn, sites=None):
    """Host-device synchronizations fn() makes (torch's sync debug mode
    warns once per synchronizing call, in the thread that makes it).
    Only warnings raised while fn() runs count: the first call that
    turns the mode on in a process warns once itself. With a list
    `sites`, each sync appends its site: the thread's name and the
    innermost Python frames of the call (file:line function)."""
    import threading
    import torch
    count = [0]
    armed = [False]

    def hook(message, category, filename, lineno, file=None, line=None):
        if not armed[0] or "synchroniz" not in str(message):
            return
        count[0] += 1
        if sites is not None:
            frames = [f for f in traceback.extract_stack()[:-1]
                      if not f.filename.endswith("warnings.py")]
            sites.append(threading.current_thread().name + " | " + " < ".join(
                f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                for f in reversed(frames[-SYNC_SITE_FRAMES:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        armed[0] = True
        try:
            out = fn()
        finally:
            armed[0] = False
            torch.cuda.set_sync_debug_mode("default")
    return out, count[0]


# innermost Python frames kept for a sync's site (_count_syncs)
SYNC_SITE_FRAMES = 6


# host tables: generated once per process (the package generates them
# on every run_query; here the connector's entry point reads this cache)
_HOST = {}
GEN_S = {}


def host_columns(table, sf, columns, connector="tpch"):
    """{column: host array} of `connector`'s `table` at `sf`, each
    column generated once per process; seconds per table go to GEN_S."""
    import importlib
    generator = importlib.import_module(
        f"presto_tpu_torch.connectors.{connector}.generator")
    cache = _HOST.setdefault((connector, table, sf), {})
    missing = [c for c in columns if c not in cache]
    if missing:
        t0 = time.perf_counter()
        cache.update(generator.generate_columns(table, sf, missing))
        key = f"{table}@sf{sf:g}" if connector == "tpch" else \
            f"{connector}.{table}@sf{sf:g}"
        GEN_S[key] = GEN_S.get(key, 0.0) + time.perf_counter() - t0
    return {c: cache[c] for c in columns}


_ORACLE_ROWS = {}


def oracle_rows(oracle, tables, sf):
    """oracle({table: host columns}) at `sf`, computed once per process
    (numpy_q1 takes seconds at SF1, and phase_sql asks for it again)."""
    key = (oracle, sf)
    if key not in _ORACLE_ROWS:
        _ORACLE_ROWS[key] = oracle({t: host_columns(t, sf, cols)
                                    for t, cols in tables.items()})
    return _ORACLE_ROWS[key]


def install_host_cache():
    import importlib
    for connector in ("tpch", "tpcds"):
        module = importlib.import_module(
            f"presto_tpu_torch.connectors.{connector}")

        def cached(table, sf, columns, start=0, count=None,
                   connector=connector, generate=module.generate_columns):
            if start or count is not None:
                return generate(table, sf, columns, start, count)
            return host_columns(table, sf, columns, connector)

        module.generate_columns = cached


def as_built(plan, sf):
    """A hand-built plan as run_query ran it before it prepared plans
    itself: the scans' narrow lanes annotated, no other pass, so that
    its checks and times stay comparable with earlier runs. Run it with
    prepared=True, as the committed plans (which the reference
    prepared) are run."""
    from presto_tpu_torch.plan.widths import annotate_widths
    return annotate_widths(plan, sf)


def run_query_batches(root, sf, device="cuda"):
    """The batches run_query stages for the width-annotated `root`:
    each scan pruned by the dynamic filters run_query collects, so
    that execute is timed over the rows run_query runs (and at the
    capacities its ladder fitted to them)."""
    import torch
    from presto_tpu_torch.exec.dynfilter import collect_dynamic_filters
    from presto_tpu_torch.exec.runner import stage_scans
    dev = torch.device(device)
    return stage_scans(root, sf, dev, collect_dynamic_filters(root, sf, dev))


def _staged_bytes(batches):
    import torch
    return sum(t.numel() * t.element_size()
               for b in batches for col in b.columns
               for t in vars(col).values() if isinstance(t, torch.Tensor)) \
        + sum(b.active.numel() for b in batches)


@contextlib.contextmanager
def recording_fused():
    """Within the block, keep every call fused_limb_sums gets on the
    card (ids, sources, requests, groups); yields that list."""
    from presto_tpu_torch.ops import kernels as K
    fused, calls = K.fused_limb_sums, []

    def recording(ids, sources, requests, groups, **kw):
        if ids.is_cuda:
            calls.append((ids, sources, requests, groups))
        return fused(ids, sources, requests, groups, **kw)

    K.fused_limb_sums = recording
    try:
        yield calls
    finally:
        K.fused_limb_sums = fused


def phase_query(name, plan_fn, oracle, tables, sf, limb_forms=("narrow",),
                rows=_plain_rows, fused_calls=None, same=None,
                run_query_repeats=None, instrument=None,
                execute_repeats=QUERY_REPEATS):
    """Run one query through run_query on the card, per limb form: once
    to climb the overflow ladder, then once more, with every kernel
    count set to 0 just before, in one attempt at the capacities the
    first run found; check both runs' rows exactly against the oracle;
    then time it. The launches and host syncs are the second run's: the
    path that returned the rows. `tables` maps each scanned table to
    the columns the oracle reads; `rows` puts a result in the oracle's
    form; `fused_calls`, a list, gets the fused_limb_sums calls of the
    second runs; `same(got, want)` replaces exact equality of the rows;
    `run_query_repeats` 0 skips timing run_query (None: QUERY_REPEATS at
    SF1, one run above); `instrument`, a context manager factory that
    yields a dict, is entered around one more execute over the staged
    batches, and the dict goes to the report as "instrumented";
    `execute_repeats` timed executes follow one warm-up."""
    import torch
    from presto_tpu_torch.connectors import tpch
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.exec.runner import execute
    from presto_tpu_torch.ops import kernels as K
    from presto_tpu_torch.plan.widths import annotate_widths

    want = oracle_rows(oracle, tables, sf)
    rows_in = tpch.table_row_count("lineitem", sf)
    report = {"query": name, "sf": sf, "rows": rows_in, "launches": {},
              "first_run_launches": {}, "host_syncs": {},
              "first_run_host_syncs": {}, "capacity_reruns": {}}
    for form in limb_forms:
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        first, first_syncs = _count_syncs(
            lambda: run_query(as_built(plan_fn(), sf), sf=sf,
                              limb_form=form, prepared=True))
        first_ms = (time.perf_counter() - t0) * 1e3
        first_launches = dict(K.LAUNCHES)
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        with recording_fused() as calls:
            res, syncs = _count_syncs(
                lambda: run_query(as_built(plan_fn(), sf), sf=sf,
                              limb_form=form, prepared=True))
        launches = dict(K.LAUNCHES)
        if fused_calls is not None:
            fused_calls.extend(calls)
        del calls
        if res.stats["capacity_reruns"]:
            raise AssertionError(f"{name} ({form}) climbed the ladder again"
                                 f" after its first run: {res.stats}")
        for what, r in (("first run", first), ("counted run", res)):
            got = rows(r)
            if not (same(got, want) if same else got == want):
                raise AssertionError(
                    f"{name} ({form}, {what}) rows differ from the "
                    f"oracle:\n got  {got}\n want {want}")
        print(f"{name} ({form}) equals its oracle: {len(got)} rows; "
              f"kernel launches {launches} (first run, ladder included: "
              f"{first_launches}); host syncs {syncs} (first run "
              f"{first_syncs}); capacity reruns "
              f"{first.stats['capacity_reruns']} (largest factor "
              f"{first.stats['capacity_scale']}); first run_query "
              f"{first_ms:.1f} ms")
        report["launches"][form] = launches
        report["first_run_launches"][form] = first_launches
        report["host_syncs"][form] = syncs
        report["first_run_host_syncs"][form] = first_syncs
        report["capacity_reruns"][form] = \
            first.stats["capacity_reruns"]
        report.setdefault("first_run_query_ms", first_ms)
        report["capacity_scale"] = first.stats["capacity_scale"]
    report["result"] = [list(map(str, r)) for r in want]

    root = annotate_widths(plan_fn(), sf)
    batches = run_query_batches(root, sf)
    report["staged_mb"] = _staged_bytes(batches) / 1e6
    report["execute_ms_by_form"], report["peak_mb_by_form"] = {}, {}
    for form in limb_forms:
        ms = wall_ms(lambda: execute(root, batches, limb_form=form),
                     repeats=execute_repeats)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        execute(root, batches, limb_form=form)
        torch.cuda.synchronize()
        report["execute_ms_by_form"][form] = ms
        report["peak_mb_by_form"][form] = \
            torch.cuda.max_memory_allocated() / 1e6
    report["execute_ms"] = report["execute_ms_by_form"][limb_forms[0]]
    print(f"{name}: execute ms by form {report['execute_ms_by_form']}; peak "
          f"device MB (staged batches included) {report['peak_mb_by_form']}")
    if instrument is not None:
        with instrument() as stats:
            execute(root, batches, limb_form=limb_forms[0])
            torch.cuda.synchronize()
        report["instrumented"] = dict(stats)
    del batches
    torch.cuda.empty_cache()
    if run_query_repeats is None:
        run_query_repeats = QUERY_REPEATS if sf <= SF else 1
    report["rows_per_s_execute"] = rows_in / (report["execute_ms"] / 1e3)
    report["run_query_ms"] = report["rows_per_s_run_query"] = None
    if run_query_repeats:
        report["run_query_ms"] = wall_ms(lambda: run_query(
            as_built(plan_fn(), sf), sf=sf, prepared=True),
                                         repeats=run_query_repeats)
        report["rows_per_s_run_query"] = rows_in / (report["run_query_ms"]
                                                    / 1e3)
    print(f"{name}: staged {report['staged_mb']:.1f} MB; execute "
          f"{report['execute_ms']:.3f} ms ({report['rows_per_s_execute']:.0f}"
          f" rows/s); run_query (staging included, host generation cached) "
          f"{report['run_query_ms']} ms")
    print(json.dumps(report))
    torch.cuda.empty_cache()
    return report


ABSENT_WORD = b"zebra"  # in no generated comment
PERIODIC_W = 64
# rows of 'a' (PERIODIC_W wide, random lengths): both ends of every
# window match the first two needles' ends or first bytes, and the third
# passes the first/last-byte filter at every window and fails only at
# its 31st byte, so every window costs a confirmation of eight words
PERIODIC_NEEDLES = (b"aaab", b"aaaaaaaa", b"a" * 30 + b"ba")


def _planted(rng, n, w, needle, alphabet, zero_pad=False, share=0.3):
    """(chars (n, w) uint8, lengths (n,) int32): random bytes from
    `alphabet`, lengths in [-1, w + 1], the needle written at a random
    start in about `share` of the rows (crossing lengths[i] in some),
    and with zero_pad every byte past lengths[i] set to 0."""
    alphabet = np.frombuffer(bytes(alphabet), np.uint8)
    chars = alphabet[rng.integers(0, alphabet.size, (n, w))]
    lengths = rng.integers(-1, w + 2, n).astype(np.int32)
    L = len(needle)
    if 0 < L <= w:
        rows = np.flatnonzero(rng.random(n) < share)
        starts = rng.integers(0, w - L + 1, rows.size)
        chars[rows[:, None], starts[:, None] + np.arange(L)] = \
            np.frombuffer(needle, np.uint8)
    if zero_pad:
        chars[np.arange(w)[None, :] >= lengths[:, None]] = 0
    return chars, lengths


def _every_length_and_start(w, needle):
    """One row for every length in [-1, w + 1] and every start of the
    needle: the needle at that start over a background of '.'."""
    L = len(needle)
    cases = [(ln, s) for ln in range(-1, w + 2) for s in range(w - L + 1)]
    chars = np.full((len(cases), w), ord("."), np.uint8)
    lengths = np.array([ln for ln, _ in cases], np.int32)
    for i, (_, s) in enumerate(cases):
        chars[i, s:s + L] = np.frombuffer(needle, np.uint8)
    return chars, lengths


def _edge_cases(rng, max_w):
    """(what, chars (N, W) uint8, lengths (N,) int32, needle) on the
    host: the shapes and rules the kernel must get right beyond the
    main path's; max_w is the widest row the kernel takes."""
    def rand(n, w, lo=-1):
        return (rng.integers(97, 100, (n, w)).astype(np.uint8),
                rng.integers(lo, w + 2, n).astype(np.int32))
    out = []
    for what, n, w, needle in (
            ("n not a multiple of the tile", 1001, 7, b"ab"),
            ("needle length = W", 777, 5, b"abcab"),
            ("needle longer than W", 300, 5, b"abcabc"),
            ("empty needle", 600, 5, b""),
            ("W = 1", 513, 1, b"a"),
            ("many tiles, lengths past W", 100_003, 44, b"cab")):
        chars, lengths = rand(n, w)
        out.append((what, chars, lengths, needle))
    chars = np.zeros((4, 8), np.uint8)
    chars[:, :5] = np.frombuffer(b"PROMO", np.uint8)
    out.append(("matching bytes past lengths[i]", chars,
                np.array([5, 4, 3, 0], np.int32), b"PROMO"))
    # every needle length the word-wide scan treats apart: under, at and
    # past one word, two words, eight words, and the longest needle
    for L in (1, 2, 3, 4, 5, 7, 8, 9, 31, 32, 33, 1024):
        w = 40 if L <= 9 else 100 if L <= 33 else 1100
        n = 20_011 if L <= 9 else 5003 if L <= 33 else 301
        needle = bytes(rng.integers(97, 100, L).astype(np.uint8))
        out.append((f"needle length {L}", *_planted(rng, n, w, needle,
                                                   b"abc"), needle))
    # bytes >= 0x80 and NUL bytes in the needle, over zero-padded rows
    for w, needle, alphabet in (
            (37, b"\xff\x80\xc3\xa9", b"\x00\x80\xff\xc3\xa9"),
            (38, b"\x80", b"\x00\x7f\x80\xff"),
            (39, b"\x00", b"\x00a"),
            (39, b"a\x00", b"\x00a"),
            (38, b"\x00\x00\x00\x00\x00", b"\x00a"),
            (5, b"\x00\xff", b"\x00\xff")):
        out.append((f"needle {needle!r} over zero-padded rows, W = {w}",
                    *_planted(rng, 10_007, w, needle, alphabet,
                              zero_pad=True), needle))
    # rows of more windows than one step of a 32-lane group covers
    for w, needle in ((300, b"abc"), (2000, b"cabca")):
        out.append((f"W = {w}: several steps a row",
                    *_planted(rng, 3001, w, needle, b"abc"), needle))
    # wide rows: one row a tile, up to the widest the kernel takes
    for w, n in ((9000, 37), (max_w, 3)):
        out.append((f"W = {w}: one row a tile",
                    *_planted(rng, n, w, b"xyz", b"xyw", share=0.7),
                    b"xyz"))
    chars, lengths = _planted(rng, 1, 38, b"special", b"spe", share=1.0)
    out.append(("n = 1", chars, np.array([38], np.int32), b"special"))
    out.append(("n smaller than one tile",
                *_planted(rng, 100, 38, b"special", b"spe"), b"special"))
    out.append(("every length -1 .. W + 1 at every start",
                *_every_length_and_start(38, b"special"), b"special"))
    for needle in PERIODIC_NEEDLES:
        lengths = rng.integers(-1, PERIODIC_W + 2, 5003).astype(np.int32)
        out.append((f"periodic rows of 'a', needle {needle!r}",
                    np.full((5003, PERIODIC_W), ord("a"), np.uint8),
                    lengths, needle))
    return out


def _offset_copy(t, off):
    """t's values in a view `off` elements past the start of a fresh
    allocation (whose start is 16-byte aligned)."""
    import torch
    flat = torch.empty(t.numel() + off + 16, dtype=t.dtype, device=t.device)
    view = flat[off:off + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def _string_column(values, width):
    import torch
    from presto_tpu_torch import types as T
    from presto_tpu_torch.block import from_numpy
    return from_numpy(T.varchar(width), values, device=torch.device("cuda"))


def timed_contains_cases(rng):
    """(what, staged column, needle) of every shape contains_bytes is
    timed on: SF1 lineitem.comment with a frequent and an absent word,
    SF10 part.type with 'PROMO', and 1.0M periodic rows of 'a' (random
    lengths) with the costliest needle."""
    comment = _string_column(
        host_columns("lineitem", SF, ["comment"])["comment"], 44)
    ptype = _string_column(host_columns("part", SF_JOIN, ["type"])["type"],
                           25)
    periodic = _string_column(
        np.array(["a" * k for k in rng.integers(0, PERIODIC_W + 1,
                                                 1_000_000)], dtype=object),
        PERIODIC_W)
    return [("lineitem.comment SF1", comment, b"special"),
            ("lineitem.comment SF1", comment, ABSENT_WORD),
            ("part.type SF10", ptype, b"PROMO"),
            ("periodic rows of 'a'", periodic, PERIODIC_NEEDLES[-1])]


def phase_contains(seed):
    """contains_bytes against its plain version, bit for bit: edge
    cases (needle lengths across word edges, bytes >= 0x80 and NUL over
    zero padding, W not a multiple of 4, rows of several steps, one row
    a tile, n = 1, every length at every start, periodic rows, chars and
    lengths at unaligned addresses, the refusals), SF1 lineitem.comment
    with a frequent and an absent word, SF10 part.type with 'PROMO' and
    periodic rows with the costliest needle. Each timed by its kernel's
    device time beside the wrapper call. Then its path, contains_pattern
    over each column with the counts set to 0 just before, held against
    _like('%w%'). Returns the kernel table rows."""
    import torch
    from presto_tpu_torch.expr.compile import _like
    from presto_tpu_torch.expr.functions import contains_pattern
    from presto_tpu_torch.ops import kernels as K
    dev = torch.device("cuda")

    def check(chars, lengths, needle, what):
        got = K.contains_bytes(chars, lengths, needle)
        want = K.contains_bytes_reference(chars, lengths, needle)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        if bad:
            raise AssertionError(f"contains_bytes {what}: {bad} rows differ "
                                 "from the plain version")
        print(f"contains_bytes exact: {what} (N={chars.shape[0]}, "
              f"W={chars.shape[1]}, needle {needle[:12]!r}"
              f"{'...' if len(needle) > 12 else ''}): "
              f"{int(got.sum())} rows match")
        return float((got.to(torch.int8) - want.to(torch.int8)).abs().max()) \
            if got.numel() else 0.0

    rng = np.random.default_rng(seed)
    max_w = K._library("contains_bytes").contains_bytes_max_width()
    for what, chars, lengths, needle in _edge_cases(rng, max_w):
        c = torch.from_numpy(chars).to(dev)
        l = torch.from_numpy(lengths).to(dev)
        check(c, l, needle, what)
        if what.startswith("matching bytes past"):
            if K.contains_bytes(c, l, needle).tolist() != [True, False,
                                                          False, False]:
                raise AssertionError("bytes past lengths[i] matched")
        if what.startswith("many tiles"):
            # bases that are not 16-byte aligned: byte offsets of the
            # chars, element offsets of the lengths, and a row slice
            for off in (1, 3, 8, 15):
                check(_offset_copy(c, off), _offset_copy(l, off % 4), needle,
                      f"{what}, chars at +{off} B, lengths at "
                      f"+{4 * (off % 4)} B")
            big = torch.cat([c[:1], c])
            check(big[1:], l, needle, f"{what}, a row slice [1:] of an "
                  f"(N + 1, W) matrix (base at +{c.shape[1]} B)")
    # the C entry's refusals: a row one byte wider than it takes, and a
    # needle one byte longer (the wrapper raises ValueError on each code)
    lib = K._library("contains_bytes")
    for w, L, code in ((max_w + 1, 3, -3), (2000, 1025, -2)):
        c = torch.zeros((2, w), dtype=torch.uint8, device=dev)
        l = torch.full((2,), w, dtype=torch.int32, device=dev)
        out = torch.empty(2, dtype=torch.bool, device=dev)
        got = lib.contains_bytes_u8(
            c.data_ptr(), l.data_ptr(), b"a" * L, L, out.data_ptr(), 2, w,
            torch.cuda.current_stream().cuda_stream)
        if got != code:
            raise AssertionError(f"contains_bytes_u8 W={w}, L={L} returned "
                                 f"{got}, not {code}")
        print(f"contains_bytes refuses W={w}, L={L}: "
              f"{K._CONTAINS_REFUSED[code]}")

    cases = [(what, col, needle, True)
             for what, col, needle in timed_contains_cases(rng)]
    periodic = cases[-1][1]
    cases += [("periodic rows of 'a'", periodic, needle, False)
              for needle in PERIODIC_NEEDLES[:-1]]
    rows, paths, calls = [], [], []
    for what, col, needle, timed in cases:
        err = check(col.chars, col.lengths, needle, what)
        like = _like(col, f"%{needle.decode()}%")
        if not torch.equal(contains_pattern(col, needle), like):
            raise AssertionError(f"contains_pattern {what} {needle!r} "
                                 "differs from _like")
        if needle == ABSENT_WORD and bool(like.any()):
            raise AssertionError(f"{needle!r} found in {what}")
        if not timed:
            continue
        n, w = col.chars.shape

        def call(col=col, needle=needle):
            return K.contains_bytes(col.chars, col.lengths, needle)

        calls.append(call)
        call_ms = cuda_ms(call)
        plain_ms = cuda_ms(lambda: K.contains_bytes_reference(
            col.chars, col.lengths, needle))
        like_ms = cuda_ms(lambda: _like(col, f"%{needle.decode()}%"))
        nbytes = n * w + 5 * n
        paths.append((col, needle))
        rows.append({
            "name": "contains_bytes", "form": f"{what} {needle.decode()!r}",
            "route": "cuda",
            "source": "presto_tpu_torch/ops/csrc/contains_bytes.cu",
            "replaces": "presto_tpu/ops/pallas_kernels.py:76",
            "launches": 0, "max_abs_err": err, "exact": err == 0.0,
            "ms": None, "kernel_ms": None, "call_ms": call_ms,
            "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "like_ms": like_ms,
            "timing": "ms: the kernel's device time (torch.profiler); "
                      "call_ms: CUDA events around the wrapper call (checks, "
                      "output allocation, ctypes call, launch); plain_ms "
                      "and like_ms: CUDA events",
            "library": "none: no single PyTorch call computes substring "
                       "search; like_ms stands in: expr/compile.py::_like "
                       "('%w%'), the window-gather form",
            "shape": {"n": n, "W": w, "needle": needle.decode()},
            "bytes": nbytes})

    # the kernel's device time on every timed column, in one window
    for row, ms in zip(rows, device_times(calls, "contains_bytes_kernel")):
        row["ms"] = row["kernel_ms"] = ms
        print(f"contains_bytes {row['form']}: kernel {ms:.4f} ms (device), "
              f"wrapper call {row['call_ms']:.4f} ms, plain "
              f"{row['plain_ms']:.4f} ms, _like {row['like_ms']:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms")

    # the path: each row's own contains_pattern call, counted alone
    for row, (col, needle) in zip(rows, paths):
        for k in K.LAUNCHES:
            K.LAUNCHES[k] = 0
        contains_pattern(col, needle)
        torch.cuda.synchronize()
        row["launches"] = K.LAUNCHES["contains_bytes"]
        if row["launches"] < 1:
            raise AssertionError("contains_pattern never launched "
                                 "contains_bytes")
    print(f"contains_pattern path launches: "
          f"{[r['launches'] for r in rows]}")
    del cases, periodic, paths, calls
    torch.cuda.empty_cache()
    return rows


def _plan_nodes(j, kind):
    """Every node of `kind` ("aggregation", "tablescan", ...) in a plan's
    JSON."""
    if isinstance(j, dict):
        if j.get("@type") == kind:
            yield j
        for v in j.values():
            yield from _plan_nodes(v, kind)
    elif isinstance(j, list):
        for v in j:
            yield from _plan_nodes(v, kind)


def _small_keyed_aggs(plan_json):
    """max_groups of the plan's keyed aggregations that take the
    small-table group-by (fused_limb_sums) unless they overflow."""
    from presto_tpu_torch.ops.aggregation import SMALL_G
    return [a["maxGroups"] for a in _plan_nodes(plan_json, "aggregation")
            if a["groupChannels"] and a["maxGroups"] <= SMALL_G]


def _scanned_columns(plan_json):
    """{table: columns} the plan's scans read."""
    out = {}
    for scan in _plan_nodes(plan_json, "tablescan"):
        cols = out.setdefault(scan["table"], [])
        cols.extend(c for c in scan["columns"] if c not in cols)
    return out


# the corpus query whose fused_limb_sums lanes get a row of the kernel
# table beside q1's: 32 groups (25 live), n the rows of its last join
SECOND_G_QUERY = "q9"


def _corpus_order(name):
    """Queries in number order (a probe after its query), then the
    statements by name."""
    head = name.split("_")[0]
    if head[:1] == "q" and head[1:].isdigit():
        return 0, int(head[1:]), name
    return 1, 0, name


def phase_corpus():
    """Every query and probe of the committed SF1 corpus through
    run_query on the card (phase_query), its rows held equal to the
    reference's committed rows in exact form. A query with a small-table
    keyed aggregation in its plan must launch fused_limb_sums on the
    path that returns its rows; no query may launch contains_bytes.
    Returns the reports and the lanes SECOND_G_QUERY handed
    fused_limb_sums on that path."""
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.queries import load_corpus
    corpus = {k: v for k, v in load_corpus().items()
              if v.get("kind", "single") == "single"}
    reports, second_g = [], []
    for name in sorted(corpus, key=_corpus_order):
        entry = corpus[name]
        small = _small_keyed_aggs(entry["plan"])
        # the oracle generates the scanned tables before the first run,
        # as the numpy oracles of the other phases do
        rep = phase_query(name, lambda e=entry: from_json(e["plan"]),
                          lambda _t, e=entry: e["rows"],
                          _scanned_columns(entry["plan"]), entry["sf"],
                          rows=_exact_rows,
                          fused_calls=second_g if name == SECOND_G_QUERY
                          else None)
        launches = rep["launches"]["narrow"]
        rep["small_table_max_groups"] = small
        if launches["contains_bytes"]:
            raise AssertionError(f"{name} launched contains_bytes: "
                                 f"{launches}")
        if small and launches["fused_limb_sums"] < 1:
            raise AssertionError(f"{name} has small-table aggregations "
                                 f"{small} but its rows came from no "
                                 f"fused_limb_sums launch: {launches}")
        reports.append(rep)
    if not second_g:
        raise AssertionError(f"{SECOND_G_QUERY} handed fused_limb_sums "
                             "no lanes on the card")
    print("corpus: " + json.dumps(
        {r["query"]: {"rows": len(r["result"]),
                      "execute_ms": r["execute_ms"],
                      "first_run_query_ms": r["first_run_query_ms"],
                      "capacity_reruns": r["capacity_reruns"]["narrow"],
                      "fused_limb_sums": r["launches"]["narrow"][
                          "fused_limb_sums"]} for r in reports}))
    return reports, second_g[0]


# the two-stage plans run on one device, each held to its numpy oracle
# (the SQL q1 keeps columns 0-4 and 9 of numpy_q1's row); phase_mesh
# runs all 22 on four workers
TWO_STAGE_ONE_DEVICE = {
    "q1_two_stage": (lambda t: [r[:5] + r[9:] for r in numpy_q1(t)],
                     "Q1_TABLES"),
    "q3_two_stage": (lambda t: numpy_q3(t), "Q3_TABLES")}


def _summary(reports):
    return {r["query"]: {"rows": len(r["result"]),
                         "execute_ms": r["execute_ms"],
                         "first_run_query_ms": r["first_run_query_ms"],
                         "capacity_reruns": r["capacity_reruns"]["narrow"],
                         "host_syncs": r["host_syncs"]["narrow"],
                         "peak_mb": r["peak_mb_by_form"]["narrow"],
                         "fused_limb_sums": r["launches"]["narrow"][
                             "fused_limb_sums"]} for r in reports}


def phase_two_stage():
    """The reference's two-stage plan (add_exchanges: PARTIAL -> REMOTE
    exchange -> FINAL, partial TopN/Limit under a GATHER, MERGE over a
    local Sort) of q1 and q3 through run_query on one device, where
    every exchange is the identity (phase_query, run_query not timed),
    held to the numpy oracles. Each PARTIAL and FINAL with a keyed
    table of <= 64 groups launches fused_limb_sums: two-stage q1 twice.
    phase_mesh runs all 22 two-stage plans on four workers. Returns the
    reports."""
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.queries import load_corpus
    corpus = {k: v for k, v in load_corpus().items()
              if k in TWO_STAGE_ONE_DEVICE}
    reports = []
    for name in sorted(corpus, key=_corpus_order):
        entry = corpus[name]
        small = _small_keyed_aggs(entry["plan"])
        oracle, tables = TWO_STAGE_ONE_DEVICE[name]
        rep = phase_query(name, lambda e=entry: from_json(e["plan"]),
                          oracle, globals()[tables], entry["sf"],
                          run_query_repeats=0)
        launches = rep["launches"]["narrow"]
        rep["small_table_max_groups"] = small
        if launches["contains_bytes"]:
            raise AssertionError(f"{name} launched contains_bytes: "
                                 f"{launches}")
        if small and launches["fused_limb_sums"] < 1:
            raise AssertionError(f"{name} has small-table aggregations "
                                 f"{small} but its rows came from no "
                                 f"fused_limb_sums launch: {launches}")
        if name == "q1_two_stage" and launches["fused_limb_sums"] != 2:
            raise AssertionError("two-stage q1 must launch fused_limb_sums "
                                 f"in its PARTIAL and its FINAL: {launches}")
        reports.append(rep)
    if len(reports) != len(TWO_STAGE_ONE_DEVICE):
        raise AssertionError(f"{len(reports)} two-stage plans, not "
                             f"{len(TWO_STAGE_ONE_DEVICE)}")
    print("two-stage: " + json.dumps(_summary(reports)))
    return reports


# ---------------------------------------------------------------------------
# the mesh: four workers on one card
# ---------------------------------------------------------------------------

MESH_WORKERS = 4  # the four-chip layout; here all four share cuda:0
MESH_REPEATS = 5


def mesh_plan(plan, sf, join_strategy="broadcast"):
    """A hand-built plan as_built, distributed by the port's own
    add_exchanges, its ids relabelled as prepare_plan leaves them."""
    from presto_tpu_torch.plan import from_json, to_json
    from presto_tpu_torch.plan.distribute import add_exchanges
    return from_json(to_json(add_exchanges(
        as_built(plan, sf), join_strategy=join_strategy, sf=sf)))


@contextlib.contextmanager
def recording_received():
    """Within the block, each exchange's active rows received by each
    worker (parallel/exchange.py RECEIVED); yields the list of
    {"kind", "rows"} filled when the block ends."""
    from presto_tpu_torch.parallel import exchange as X
    X.RECEIVED, out = [], []
    try:
        yield out
        out.extend({"kind": kind, "rows": [int(c) for c in counts]}
                   for kind, counts in X.RECEIVED)
    finally:
        X.RECEIVED = None


def in_turns(fns, repeats=MESH_REPEATS):
    """{name: median host wall ms} of each synced fn(), one warm-up run
    each, then `repeats` rounds that run every fn once in turn."""
    import torch
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(repeats):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def mesh_q1(mesh, sf=SF):
    """q1 through the port's add_exchanges (PARTIAL -> hash exchange of
    the partial tables -> FINAL, a MERGE over the Sort) on the mesh: a
    first run for the ladder, then a counted run; both equal numpy_q1.
    Every worker's PARTIAL over its quarter of lineitem and every
    worker's FINAL over the states it received launch fused_limb_sums;
    the counted run must launch it once in each worker's PARTIAL. Then
    execute over staged batches against one-device q1, in turns."""
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.exec.runner import execute, stage_scans
    from presto_tpu_torch.ops import kernels as K
    want = oracle_rows(numpy_q1, Q1_TABLES, sf)
    root = mesh_plan(q1_plan(), sf)
    t0 = time.perf_counter()
    first = run_query(root, sf=sf, mesh=mesh, prepared=True)
    first_ms = (time.perf_counter() - t0) * 1e3
    _reset_launches()
    with recording_fused() as calls:
        res = run_query(root, sf=sf, mesh=mesh, prepared=True)
    launches = dict(K.LAUNCHES)
    for what, r in (("first run", first), ("counted run", res)):
        if _plain_rows(r) != want:
            raise AssertionError(f"mesh q1 ({what}) rows differ from "
                                 f"numpy_q1:\n got  {_plain_rows(r)}\n "
                                 f"want {want}")
    call_rows = [int(c[0].shape[0]) for c in calls]
    # the kernel against its plain version at the mesh's own shapes: one
    # worker's PARTIAL over its shard, one FINAL over received states
    partial_call = next(c for c in calls if c[0].shape[0] > 16 * mesh.size)
    final_call = next(c for c in calls if c[0].shape[0] <= 16 * mesh.size)
    plain_err = {
        "partial": check_fused(*partial_call, "mesh q1's PARTIAL lanes"),
        "final": check_fused(*final_call, "mesh q1's FINAL states")}
    del calls, partial_call, final_call
    partial = [n for n in call_rows if n > 16 * mesh.size]
    if len(partial) != mesh.size or \
            launches["fused_limb_sums"] != len(call_rows):
        raise AssertionError(
            f"mesh q1 must launch fused_limb_sums once in each of the "
            f"{mesh.size} workers' PARTIAL: rows of its calls {call_rows}, "
            f"launches {launches}")
    single = as_built(q1_plan(), sf)
    one_batches = run_query_batches(single, sf)
    mesh_batches = stage_scans(root, sf, mesh.devices[0], mesh=mesh)
    ms = in_turns({"one_device": lambda: execute(single, one_batches),
                   "mesh": lambda: execute(root, mesh_batches, mesh=mesh)})
    del one_batches, mesh_batches
    rep = {"query": "q1", "sf": sf, "rows": len(want),
           "first_run_query_ms": first_ms,
           "capacity_reruns": first.stats["capacity_reruns"],
           "exchange_slot_reruns": first.stats["exchange_slot_reruns"],
           "fused_limb_sums": launches["fused_limb_sums"],
           "fused_limb_sums_rows": call_rows,
           "fused_limb_sums_max_abs_err": plain_err,
           "launches": launches, "execute_ms": ms["mesh"],
           "one_device_execute_ms": ms["one_device"]}
    print(f"mesh q1: equals numpy_q1 ({len(want)} rows); fused_limb_sums "
          f"{launches['fused_limb_sums']} launches, of {call_rows} rows "
          f"(one in each worker's PARTIAL over its shard, then those of "
          f"each worker's FINAL over the states it received; a PARTIAL "
          f"and a FINAL call equal the plain version, max abs err "
          f"{plain_err}); execute "
          f"{ms['mesh']:.3f}"
          f" ms on {mesh.size} workers against {ms['one_device']:.3f} ms "
          f"on one device, in turns")
    return rep


def mesh_join(mesh, name, plan_fn, oracle, tables, sf=SF_JOIN):
    """A join query with PARTITIONED joins (both sides of each join
    repartitioned by its keys) on the mesh: run_query's rows against
    the oracle (its ladder climbed), then one execute over staged
    batches counting each worker's rows received by each exchange (all
    must be non-zero) and the device peak, then execute timed."""
    import torch
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.exec.runner import execute, stage_scans
    want = oracle_rows(oracle, tables, sf)
    root = mesh_plan(plan_fn(), sf, "partitioned")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = run_query(root, sf=sf, mesh=mesh, prepared=True)
    first_ms = (time.perf_counter() - t0) * 1e3
    first_peak = torch.cuda.max_memory_allocated() / 1e6
    if _plain_rows(first) != want:
        raise AssertionError(f"mesh {name} rows differ from the oracle:\n"
                             f" got  {_plain_rows(first)}\n want {want}")
    batches = stage_scans(root, sf, mesh.devices[0], mesh=mesh)
    staged_mb = _staged_bytes([b for ws in batches for b in ws]) / 1e6
    peak = {}
    with recording_received() as received, _peak_mb(peak):
        execute(root, batches, mesh=mesh)
    empty = [(i, e["kind"]) for i, e in enumerate(received)
             if not all(e["rows"])]
    if not received or empty:
        raise AssertionError(f"mesh {name}: an exchange left a worker "
                             f"without rows: {received}")
    ms = wall_ms(lambda: execute(root, batches, mesh=mesh), repeats=2)
    del batches
    torch.cuda.empty_cache()
    rep = {"query": name, "sf": sf, "join_distribution": "PARTITIONED",
           "rows": len(want), "first_run_query_ms": first_ms,
           "capacity_reruns": first.stats["capacity_reruns"],
           "capacity_scale": first.stats["capacity_scale"],
           "exchange_slot_reruns": first.stats["exchange_slot_reruns"],
           "received": received, "staged_mb": staged_mb,
           "execute_peak_mb_above_staged": peak["peak_mb"],
           "first_run_peak_mb": first_peak, "execute_ms": ms}
    print(f"mesh {name}: equals its oracle ({len(want)} rows); rows each "
          f"worker received per exchange {received}; capacity reruns "
          f"{rep['capacity_reruns']}, exchange slot reruns "
          f"{rep['exchange_slot_reruns']}; staged {staged_mb:.1f} MB, peak "
          f"{first_peak:.1f} MB in the first run, {peak['peak_mb']:.1f} MB "
          f"above the staged batches in execute; execute {ms:.1f} ms")
    return rep


def mesh_two_stage(mesh):
    """The committed two-stage plans of the 22 TPC-H queries (the
    reference's add_exchanges) on the mesh at their scale factor (SF1):
    each equal to the committed rows of its single plan, exactly."""
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.ops import kernels as K
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.queries import load_corpus
    corpus = {k: v for k, v in load_corpus().items()
              if v["kind"] == "two_stage"}
    out = {}
    for name in sorted(corpus, key=_corpus_order):
        e = corpus[name]
        _reset_launches()
        t0 = time.perf_counter()
        res = run_query(from_json(e["plan"]), sf=e["sf"], mesh=mesh,
                        prepared=True)
        got = _exact_rows(res)
        if got != e["rows"]:
            raise AssertionError(f"mesh {name} rows differ from the "
                                 f"committed rows:\n got  {got}\n want "
                                 f"{e['rows']}")
        out[name] = {"rows": len(got),
                     "run_query_ms": (time.perf_counter() - t0) * 1e3,
                     "capacity_reruns": res.stats["capacity_reruns"],
                     "exchange_slot_reruns": res.stats[
                         "exchange_slot_reruns"],
                     "fused_limb_sums": K.LAUNCHES["fused_limb_sums"]}
    if len(out) != 22:
        raise AssertionError(f"{len(out)} two-stage plans, not 22")
    print("mesh two-stage: all 22 equal the committed rows; "
          + json.dumps(out))
    return out


def phase_mesh():
    """The mesh tier on the card: make_mesh(4, devices=("cuda:0",) * 4)
    (four workers on one card: real routing, packing and overflow, each
    exchange's moves within the card): q1 at SF1 through the port's
    add_exchanges (mesh_q1), q3 and q14 at SF10 with PARTITIONED joins
    (mesh_join; BASELINE config 2's partitioned exchange), and the 22
    two-stage plans at SF1 (mesh_two_stage). Returns the reports and
    the phase's seconds."""
    import torch
    from presto_tpu_torch.parallel import make_mesh
    t0 = time.perf_counter()
    mesh = make_mesh(MESH_WORKERS, devices=("cuda:0",) * MESH_WORKERS)
    out = {"workers": mesh.size, "q1": mesh_q1(mesh)}
    torch.cuda.empty_cache()
    for name, plan_fn, oracle, tables in (
            ("q3", q3_plan, numpy_q3, Q3_TABLES),
            ("q14", q14_plan, numpy_q14, Q14_TABLES)):
        out[name] = mesh_join(mesh, name, plan_fn, oracle, tables)
    out["two_stage"] = mesh_two_stage(mesh)
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(f"mesh: the phase took {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the worker tier: HTTP workers on the card, scheduled by the coordinator
# ---------------------------------------------------------------------------

CLUSTER_WORKERS = 2
# q1 on the cluster and on one device, in turns; one round keeps the
# full run, phase_fleet included, near 1,000 s
CLUSTER_ROUNDS = 1
# the counted runs must execute: a replay from a worker's fragment
# result cache would launch nothing
CLUSTER_SESSION = {"fragment_result_cache": False}


@contextlib.contextmanager
def recording_fused_by_task():
    """Within the block, every fused_limb_sums call on the card with the
    task that made it (a worker runs task <id> on a thread named
    task-<id>); yields the list of (task id, call)."""
    import threading
    from presto_tpu_torch.ops import kernels as K
    fused, calls = K.fused_limb_sums, []

    def recording(ids, sources, requests, groups, **kw):
        if ids.is_cuda:
            name = threading.current_thread().name
            calls.append((name[len("task-"):] if name.startswith("task-")
                          else name, (ids, sources, requests, groups)))
        return fused(ids, sources, requests, groups, **kw)

    K.fused_limb_sums = recording
    try:
        yield calls
    finally:
        K.fused_limb_sums = fused


def cluster_rows(cols, names):
    """The coordinator's columns in numpy_q1's form."""
    from presto_tpu_torch.exec.runner import QueryResult
    return _plain_rows(QueryResult([v for v, _ in cols],
                                   [m for _, m in cols], names,
                                   len(cols[0][0]) if cols else 0))


def task_report(coord):
    """Each task of the coordinator's last query: its fragment and
    worker, the rows and page bytes it produced, its staging and
    execute ms, and its exchange: pages and bytes pulled and sent, the
    pull's, the decode's and the serialization's ms."""
    out = []
    for t in coord.last_task_stats:
        st = t["stats"]
        qs = st.get("runtimeStats") or {}
        out.append({
            "fragment": t["fragment"], "task": t["task"],
            "worker": t["url"], "rows": st.get("outputRows"),
            "bytes": st.get("outputBytes"),
            "run_query_ms": st.get("wallSeconds", 0.0) * 1e3,
            "stage_ms": qs.get("scan_stage_s", 0.0) * 1e3,
            "execute_ms": qs.get("execute_s", 0.0) * 1e3,
            "fetch_ms": qs.get("fetch_s", 0.0) * 1e3,
            "pages_in": qs.get("exchange_pages_in", 0),
            "page_bytes_in": qs.get("exchange_page_bytes_in", 0),
            "pull_ms": qs.get("exchange_pull_s", 0.0) * 1e3,
            "decode_ms": qs.get("exchange_decode_s", 0.0) * 1e3,
            "pages_out": qs.get("exchange_pages_out", 0),
            "page_bytes_out": qs.get("exchange_page_bytes_out", 0),
            "serialize_ms": qs.get("exchange_serialize_s", 0.0) * 1e3})
    return out


def _print_tasks(name, rep):
    for t in rep["tasks"]:
        print(f"cluster {name}: f{t['fragment']} {t['task']} on "
              f"{t['worker']}: {t['rows']} rows, {t['bytes']} page bytes "
              f"out in {t['pages_out']} pages (serialize "
              f"{t['serialize_ms']:.3f} ms); {t['pages_in']} pages, "
              f"{t['page_bytes_in']} bytes pulled in {t['pull_ms']:.3f} ms "
              f"(decode {t['decode_ms']:.3f} ms); "
              f"stage {t['stage_ms']:.3f} ms, execute "
              f"{t['execute_ms']:.3f} ms")
    print(f"cluster {name}: coordinator wall {rep['wall_ms']:.3f} ms")


def cluster_run(coord, name, plan, want, session=None, **kw):
    """One query through the coordinator (CLUSTER_SESSION under
    `session`): its rows against `want` (in order) and its tasks'
    report."""
    t0 = time.perf_counter()
    cols, names = coord.execute(plan, sf=SF, session={
        **CLUSTER_SESSION, **(session or {})}, **kw)
    wall = (time.perf_counter() - t0) * 1e3
    got = cluster_rows(cols, names)
    if got != want:
        raise AssertionError(f"cluster {name} rows differ from the "
                             f"oracle:\n got  {got}\n want {want}")
    rep = {"query": name, "rows": len(got), "wall_ms": wall,
           "tasks": task_report(coord)}
    _print_tasks(name, rep)
    return rep


@contextlib.contextmanager
def capturing_pages():
    """Within the block, the columns of every page a worker of this
    process serializes, with its task (the thread task-<id>) and its
    bytes; yields the list of (task id, columns, page bytes)."""
    import threading
    from presto_tpu_torch.server import worker as W
    serialize, pages = W.serialize_page, []

    def capturing(columns, codec):
        page = serialize(columns, codec)
        name = threading.current_thread().name
        pages.append((name[len("task-"):] if name.startswith("task-")
                      else name, list(columns), len(page)))
        return page

    W.serialize_page = capturing
    try:
        yield pages
    finally:
        W.serialize_page = serialize


def _numpy_serde():
    """serde/pages.py's host library with pack and unpack replaced by
    their numpy definitions (the plain version the library is timed
    against)."""
    import types
    from presto_tpu_torch.native import kernels as nk

    def pack(values, nulls):
        return np.ascontiguousarray(values[~np.asarray(nulls, bool)]).tobytes()

    def unpack(packed, nulls):
        nulls = np.asarray(nulls, bool)
        out = np.zeros(nulls.shape[0], dtype=packed.dtype)
        out[~nulls] = packed
        return out

    return types.SimpleNamespace(pack_nonnull=pack, unpack_nonnull=unpack,
                                 lz4_compress=nk.lz4_compress,
                                 lz4_decompress=nk.lz4_decompress)


# pack and unpack through numpy and the host library, in turns; then
# lz4 either side of zstd (zlib where zstandard does not import: about
# 3 s on 45 MB, so once)
SERDE_TURNS = ("numpy", "library", "library", "numpy") * 2
CODEC_TURNS = ("lz4", "zstd", "lz4")


def serde_on_pages(captured):
    """The exchange's serde on the pages of the task that serialized
    the most bytes (`captured`, from capturing_pages): serialize_page
    and deserialize_page with pack and unpack through the host library
    and through numpy, in turns, the bytes and the decoded columns
    equal; then the same pages with lz4 and with zstd, in turns: bytes,
    serialize and decode ms, the decoded columns equal."""
    from presto_tpu_torch.serde import (PageCodec, deserialize_page,
                                        serialize_page)
    from presto_tpu_torch.serde import pages as P
    by_task = {}
    for tid, cols, nbytes in captured:
        by_task.setdefault(tid, []).append((cols, nbytes))
    tid, pages = max(by_task.items(),
                     key=lambda kv: sum(b for _, b in kv[1]))
    types = [c[0] for c in pages[0][0]]
    rows = sum(len(cols[0][1]) for cols, _ in pages)

    def run(codec):
        t0 = time.perf_counter()
        bufs = [serialize_page(cols, codec) for cols, _ in pages]
        t1 = time.perf_counter()
        decoded = [deserialize_page(b, types, codec) for b in bufs]
        t2 = time.perf_counter()
        return bufs, decoded, (t1 - t0) * 1e3, (t2 - t1) * 1e3

    def same(a, b):
        return all((x.tolist() == y.tolist() if x.dtype == object
                    else x.tobytes() == y.tobytes()) and
                   np.array_equal(xm, ym)
                   for pa, pb in zip(a, b)
                   for (x, xm), (y, ym) in zip(pa, pb))

    out = {"task": tid, "pages": len(pages), "rows": rows}
    plain_ns, library = _numpy_serde(), P.nk
    first = {}
    for path in SERDE_TURNS:
        P.nk = plain_ns if path == "numpy" else library
        try:
            bufs, decoded, ser, dec = run(PageCodec(None))
        finally:
            P.nk = library
        if path not in first:
            first[path] = (bufs, decoded)
        rep = out.setdefault(path, {"serialize_ms": [], "decode_ms": []})
        rep["serialize_ms"].append(ser)
        rep["decode_ms"].append(dec)
    (nb, nd), (lb, ld) = first["numpy"], first["library"]
    if nb != lb or not same(nd, ld):
        raise AssertionError(f"serde on {tid}'s pages: the host library "
                             f"and numpy differ")
    out["page_bytes"] = sum(len(b) for b in lb)
    out["zstd_module"] = "zstandard" if P._zstd() else "zlib"
    for codec in CODEC_TURNS:
        bufs, decoded, ser, dec = run(PageCodec(codec))
        if not same(decoded, ld):
            raise AssertionError(f"serde on {tid}'s pages: {codec} pages "
                                 f"decode to other columns")
        rep = out.setdefault(codec, {"bytes": sum(len(b) for b in bufs),
                                     "serialize_ms": [], "decode_ms": []})
        rep["serialize_ms"].append(ser)
        rep["decode_ms"].append(dec)
        del bufs, decoded
    del first, nb, nd, lb, ld
    for path in ("numpy", "library", "lz4", "zstd"):
        for k in ("serialize_ms", "decode_ms"):
            out[path][f"median_{k}"] = statistics.median(out[path][k])
    print(f"serde on {tid}'s {len(pages)} pages ({rows} rows, "
          f"{out['page_bytes']} bytes): {json.dumps(out)}")
    return out


def cluster_q1(coord):
    """q1 at SF1 through distribute_simple_agg: a PARTIAL task per
    worker over its half of lineitem, a FINAL task over their pages.
    Round by round, in turns with run_query of q1 on one device. The
    first round is counted: each PARTIAL task launches fused_limb_sums
    once over its ~3.0M rows, the FINAL 1-3 times; one PARTIAL and one
    FINAL call equal the plain version."""
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.ops import kernels as K
    from presto_tpu_torch.plan.fragment import distribute_simple_agg
    want = oracle_rows(numpy_q1, Q1_TABLES, SF)
    plan = distribute_simple_agg(q1_plan())
    rounds = []
    counted = None
    for r in range(CLUSTER_ROUNDS):
        _reset_launches()
        with recording_fused_by_task() as calls:
            rep = cluster_run(coord, f"q1 round {r}", plan, want)
        launches = K.LAUNCHES["fused_limb_sums"]
        if counted is None:
            counted = (rep, calls, launches)
        else:
            del calls
        t0 = time.perf_counter()
        one = run_query(q1_plan(), sf=SF)
        one_ms = (time.perf_counter() - t0) * 1e3
        if _plain_rows(one) != want:
            raise AssertionError("one-device q1 rows differ from numpy_q1")
        rep.update(one_device_run_query_ms=one_ms,
                   one_device_execute_ms=one.stats["execute_s"] * 1e3)
        rounds.append(rep)
        print(f"cluster q1 round {r}: coordinator {rep['wall_ms']:.3f} ms, "
              f"one-device run_query {one_ms:.3f} ms (execute "
              f"{rep['one_device_execute_ms']:.3f} ms)")
    rep, calls, launches = counted
    per_task, err = check_q1_task_launches(
        "cluster q1", {t["task"]: t["fragment"] for t in rep["tasks"]},
        calls, launches)
    del calls
    return {"rounds": rounds, "fused_limb_sums": launches,
            "fused_limb_sums_rows_by_task": per_task,
            "fused_limb_sums_max_abs_err": err}


def cluster_observed(coord, tracer, workers):
    """After cluster_q1's last round, with no new query: the
    coordinator's merged QueryStats (every task's), its stitched trace
    (task spans of both workers under one coordinator.execute), and
    both workers' ledger routes."""
    qs = coord.last_query_stats
    tasks = coord.last_task_stats
    if qs is None or qs.task_count != len(tasks):
        raise AssertionError(f"cluster q1: merged QueryStats of "
                             f"{qs and qs.task_count} tasks, "
                             f"{len(tasks)} ran")
    # the newest trace the coordinator rooted (one-device runs of q1
    # in between hang their stage spans in traces of their own)
    trace_id = next(t for t in reversed(tracer.traces)
                    if any(sp["name"] == "coordinator.execute"
                           for sp in tracer.spans(t)))
    doc = tracer.trace_doc(trace_id)
    names = [sp["name"] for sp in doc["spans"]]
    by_worker = {}
    for t in tasks:
        if f"task.{t['task']}" in names:
            by_worker.setdefault(t["url"], []).append(t["task"])
    if len(by_worker) != len(workers) or \
            names.count("coordinator.execute") != 1:
        raise AssertionError(f"cluster q1 trace: task spans by worker "
                             f"{by_worker}, spans {sorted(set(names))}")
    print(f"cluster q1: merged QueryStats of {qs.task_count} tasks "
          f"(execute {qs.stage_us('execute') / 1e3:.3f} ms summed, "
          f"staged {qs.stages['staging'].bytes} bytes); trace {trace_id} "
          f"stitched {len(names)} spans, task spans from "
          f"{len(by_worker)} workers")
    routes = {w.url: ledger_routes(w.url, "worker") for w in workers}
    return {"task_count": qs.task_count, "trace_spans": len(names),
            "task_spans_by_worker": by_worker, "routes": routes,
            "execute_ms": qs.stage_us("execute") / 1e3}


def check_q1_task_launches(name, frag_of, calls, launches):
    """q1 through distribute_simple_agg on CLUSTER_WORKERS workers:
    fused_limb_sums launched once in each PARTIAL task (fragment 0)
    over its ~3.0M rows and 1-3 times in the FINAL (fragment 1), and
    nowhere else; a PARTIAL and a FINAL call equal the plain version.
    `frag_of`: task id -> fragment. Returns the rows of each task's
    calls and the max abs errors."""
    per_task = {}
    for tid, call in calls:
        per_task.setdefault(tid, []).append(int(call[0].shape[0]))
    partial = {t: n for t, n in per_task.items() if frag_of.get(t) == 0}
    final = {t: n for t, n in per_task.items() if frag_of.get(t) == 1}
    from presto_tpu_torch.connectors import tpch
    share = tpch.table_row_count("lineitem", SF) // CLUSTER_WORKERS
    if launches != len(calls) or len(partial) != CLUSTER_WORKERS \
            or any(len(n) != 1 for n in partial.values()) \
            or not all(share <= n[0] < share + 16
                       for n in partial.values()) \
            or len(final) != 1 \
            or not all(1 <= len(n) <= 3 for n in final.values()) \
            or set(per_task) - set(frag_of):
        raise AssertionError(
            f"{name} must launch fused_limb_sums once in each of the "
            f"{CLUSTER_WORKERS} PARTIAL tasks over ~3.0M rows and 1-3 times "
            f"in the FINAL: rows of each task's calls {per_task}, tasks "
            f"{frag_of}, launches {launches}")
    part_call = next(c for t, c in calls if t in partial)
    final_call = next(c for t, c in calls if t in final)
    err = {"partial": check_fused(*part_call, f"{name}'s PARTIAL lanes"),
           "final": check_fused(*final_call, f"{name}'s FINAL pages")}
    print(f"{name}: equals numpy_q1; fused_limb_sums launches per task "
          f"{per_task} ({launches} in all), a PARTIAL and a FINAL call "
          f"equal the plain version (max abs err {err})")
    return per_task, err


def _arm_failpoint(url, site, spec):
    import urllib.request
    req = urllib.request.Request(
        f"{url}/v1/failpoint", method="POST",
        data=json.dumps({"site": site, "spec": spec}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def start_cluster_worker(discovery_url):
    """A worker in a process of its own (chip_smoke.py --cluster-worker),
    on the card, announcing to `discovery_url`. Returns (process, its
    URL) once it serves."""
    import queue
    import threading
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cluster-worker",
         discovery_url], stdout=subprocess.PIPE, text=True)
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                     daemon=True).start()
    deadline = time.time() + 180
    while time.time() < deadline:
        try:
            line = lines.get(timeout=1.0)
        except queue.Empty:
            if proc.poll() is not None:
                break
            continue
        if line.startswith("cluster worker "):
            return proc, line.split()[-1]
    proc.kill()
    proc.wait()
    raise RuntimeError("the child worker did not start serving")


def serve_cluster_worker(discovery_url):
    """The child of start_cluster_worker: a worker on the card that
    serves until it is killed."""
    import threading
    from presto_tpu_torch.server import TpuWorkerServer
    w = TpuWorkerServer(sf=SF, discovery_url=discovery_url,
                        announce_interval_s=0.5).start()
    print(f"cluster worker {w.url}", flush=True)
    threading.Event().wait()


def phase_cluster():
    """The worker tier on the card: a DiscoveryServer and two
    TpuWorkerServers on cuda:0 announcing to it, the Coordinator taking
    its workers from alive_nodes. q1 at SF1 through
    distribute_simple_agg (cluster_q1, counted launches); q3 at SF1 from
    the port's add_exchanges with PARTITIONED joins against numpy_q3; q1
    again from add_exchanges (PARTIAL, HASH exchange, FINAL, a SORTED
    gather merged by merge_permutation) against numpy_q1 in order;
    "all_at_once" against "phased"; worker.run_task armed to fail once
    on one worker (POST /v1/failpoint), the rows unchanged; a worker in
    a child process, q1 across the process boundary. After q3,
    serde_on_pages times the codec on q3's largest task's pages.
    Returns the reports and the phase's seconds."""
    import torch
    from presto_tpu_torch import failpoints
    from presto_tpu_torch.plan.distribute import add_exchanges
    from presto_tpu_torch.plan.fragment import (distribute_simple_agg,
                                                fragment_plan)
    from presto_tpu_torch.server import Coordinator, TpuWorkerServer
    from presto_tpu_torch.server.discovery import (DiscoveryServer,
                                                   alive_nodes)
    from presto_tpu_torch.server.tracing import RecordingTracer, set_tracer
    t0 = time.perf_counter()
    disc = DiscoveryServer().start()
    workers, child = [], None
    try:
        workers = [TpuWorkerServer(sf=SF, discovery_url=disc.url,
                                   announce_interval_s=0.5).start()
                   for _ in range(CLUSTER_WORKERS)]
        deadline = time.time() + 30
        while len(alive_nodes(disc.url)) < CLUSTER_WORKERS:
            if time.time() > deadline:
                raise RuntimeError("the workers did not announce")
            time.sleep(0.05)
        coord = Coordinator(discovery_url=disc.url)
        tracer = RecordingTracer()
        set_tracer(tracer)
        try:
            out = {"workers": CLUSTER_WORKERS, "q1": cluster_q1(coord)}
            out["q1_observed"] = cluster_observed(coord, tracer, workers)
        finally:
            set_tracer(None)
        torch.cuda.empty_cache()

        want_q3 = oracle_rows(numpy_q3, Q3_TABLES, SF)
        q3 = add_exchanges(q3_plan(), join_strategy="partitioned", sf=SF)
        hashed = sum(f.partitioning == "HASH" for f in fragment_plan(q3))
        if hashed < 3:
            raise AssertionError(f"q3's plan has {hashed} HASH fragments")
        with capturing_pages() as captured:
            out["q3"] = cluster_run(coord, "q3", q3, want_q3)
        out["q3"]["hash_fragments"] = hashed
        torch.cuda.empty_cache()
        out["q3_serde"] = serde_on_pages(captured)
        del captured

        want_q1 = oracle_rows(numpy_q1, Q1_TABLES, SF)
        q1x = add_exchanges(q1_plan(), sf=SF)
        parts = [f.partitioning for f in fragment_plan(q1x)]
        if parts != ["HASH", "SORTED", "SINGLE"]:
            raise AssertionError(f"q1 from add_exchanges: fragments {parts}")
        out["q1_exchanges"] = cluster_run(coord, "q1 (add_exchanges)", q1x,
                                          want_q1)
        out["q1_exchanges"]["fragments"] = parts

        simple = distribute_simple_agg(q1_plan())
        out["q1_all_at_once"] = cluster_run(
            coord, "q1 (all_at_once)", simple, want_q1, policy="all_at_once")

        _arm_failpoint(workers[1].url, "worker.run_task",
                       "error(RuntimeError):once")
        try:
            out["q1_failover"] = cluster_run(coord, "q1 (failover)", simple,
                                             want_q1)
            fired = failpoints.active()["worker.run_task"]["fires"]
        finally:
            failpoints.disarm_all()
        retried = [t["task"] for t in out["q1_failover"]["tasks"]
                   if ".r" in t["task"]]
        if fired != 1 or not retried:
            raise AssertionError(f"failover: worker.run_task fired {fired} "
                                 f"times, retried tasks {retried}")
        out["q1_failover"]["retried"] = retried

        t1 = time.perf_counter()
        child, child_url = start_cluster_worker(disc.url)
        out["child_start_s"] = time.perf_counter() - t1
        across = Coordinator([workers[0].url, child_url])
        out["q1_child_process"] = cluster_run(across, "q1 (child process)",
                                              simple, want_q1)
        if child_url not in {t["worker"] for t in
                             out["q1_child_process"]["tasks"]}:
            raise AssertionError("no task ran in the child process")
    finally:
        if child is not None:
            child.kill()
            child.wait()
        for w in workers:
            w.stop()
        disc.stop()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(f"cluster: the phase took {out['s']:.1f} s")
    return out


FLEET_SECRET = "chip-smoke-fleet-secret"
# the fleet's exchange ships lz4 pages (the host library's LZ4 codec)
FLEET_SESSION = {**CLUSTER_SESSION, "exchange_compression": "lz4"}


def fleet_certs(directory):
    """A self-signed cluster CA (server/tls.py) trusted by this
    process's clients, as (cert, key); None where the cryptography
    package does not import (the import error is printed on a line of
    its own, and the cluster runs on plain HTTP with its secret)."""
    from presto_tpu_torch.server import tls
    try:
        import cryptography  # noqa: F401  (generate_self_signed needs it)
    except ImportError as e:
        print(f"fleet: cryptography does not import: {e!r}")
        return None
    cert, key = tls.generate_self_signed(directory)
    tls.trust(cert)
    return cert, key


def _bearer():
    from presto_tpu_torch.server.auth import (InternalAuthenticator,
                                              bearer_headers)
    return bearer_headers(InternalAuthenticator(FLEET_SECRET, "smoke"))


def _http_status(url, headers=None):
    """The status code of a GET (urllib raises on >= 400)."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(urllib.request.Request(
                url, headers=headers or {}), timeout=30) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def fleet_run(coord, name, plan, session=None):
    """q1 through `coord` (cluster_run), the counts at 0 just before:
    every fused_limb_sums launch of its tasks checked."""
    from presto_tpu_torch.ops import kernels as K
    _reset_launches()
    with recording_fused_by_task() as calls:
        rep = cluster_run(coord, f"fleet {name}", plan,
                          oracle_rows(numpy_q1, Q1_TABLES, SF), session)
        launches = K.LAUNCHES["fused_limb_sums"]
    frag_of = {t["task"]: t["fragment"] for t in rep["tasks"]}
    rep["fused_limb_sums_rows_by_task"], rep["fused_limb_sums_max_abs_err"] \
        = check_q1_task_launches(f"fleet {name}", frag_of, calls, launches)
    rep["fused_limb_sums"] = launches
    del calls
    return rep


def fleet_thrift_status(url, task_id):
    """One task's status as thrift (Accept: application/x-thrift),
    decoded, against its JSON status."""
    from presto_tpu_torch.serde.thrift import (TASK_STATUS_SCHEMA,
                                               decode_task_status)
    base = f"{url}/v1/task/{task_id}/status"
    code, body, _ = _http_status(base, _bearer())
    jdoc = json.loads(body)
    code2, raw, headers = _http_status(
        base, {**_bearer(), "Accept": "application/x-thrift"})
    tdoc = decode_task_status(raw)
    failures = [f.get("message", "") for f in jdoc.get("failures", [])]
    same = {k: jdoc[k] for k in TASK_STATUS_SCHEMA if k in jdoc}
    got = {k: tdoc[k] for k in same}
    if (code, code2) != (200, 200) or \
            headers.get("Content-Type") != "application/x-thrift" or \
            got != same or tdoc["taskId"] != task_id or \
            [f["message"] for f in tdoc["failures"]] != failures:
        raise AssertionError(f"thrift status of {task_id}: {tdoc} against "
                             f"{jdoc} ({code}, {code2}, {headers})")
    print(f"fleet thrift: {task_id}'s status as {len(raw)} thrift bytes "
          f"equals its JSON status ({len(body)} bytes): {got}")
    return {"thrift_bytes": len(raw), "json_bytes": len(body),
            "state": tdoc["state"]}


def fleet_drain(workers, disc_url):
    """q1's PARTIAL tasks on both workers, with lz4 pages; before the
    FINAL pulls, the first worker drains into the second (POST
    /v1/worker/drain with migrateTo): its pages move once (its stream
    checksum before equals the peer's after), it reaches DRAINED and
    leaves alive_nodes; the FINAL on the peer pulls the drained
    worker's task through the redirect, and its rows equal numpy_q1."""
    from presto_tpu_torch.connectors import tpch
    from presto_tpu_torch.ops import kernels as K
    from presto_tpu_torch.plan import nodes as N
    from presto_tpu_torch.plan.fragment import (distribute_simple_agg,
                                                fragment_plan)
    from presto_tpu_torch.serde import PageCodec
    from presto_tpu_torch.server import WorkerClient
    from presto_tpu_torch.server.discovery import alive_nodes
    drained, peer = workers
    partial, final = fragment_plan(distribute_simple_agg(q1_plan()))
    out_names = [f"c{i}" for i in range(len(partial.root.output_types()))]
    scan = next(n for n in _walk_nodes(partial.root)
                if isinstance(n, N.TableScanNode))
    total = tpch.table_row_count("lineitem", SF)
    tids = ["fleet.drain.p0", "fleet.drain.p1"]
    clients = [WorkerClient(w.url, 600.0, shared_secret=FLEET_SECRET)
               for w in workers]
    want = oracle_rows(numpy_q1, Q1_TABLES, SF)
    _reset_launches()
    with recording_fused_by_task() as calls:
        t0 = time.perf_counter()
        for w, (c, tid) in enumerate(zip(clients, tids)):
            lo = total * w // 2
            c.submit_body(tid, {
                "plan": N.to_json(N.OutputNode(partial.root, out_names)),
                "sf": SF, "session": FLEET_SESSION,
                "scanRanges": {scan.id: [lo, total * (w + 1) // 2 - lo]}})
        for c, tid in zip(clients, tids):
            info = c.wait(tid, 600.0)
            if info["state"] != "FINISHED":
                raise AssertionError(f"PARTIAL {tid}: {info}")
        partial_ms = (time.perf_counter() - t0) * 1e3
        task = drained.manager.get(tids[0])
        with task.lock:
            pre = {b: buf.stream_checksum() for b, buf in task.buffers.items()}
            pages = sum(len(b) for b in task.buffers.values())
        t1 = time.perf_counter()
        st = clients[0].drain(migrate_to=peer.url, timeout_ms=60000)
        deadline = time.time() + 120
        while st["state"] != "DRAINED":
            if time.time() > deadline:
                raise AssertionError(f"the drain did not finish: {st}")
            time.sleep(0.02)
            st = clients[0].drain_status()
        drain_ms = (time.perf_counter() - t1) * 1e3
        while any(n["uri"] == drained.url for n in
                  alive_nodes(disc_url, shared_secret=FLEET_SECRET)):
            if time.time() > deadline:
                raise AssertionError("the drained worker is still alive")
            time.sleep(0.02)
        adopted = peer.manager.get(tids[0])
        with adopted.lock:
            post = {b: buf.stream_checksum()
                    for b, buf in adopted.buffers.items()}
        peer_st = clients[1].drain_status()
        if post != pre or st["migratedPages"] != pages or \
                st["unreplayedPages"] != 0 or peer_st["adoptedTasks"] != 1:
            raise AssertionError(f"migration: checksums {pre} -> {post}, "
                                 f"{pages} pages, drain {st}, peer {peer_st}")
        rn = next(n for n in _walk_nodes(final.root)
                  if isinstance(n, N.RemoteSourceNode))
        t2 = time.perf_counter()
        clients[1].submit_body("fleet.drain.f", {
            "plan": N.to_json(final.root), "sf": SF,
            "session": FLEET_SESSION,
            "remoteSources": {rn.id: {
                "sources": [w.url for w in workers], "taskIds": tids,
                "types": [str(t) for t in rn.types], "ack": False,
                "timeoutS": 600.0}}})
        if clients[1].wait("fleet.drain.f", 600.0)["state"] != "FINISHED":
            raise AssertionError("the FINAL after the drain failed")
        cols = clients[1].fetch_results("fleet.drain.f",
                                        final.root.output_types(),
                                        PageCodec("lz4"))
        final_ms = (time.perf_counter() - t2) * 1e3
        launches = K.LAUNCHES["fused_limb_sums"]
    got = cluster_rows(cols, final.root.names)
    if got != want:
        raise AssertionError(f"fleet drain: FINAL rows differ from "
                             f"numpy_q1:\n got  {got}\n want {want}")
    frag_of = {tids[0]: 0, tids[1]: 0, "fleet.drain.f": 1}
    per_task, err = check_q1_task_launches("fleet drain", frag_of, calls,
                                           launches)
    del calls
    final_stats = peer.manager.get("fleet.drain.f").stats["runtimeStats"]
    print(f"fleet drain: PARTIALs {partial_ms:.1f} ms; {pages} pages of "
          f"{drained.node_id} migrated once in {drain_ms:.1f} ms "
          f"(checksums equal), DRAINED and out of alive_nodes; the FINAL "
          f"pulled {final_stats['exchange_pages_in']} pages through the "
          f"redirect in {final_ms:.1f} ms, rows equal numpy_q1")
    return {"migrated_pages": pages, "partial_ms": partial_ms,
            "drain_ms": drain_ms, "final_ms": final_ms,
            "final_pages_in": final_stats["exchange_pages_in"],
            "fused_limb_sums": launches,
            "fused_limb_sums_rows_by_task": per_task,
            "fused_limb_sums_max_abs_err": err}


def _walk_nodes(root):
    out, stack = [], [root]
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(n.sources)
    return out


@contextlib.contextmanager
def recording_first_lz4_page():
    """Within the block, the first page the host library compresses
    with lz4 and its block; yields the list that holds them. After the
    block the block must decompress to the page's bytes."""
    from presto_tpu_torch.native import kernels as nk
    compress, seen = nk.lz4_compress, []

    def recording(data):
        block = compress(data)
        if not seen:
            seen.append((bytes(data), block))
        return block

    nk.lz4_compress = recording
    try:
        yield seen
    finally:
        nk.lz4_compress = compress
    if not seen or nk.lz4_decompress(seen[0][1], len(seen[0][0])) != \
            seen[0][0]:
        raise AssertionError("the first lz4 page does not decompress to "
                             "the bytes that were compressed")
    print(f"fleet lz4: the first page, {len(seen[0][0])} -> "
          f"{len(seen[0][1])} bytes, round trips")


def fleet_failover():
    """A ResourceManager; a primary and a standby StatementServer on
    cuda:0, each admitting through a Dispatcher against the cluster's
    load and heartbeating through a ClusterStateSender; a RouterServer
    in front. q1 (the full text) POSTed through the router equals
    numpy_q1 with one fused_limb_sums launch. Then the primary's
    executor is wedged under an in-flight q1 and every heartbeat is lost
    (coordinator.heartbeat_lapse): the standby's check_once adopts the
    q1 once, and its rows equal numpy_q1 with one launch."""
    import threading
    from presto_tpu_torch import failpoints
    from presto_tpu_torch.client import StatementClient, execute
    from presto_tpu_torch.ops import kernels as K
    from presto_tpu_torch.queries import load_corpus
    from presto_tpu_torch.server.dispatcher import Dispatcher
    from presto_tpu_torch.server.resource_manager import (
        ClusterStateSender, ResourceManager, StandbyCoordinator,
        failover_totals, reset_failover_totals)
    from presto_tpu_torch.server.router import RouterServer
    from presto_tpu_torch.server.statement import StatementServer
    text = SQL_Q1.format(table="lineitem")
    groups = load_corpus()["q1_two_stage"]["max_groups"]
    session = {"sf": str(SF), "max_groups": str(groups)}
    want = oracle_rows(numpy_q1, Q1_TABLES, SF)
    out, servers, senders = {}, [], []
    gate = threading.Event()
    reset_failover_totals()
    try:
        rm = ResourceManager(heartbeat_ttl_s=1.0).start()
        servers.append(rm)
        for cid in ("primary", "standby"):
            srv = StatementServer(sf=SF, device="cuda:0", queue_poll_s=0.05,
                                  dispatcher=Dispatcher(
                                      resource_manager_url=rm.url,
                                      coordinator_id=cid,
                                      cluster_limits={"global": 4})).start()
            servers.append(srv)
            senders.append(ClusterStateSender(
                rm.url, cid, srv.dispatcher, interval_s=0.1,
                inflight_fn=srv.inflight_doc).start())
        primary, standby = servers[1], servers[2]
        router = RouterServer([{"url": primary.url},
                               {"url": standby.url, "kind": "standby"}],
                              health_ttl_s=0.0).start()
        servers.append(router)
        _reset_launches()
        with recording_fused() as calls:
            t0 = time.perf_counter()
            c = execute(router.url, text, session=session)
            out["router_ms"] = (time.perf_counter() - t0) * 1e3
            launches = K.LAUNCHES["fused_limb_sums"]
            if launches != 1:
                raise AssertionError(f"q1 through the router launched "
                                     f"fused_limb_sums {launches} times")
            out["router_max_abs_err"] = check_fused(
                *calls[0], "q1 through the router")
        if c.data != _rendered(want, c.columns) or \
                [d["queryId"] for d in primary.queries_doc()] != \
                [c.query_id]:
            raise AssertionError(f"router q1: {c.data[:2]} on "
                                 f"{primary.queries_doc()}")

        def wedged(text, session_values, query_id, txn_id):
            gate.wait(600)
            raise RuntimeError("the wedged primary was released after "
                               "the failover")

        primary._executor = wedged
        monitor = StandbyCoordinator(rm.url, "primary", standby, ttl_s=0.5)
        sc = StatementClient(primary.url, text, session=session)
        qid = sc.query_id
        deadline = time.time() + 60
        while not any(q["queryId"] == qid for q in primary.inflight_doc()):
            if time.time() > deadline:
                raise AssertionError("the primary's q1 is not in flight")
            time.sleep(0.01)
        senders[0].send_once()  # the manifest rides a heartbeat
        if monitor.check_once():
            raise AssertionError("failover while the primary heartbeats")
        failpoints.arm("coordinator.heartbeat_lapse", "error(OSError)")
        time.sleep(1.2)  # the primary's heartbeats lapse past the ttl
        _reset_launches()
        with recording_fused() as calls:
            t1 = time.perf_counter()
            fired = monitor.check_once()
            again = monitor.check_once()
            with primary._qlock:
                slug = primary._queries[qid].slug
            q = standby.get_query(qid, slug)
            if q is None:
                raise AssertionError("the standby did not adopt q1 under "
                                     "its id and slug")
            q.machine.wait_done(600)
            out["failover_ms"] = (time.perf_counter() - t1) * 1e3
            launches = K.LAUNCHES["fused_limb_sums"]
            if launches != 1:
                raise AssertionError(f"the adopted q1 launched "
                                     f"fused_limb_sums {launches} times")
            out["standby_max_abs_err"] = check_fused(
                *calls[0], "the standby's adopted q1")
        lapses = failpoints.active()["coordinator.heartbeat_lapse"]["fires"]
        if not fired or again or failover_totals() != 1 or \
                q.machine.state != "FINISHED" or \
                q.rows != _rendered(want, q.columns) or lapses < 1:
            raise AssertionError(
                f"failover: fired {fired}, again {again}, totals "
                f"{failover_totals()}, state {q.machine.state}, "
                f"lapses {lapses}, rows {q.rows[:2]}")
        out.update(failovers=failover_totals(), heartbeat_lapses=lapses)
        print(f"fleet router: q1 through the router {out['router_ms']:.1f} "
              f"ms, one launch; after {lapses} lost heartbeats the standby "
              f"adopted the wedged q1 once and answered it in "
              f"{out['failover_ms']:.1f} ms, rows equal numpy_q1")
    finally:
        failpoints.disarm_all()
        gate.set()
        for snd in senders:
            snd.stop()
        for srv in reversed(servers):
            srv.stop()
    return out


def fleet_catalog_server():
    """A CatalogServer over this process's catalogs, registered as the
    remote catalog rtpch: SHOW TABLES and DESCRIBE lineitem through it,
    the planner's row counts equal the local ones, a scan refused."""
    from presto_tpu_torch import sql
    from presto_tpu_torch.connectors import tpch
    from presto_tpu_torch.plan import nodes as N
    from presto_tpu_torch.plan.stats import estimate_rows
    from presto_tpu_torch.server.catalog_server import (
        CatalogServer, register_remote_catalog, unregister_remote_catalog)
    with CatalogServer() as srv:
        register_remote_catalog("rtpch", srv.url, "tpch")
        try:
            tables = sorted(r[0] for r in sql("SHOW TABLES FROM rtpch",
                                              sf=SF).rows())
            cols = [r[0] for r in sql("DESCRIBE rtpch.lineitem",
                                      sf=SF).rows()]
            counts = {}
            for t in tables:
                col, ty = tpch.TPCH_SCHEMA[t][0]
                counts[t] = tuple(estimate_rows(N.TableScanNode(
                    cat, t, [col], [ty]), SF) for cat in ("rtpch", "tpch"))
            refused = None
            try:
                sql("SELECT count(*) FROM rtpch.region", sf=SF)
            except NotImplementedError as e:
                refused = str(e)
        finally:
            unregister_remote_catalog("rtpch")
    if tables != sorted(tpch.TPCH_SCHEMA) or \
            cols != [c for c, _ in tpch.TPCH_SCHEMA["lineitem"]] or \
            any(a != b for a, b in counts.values()) or \
            not refused or "METADATA" not in refused:
        raise AssertionError(f"catalog server: {tables}, {cols}, {counts}, "
                             f"scan refusal {refused!r}")
    print(f"fleet catalog server: SHOW TABLES {len(tables)}, DESCRIBE "
          f"lineitem {len(cols)} columns, row counts equal "
          f"({counts['lineitem'][0]:.0f} lineitem), a scan refused: "
          f"{refused}")
    return {"tables": len(tables), "lineitem_rows": counts["lineitem"][0]}


def phase_fleet():
    """The cluster operations on the card, q1 at SF1 throughout: a
    DiscoveryServer, two TpuWorkerServers on cuda:0 and the Coordinator,
    all with one shared secret and TLS (where cryptography imports): q1
    through distribute_simple_agg (5 launches), a request without a
    bearer answered 401, one task's status as thrift; q1's PARTIALs, a
    drain with page migration, the FINAL through the redirect, every
    exchange with lz4 pages (the first one checked to round trip); the
    router, the resource manager and the standby's adoption; the
    catalog server. Returns each step's report and wall seconds."""
    import tempfile
    import torch
    from presto_tpu_torch.plan.fragment import distribute_simple_agg
    from presto_tpu_torch.server import Coordinator, TpuWorkerServer, tls
    from presto_tpu_torch.server.auth import set_shared_secret
    from presto_tpu_torch.server.discovery import (DiscoveryServer,
                                                   alive_nodes,
                                                   reset_fleet_state)
    t0 = time.perf_counter()
    out, step_s = {}, {}
    disc, workers = None, []
    reset_fleet_state()
    with tempfile.TemporaryDirectory() as tmp:
        certs = fleet_certs(tmp)
        out["tls"] = certs is not None
        set_shared_secret(FLEET_SECRET)  # the process's internal clients
        try:
            t = time.perf_counter()
            disc = DiscoveryServer(shared_secret=FLEET_SECRET,
                                   tls=certs).start()

            def worker():
                w = TpuWorkerServer(sf=SF, discovery_url=disc.url,
                                    announce_interval_s=0.5,
                                    shared_secret=FLEET_SECRET,
                                    tls=certs).start()
                workers.append(w)
                return w

            def wait_alive(n):
                deadline = time.time() + 60
                while len(alive_nodes(disc.url,
                                      shared_secret=FLEET_SECRET)) != n:
                    if time.time() > deadline:
                        raise RuntimeError(f"{n} workers did not announce")
                    time.sleep(0.05)

            first = [worker() for _ in range(CLUSTER_WORKERS)]
            wait_alive(CLUSTER_WORKERS)
            scheme = {w.url.split(":")[0] for w in first + [disc]}
            if scheme != {"https" if certs else "http"}:
                raise AssertionError(f"the cluster serves {scheme}")
            coord = Coordinator(discovery_url=disc.url)
            with recording_first_lz4_page() as seen:
                out["secured_q1"] = fleet_run(
                    coord, "q1 (secured, lz4 pages)",
                    distribute_simple_agg(q1_plan()), FLEET_SESSION)
            out["first_lz4_page"] = [len(seen[0][0]), len(seen[0][1])]
            del seen
            code, _, _ = _http_status(f"{first[0].url}/v1/info")
            if code != 401:
                raise AssertionError(f"a request without a bearer got {code}")
            out["unauthenticated_status"] = code
            step_s["secured"] = time.perf_counter() - t

            t = time.perf_counter()
            task = next(x for x in out["secured_q1"]["tasks"]
                        if x["fragment"] == 0)
            out["thrift"] = fleet_thrift_status(task["worker"], task["task"])
            step_s["thrift"] = time.perf_counter() - t
            torch.cuda.empty_cache()

            t = time.perf_counter()
            out["drain"] = fleet_drain(first, disc.url)
            step_s["drain"] = time.perf_counter() - t
        finally:
            for w in workers:
                w.stop()
            if disc is not None:
                disc.stop()
            set_shared_secret(None)
            tls.clear_trust()
            reset_fleet_state()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["failover"] = fleet_failover()
    step_s["router_failover"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["catalog_server"] = fleet_catalog_server()
    step_s["catalog_server"] = time.perf_counter() - t
    out["step_s"] = step_s
    out["s"] = time.perf_counter() - t0
    print(f"fleet: steps {json.dumps(step_s)}; the phase took "
          f"{out['s']:.1f} s")
    return out


def _close_rows(got, want, rel=1e-9):
    """Rows in exact form equal, doubles (float.hex) within `rel`: the
    moment sums add in another order on the card."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(b, str) and isinstance(a, str) and \
                    b.startswith(("0x", "-0x")):
                x, y = float.fromhex(a), float.fromhex(b)
                if abs(x - y) > rel * abs(y):
                    return False
            elif a != b:
                return False
    return True


def numpy_percentile(t, fraction=0.5):
    """quantity by returnflag: the value at floor((n - 1) * fraction) of
    each group's sorted quantities, groups in first-row order."""
    li = t["lineitem"]
    flags, first = np.unique(li["returnflag"], return_index=True)
    out = []
    for f in flags[np.argsort(first)]:
        q = np.sort(li["quantity"][li["returnflag"] == f])
        out.append((f, int(q[int(np.floor((len(q) - 1) * fraction))])))
    return out


def phase_aggregates():
    """The aggregate statements of the committed corpus (agg_hash and its
    two-stage form: min_by/max_by/checksum/corr/geometric_mean on the
    hash-slot path over 6.0M rows and 200,000 groups; agg_moments:
    stddev/var/bool_or on the sorted path; approx_distinct grouped and
    global) through run_query on the card, rows equal to the committed
    ones: exact, doubles within rel 1e-9. agg_hash must take the hash
    path at 262,144 groups on the run that returns its rows. Then one
    ops-level group_by with approx_percentile (0.5) of quantity by
    returnflag over SF1 lineitem, on the small-table and the sorted
    path, against numpy. Returns the reports."""
    import torch
    from presto_tpu_torch import types as T
    from presto_tpu_torch.block import batch_from_numpy, to_numpy
    from presto_tpu_torch.connectors import tpch
    from presto_tpu_torch.ops import aggregation as A
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.queries import load_corpus
    corpus = {k: v for k, v in load_corpus().items()
              if v["kind"] == "aggregate"}
    reports = []
    hash_calls = []
    group_ids_hash = A._group_ids_hash

    def recording(words, active, max_groups):
        hash_calls.append((active.shape[0], max_groups))
        out = group_ids_hash(words, active, max_groups)
        hash_calls[-1] += (dict(A.HASH_STATS),)
        return out

    for name in sorted(corpus):
        entry = corpus[name]
        A._group_ids_hash = recording
        try:
            rep = phase_query(name, lambda e=entry: from_json(e["plan"]),
                              lambda _t, e=entry: e["rows"],
                              _scanned_columns(entry["plan"]), entry["sf"],
                              rows=_exact_rows, same=_close_rows,
                              run_query_repeats=0)
        finally:
            A._group_ids_hash = group_ids_hash
        # the hash tables of the last run (phase_query's timing runs)
        rep["hash_tables"] = sorted({c[:2] for c in hash_calls})
        rep["hash_stats"] = hash_calls[-1][2] if hash_calls else None
        hash_calls.clear()
        if name.startswith("agg_hash") and \
                all(g != 1 << 18 for _, g in rep["hash_tables"]):
            raise AssertionError(f"{name} did not take the hash path at "
                                 f"262,144 groups: {rep['hash_tables']}")
        reports.append(rep)
    print("aggregates: " + json.dumps(
        {**_summary(reports), **{r["query"] + "_hash": {
            "tables": r["hash_tables"], "last": r["hash_stats"]}
            for r in reports if r["hash_tables"]}}))

    cols = host_columns("lineitem", SF, ["returnflag", "quantity"])
    want = numpy_percentile({"lineitem": cols})
    batch = batch_from_numpy([T.char(1), T.decimal(12, 2)],
                             [cols["returnflag"], cols["quantity"]])
    spec = [A.AggSpec("approx_percentile", 1, T.decimal(12, 2),
                      parameter=0.5)]
    for g in (16, 128):
        res = A.group_by(batch, [0], spec, g)
        act = res.batch.active.cpu().numpy()
        keys, _ = to_numpy(res.batch.columns[0])
        vals, _ = to_numpy(res.batch.columns[1])
        got = [(k, int(v)) for k, v, a in zip(keys, vals, act) if a]
        if sorted(got) != sorted(want) or bool(res.overflow):
            raise AssertionError(f"approx_percentile (max_groups {g}) "
                                 f"differs:\n got  {got}\n want {want}")
        print(f"approx_percentile(quantity, 0.5) by returnflag, max_groups "
              f"{g}: {got} equals numpy")
    del batch
    torch.cuda.empty_cache()
    return reports


@contextlib.contextmanager
def timing_dfa_and_host_kernels():
    """Within the block, time each regex DFA scan
    (ops/regex.py::regexp_like_kernel, as expr/compile.py calls it) and
    each per-row host kernel of expr/functions.py, synced on both
    sides; yields the counts and milliseconds."""
    import torch
    from presto_tpu_torch.expr import compile as C
    from presto_tpu_torch.expr import functions as F
    stats = {"dfa_calls": 0, "dfa_ms": 0.0, "host_kernel_calls": 0,
             "host_kernel_ms": 0.0}

    def timed(fn, what):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            stats[what + "_calls"] += 1
            stats[what + "_ms"] += (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    saved = (C.regexp_like_kernel, F.host_string_kernel,
             F.host_scalar_kernel)
    C.regexp_like_kernel = timed(saved[0], "dfa")
    F.host_string_kernel = timed(saved[1], "host_kernel")
    F.host_scalar_kernel = timed(saved[2], "host_kernel")
    try:
        yield stats
    finally:
        (C.regexp_like_kernel, F.host_string_kernel,
         F.host_scalar_kernel) = saved


def phase_functions():
    """The scalar function library on the card. Every statement of the
    committed function corpus (presto_tpu_torch/queries/functions.json)
    at sf 0.01 through run_query, rows equal to the reference's: the
    flat statements of its function tests exactly, the timed ones with
    doubles within rel 1e-9 (transcendental doubles of the statements
    within rel 1e-12). Then each timed statement at SF1 but those of
    the nested half (NESTED_TIMED, phase_nested's) through phase_query
    against the reference's SF1 rows (doubles within rel 1e-9), one
    more execute timing the regex DFA scans and the host kernels. A
    plan with a small-table keyed aggregation must launch
    fused_limb_sums on the path that returns its rows. Returns the
    reports."""
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.queries import load_functions_corpus
    corpus = load_functions_corpus()
    t0 = time.perf_counter()
    for group, rel in (("statements", 1e-12), ("timed", 1e-9)):
        for name, e in sorted(corpus[group].items()):
            got = _exact_rows(run_query(from_json(e["plan"]), sf=e["sf"],
                                        prepared=True))
            if not _close_rows(got, e["rows"], rel):
                raise AssertionError(f"{name} at sf {e['sf']} differs from "
                                     f"the reference:\n got  {got}\n want "
                                     f"{e['rows']}")
    small_s = time.perf_counter() - t0
    print(f"functions at sf 0.01: {len(corpus['statements'])} statements "
          f"and {len(corpus['timed'])} timed ones equal the reference; "
          f"{small_s:.1f} s")

    reports = []
    for name, e in corpus["timed"].items():
        if name in NESTED_TIMED:
            continue
        plan = e["plan_sf1"]
        rep = phase_query(name, lambda p=plan: from_json(p),
                          lambda _t, e=e: e["rows_sf1"],
                          _scanned_columns(plan), e["sf1"],
                          rows=_exact_rows, same=_close_rows,
                          run_query_repeats=0,
                          instrument=timing_dfa_and_host_kernels)
        small = _small_keyed_aggs(plan)
        launches = rep["launches"]["narrow"]
        if small and launches["fused_limb_sums"] < 1:
            raise AssertionError(f"{name} has small-table aggregations "
                                 f"{small} but its rows came from no "
                                 f"fused_limb_sums launch: {launches}")
        rep["small_table_max_groups"] = small
        reports.append(rep)
    print("functions: " + json.dumps(
        {r["query"]: {**_summary([r])[r["query"]], **r["instrumented"]}
         for r in reports}))
    return {"sf001_s": small_s, "timed": reports}


# the timed statements of the nested half, run by phase_nested
NESTED_TIMED = ("fn_arrays", "fn_unnest")
# the full-size nested columns: lineitem's rows at SF1, fanout 8
NESTED_ROWS, NESTED_K = 6_000_000, 8
NESTED_REPEATS = 3


def phase_nested(seed):
    """The nested half of the function library on the card.

    * The 20 statements over arrays and lambdas of the function corpus
      ("later") at sf 0.01 through run_query, rows equal to the
      reference's exactly (nested values in exact form).
    * fn_arrays and fn_unnest at SF1 through phase_query against the
      reference's SF1 rows; each groups in at most 64 slots, so each
      must launch fused_limb_sums on the run that returns its rows.
    * Maps, rows and a dictionary at full size (nested_full_size).

    Returns the report, with the phase's seconds."""
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.queries import load_functions_corpus
    corpus = load_functions_corpus()
    t0 = time.perf_counter()
    for name, e in sorted(corpus["later"].items()):
        got = _exact_rows(run_query(from_json(e["plan"]), sf=e["sf"],
                                        prepared=True))
        if got != e["rows"]:
            raise AssertionError(f"{name} at sf {e['sf']} differs from the "
                                 f"reference:\n got  {got}\n want "
                                 f"{e['rows']}")
    small_s = time.perf_counter() - t0
    print(f"nested at sf 0.01: {len(corpus['later'])} statements equal the "
          f"reference; {small_s:.1f} s")
    reports = []
    for name in NESTED_TIMED:
        e = corpus["timed"][name]
        plan = e["plan_sf1"]
        rep = phase_query(name, lambda p=plan: from_json(p),
                          lambda _t, e=e: e["rows_sf1"],
                          _scanned_columns(plan), e["sf1"],
                          rows=_exact_rows, run_query_repeats=0,
                          execute_repeats=NESTED_REPEATS)
        small = _small_keyed_aggs(plan)
        launches = rep["launches"]["narrow"]
        if not small or launches["fused_limb_sums"] < 1:
            raise AssertionError(f"{name} must group in a small table "
                                 f"({small}) and launch fused_limb_sums "
                                 f"on the run that returns its rows: "
                                 f"{launches}")
        rep["small_table_max_groups"] = small
        reports.append(rep)
    print("nested: " + json.dumps(_summary(reports)))
    full = nested_full_size(seed)
    total_s = time.perf_counter() - t0
    print(f"phase_nested: {total_s:.1f} s (sf 0.01 {small_s:.1f} s)")
    return {"sf001_s": small_s, "timed": reports, "full_size": full,
            "seconds": total_s}


def _to_device(b, dev):
    """A block (its nested blocks too) with every tensor on `dev`."""
    import dataclasses as dc
    import torch
    out = {}
    for f in dc.fields(b):
        v = getattr(b, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(dev)
        elif f.name == "fields":  # a row's blocks
            v = tuple(_to_device(x, dev) for x in v)
        elif f.name == "dictionary":
            v = _to_device(v, dev)
        out[f.name] = v
    return type(b)(**out)


def _lanes(b):
    """The block's tensors on the host with every lane that carries no
    value zeroed (past a length, under a NULL), doubles as their bits:
    two results are equal when these are."""
    import torch
    from presto_tpu_torch import block as B
    b = B.decoded(_to_device(b, "cpu"))

    def keep(t, live):
        t = torch.where(live, t, torch.zeros((), dtype=t.dtype))
        return t.view(torch.int64) if t.dtype == torch.float64 else t

    live = ~b.nulls
    if isinstance(b, B.RowColumn):
        return [b.nulls] + [t for f in b.fields for t in _lanes(f)]
    if isinstance(b, (B.ArrayColumn, B.MapColumn)):
        inr = (torch.arange(b.max_cardinality)[None, :]
               < b.lengths[:, None]) & live[:, None]
        if isinstance(b, B.ArrayColumn):
            keys, vals, vnulls = [], b.elements, b.elem_nulls
        else:
            keys, vals, vnulls = [keep(b.keys, inr)], b.values, b.value_nulls
        return [b.nulls, keep(b.lengths, live), keep(vnulls, inr),
                keep(vals, inr & ~vnulls)] + keys
    if isinstance(b, B.StringColumn):
        pos = torch.arange(b.max_len)[None, :] < b.lengths[:, None]
        return [b.nulls, keep(b.lengths, live),
                keep(b.chars, pos & live[:, None])]
    return [b.nulls, keep(b.values, live)]


def _same_lanes(gpu, cpu):
    import torch
    a, b = _lanes(gpu), _lanes(cpu)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def nested_full_size(seed):
    """Maps, rows and a dictionary of NESTED_ROWS rows built as tensors
    on the card from `seed`: a map(bigint, bigint) of fanout NESTED_K
    (keys distinct in each row, a twentieth of the values and a fiftieth
    of the maps NULL), a probe key that hits in most rows, a row(bigint,
    double), and a varchar dictionary of 25 words. Each operation runs
    on the card (median of NESTED_REPEATS after one run) and on the CPU
    over copies of the same tensors, and the two results must be equal
    lane for lane. Returns {operation: card ms}."""
    import torch
    from presto_tpu_torch import types as T
    from presto_tpu_torch.block import (Batch, Column, DictionaryColumn,
                                        MapColumn, RowColumn, from_numpy)
    from presto_tpu_torch.expr import call, const, input_ref
    from presto_tpu_torch.expr.compile import evaluate
    from presto_tpu_torch.expr.ir import Lambda, LambdaVariable
    from presto_tpu_torch.ops import kernels as K
    from presto_tpu_torch.ops.aggregation import (AggSpec, finalize_states,
                                                  group_by)
    from presto_tpu_torch.ops.unnest import unnest

    n, k, dev = NESTED_ROWS, NESTED_K, torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def ints(lo, hi, *shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    big, dbl = T.BIGINT, T.DOUBLE
    map_t = T.map_of(big, big)
    lengths = ints(0, k + 1, n, dtype=torch.int32)
    in_range = torch.arange(k, device=dev)[None, :] < lengths[:, None]
    keys = ints(0, 1000, n, 1) + torch.arange(k, device=dev) * 1000
    m = MapColumn(keys, ints(-10 ** 6, 10 ** 6, n, k),
                  (rand(n, k) < 0.05) | ~in_range, lengths, rand(n) < 0.02,
                  map_t)
    probe = Column(keys[:, 0] + 1000 * ints(0, k + 2, n), rand(n) < 0.01, big)
    wide = Column(ints(-10 ** 9, 10 ** 9, n), rand(n) < 0.05, big)
    row = RowColumn((wide, Column(torch.randn(n, generator=g, device=dev,
                                              dtype=torch.float64),
                                  rand(n) < 0.05, dbl)),
                    rand(n) < 0.03, T.row_of(big, dbl))
    words = from_numpy(T.varchar(12), np.array([f"word{i:02d}"
                                                for i in range(25)],
                                               dtype=object), device=dev)
    dictionary = DictionaryColumn(ints(0, 25, n, dtype=torch.int32), words,
                                  rand(n) < 0.01, T.varchar(12))
    batch = Batch((m, probe, row, wide, dictionary),
                  torch.ones(n, dtype=torch.bool, device=dev))
    mb = sum(t.numel() * t.element_size()
             for t in (m.keys, m.values, m.value_nulls, m.lengths, m.nulls))
    print(f"nested full size: {n:,} maps of fanout {k} ({mb / 1e6:.1f} MB "
          "with their masks), a row and a dictionary column")

    M, P, R, W, DI = (input_ref(i, t) for i, t in enumerate(
        (map_t, big, T.row_of(big, dbl), big, T.varchar(12))))
    kv = ("k", "v")
    kk, vv = LambdaVariable(big, "k"), LambdaVariable(big, "v")
    exprs = {
        "element_at": call("element_at", big, M, P),
        "cardinality": call("cardinality", big, M),
        "map_keys": call("map_keys", T.array_of(big), M),
        "map_values": call("map_values", T.array_of(big), M),
        "transform_values": call("transform_values", map_t, M, Lambda(
            big, kv, call("add", big, vv, call("multiply", big, kk, W)))),
        "transform_keys": call("transform_keys", map_t, M, Lambda(
            big, kv, call("multiply", big, kk, const(2, big)))),
        "map_filter": call("map_filter", map_t, M, Lambda(
            T.BOOLEAN, kv, call("gt", T.BOOLEAN, vv, const(0, big)))),
        "row_field_0": call("row_field", big, R, const(0, T.INTEGER)),
        "row_field_1": call("row_field", dbl, R, const(1, T.INTEGER)),
    }
    aggs = [AggSpec("sum", 1, big), AggSpec("count_star", None, big)]
    ops = {name: (lambda b, e=e: evaluate(e, b)) for name, e in exprs.items()}
    ops["unnest_map"] = lambda b: unnest(Batch(b.columns[:2], b.active), 0,
                                         n * k, with_ordinality=True)[0]
    ops["group_by_dictionary"] = lambda b: finalize_states(group_by(
        Batch((b.columns[4], b.columns[3]), b.active), [0], aggs, 64).batch,
        1, aggs)

    def result_blocks(out):
        if not isinstance(out, Batch):
            return [out]
        return list(out.columns) + [Column(
            out.active, torch.zeros_like(out.active), T.BOOLEAN)]

    cpu_batch = Batch(tuple(_to_device(c, "cpu") for c in batch.columns),
                      batch.active.cpu())
    times, cpu_s = {}, {}
    for name, op in ops.items():
        for c in K.LAUNCHES:
            K.LAUNCHES[c] = 0
        gpu = op(batch)
        launches = dict(K.LAUNCHES)
        times[name] = wall_ms(lambda: op(batch), repeats=NESTED_REPEATS)
        t1 = time.perf_counter()
        cpu = op(cpu_batch)
        cpu_s[name] = time.perf_counter() - t1
        a, b = result_blocks(gpu), result_blocks(cpu)
        if len(a) != len(b) or not all(_same_lanes(x, y)
                                       for x, y in zip(a, b)):
            raise AssertionError(f"nested {name} at full size: the card's "
                                 "result differs from the CPU's")
        if name == "group_by_dictionary" and launches["fused_limb_sums"] < 1:
            raise AssertionError("the group-by over the dictionary (25 "
                                 "groups) launched no fused_limb_sums: "
                                 f"{launches}")
        print(f"nested {name}: {times[name]:.3f} ms on the card, equal to "
              f"the CPU's ({cpu_s[name]:.2f} s); launches {launches}")
        del gpu, cpu, a, b
    del batch, cpu_batch
    torch.cuda.empty_cache()
    return {"rows": n, "k": k, "map_mb": mb / 1e6, "ms": times,
            "cpu_s": cpu_s}


Q1_TABLES = {"lineitem": ["returnflag", "linestatus", "quantity",
                          "extendedprice", "discount", "tax", "shipdate"]}
Q6_TABLES = {"lineitem": ["shipdate", "discount", "quantity",
                          "extendedprice"]}
Q3_TABLES = {"lineitem": ["orderkey", "extendedprice", "discount",
                          "shipdate"],
             "orders": ["orderdate", "shippriority", "custkey", "orderkey"],
             "customer": ["mktsegment"]}
Q14_TABLES = {"lineitem": ["extendedprice", "discount", "partkey",
                           "shipdate"],
              "part": ["type"]}

# the limb matrices of q1 at SF1 for the per-tile kernel: the same 39
# requests as the reference's fused pool (31 thirteen-bit sums and 8
# one-bit counts, one count per aggregate). The wide form hands the kernel
# its float32 13-bit limbs; the int16 8-bit form is what the unfused narrow
# path built before fused_limb_sums took its place
Q1_KERNEL_SHAPES = {"int16x8": (6_000_000, 16, 70),
                    "f32x13": (6_000_000, 16, 39)}


TPCDS_EXECUTE_REPEATS = 2
# processes (and torch threads each) that compute the CPU side of
# phase_tpcds's cross-check while the card runs the other phases
TPCDS_CPU_WORKERS, TPCDS_CPU_THREADS = 3, 2
# the cross-check's slowest plans on the CPU (84-302 s each on an H100
# machine's host, 2 threads), handed out first
TPCDS_CPU_SLOWEST = ("q47", "q51", "q67", "q14", "q57", "q77")


def _tpcds_order(name):
    return int(name[1:])


def _plan_has(plan_json, *kinds):
    return any(next(_plan_nodes(plan_json, k), None) is not None
               for k in kinds)


def _tpcds_cross_names(corpus):
    """The queries whose SF1 plan holds a Window or GroupId node."""
    return [n for n in sorted(corpus, key=_tpcds_order)
            if _plan_has(corpus[n]["plan_timed"], "window", "groupid")]


def start_tpcds_cpu_rows(out_dir):
    """Start the CPU side of phase_tpcds's cross-check: worker
    processes (this script with --tpcds-cpu-rows) that run the SF1
    plans with a Window or GroupId node through run_query(device="cpu")
    and write their rows to `out_dir`. Each worker claims the next
    unclaimed plan (a file created exclusively in `out_dir`), the
    slowest first. Returns [(process, path)]."""
    procs = []
    for k in range(TPCDS_CPU_WORKERS):
        path = os.path.join(out_dir, f"tpcds_cpu_rows_{k}.json")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--tpcds-cpu-rows",
             out_dir, "--out", path]), path))
    return procs


def tpcds_cpu_rows(claim_dir, out):
    """The worker: each plan it claims through run_query on the CPU;
    {name: {"rows": exact rows, "s": seconds}} to `out`."""
    import torch
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.queries import load_tpcds_corpus
    torch.set_num_threads(TPCDS_CPU_THREADS)
    os.nice(10)  # the card's host work comes first
    install_host_cache()
    corpus = load_tpcds_corpus()
    names = _tpcds_cross_names(corpus)
    names.sort(key=lambda n: (n not in TPCDS_CPU_SLOWEST,
                              TPCDS_CPU_SLOWEST.index(n)
                              if n in TPCDS_CPU_SLOWEST else 0))
    rows = {}
    for name in names:
        try:
            os.close(os.open(os.path.join(claim_dir, name + ".claim"),
                             os.O_CREAT | os.O_EXCL))
        except FileExistsError:
            continue
        e = corpus[name]
        t0 = time.perf_counter()
        res = run_query(from_json(e["plan_timed"]), sf=e["timed_sf"],
                        device="cpu", prepared=True,
                        default_join_capacity=e["timed_join_capacity"])
        rows[name] = {"rows": _exact_rows(res),
                      "s": time.perf_counter() - t0}
    with open(out, "w") as f:
        json.dump(rows, f)


def _tpcds_sf1_query(name, e, window_or_groupid):
    """One TPC-DS SF1 plan on the card (phase_tpcds): the host generation
    of the tables it scans that no earlier plan generated, the ladder
    run, the counted run, three executes. Returns (report, exact rows)."""
    import torch
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.exec.runner import execute
    from presto_tpu_torch.ops import kernels as K
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.plan.widths import annotate_widths
    sf, jc = e["timed_sf"], e["timed_join_capacity"]

    def plan():
        return from_json(e["plan_timed"])

    # the scanned tables are generated before the first run, as
    # phase_query's oracles generate theirs, so that first_run_query_ms
    # holds staging and the ladder but no host generation
    t1 = time.perf_counter()
    for table, cols in _scanned_columns(e["plan_timed"]).items():
        host_columns(table, sf, cols, connector="tpcds")
    gen_ms = (time.perf_counter() - t1) * 1e3
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    t1 = time.perf_counter()
    first = run_query(plan(), sf=sf, default_join_capacity=jc, prepared=True)
    first_ms = (time.perf_counter() - t1) * 1e3
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, syncs = _count_syncs(lambda: run_query(
        plan(), sf=sf, default_join_capacity=jc, prepared=True))
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    launches = dict(K.LAUNCHES)
    if res.stats["capacity_reruns"]:
        raise AssertionError(f"TPC-DS {name} climbed the ladder again "
                             f"after its first run: {res.stats}")
    rows = _exact_rows(res)
    if not _close_rows(rows, _exact_rows(first)):
        raise AssertionError(f"TPC-DS {name} at SF1: the counted run's "
                             "rows differ from the first run's")
    small = _small_keyed_aggs(e["plan_timed"])
    if launches["contains_bytes"]:
        raise AssertionError(f"TPC-DS {name} launched contains_bytes: "
                             f"{launches}")
    if small and launches["fused_limb_sums"] < 1:
        raise AssertionError(f"TPC-DS {name} has small-table "
                             f"aggregations {small} but its rows came "
                             f"from no fused_limb_sums launch: {launches}")
    root = annotate_widths(plan(), sf)
    batches = run_query_batches(root, sf)
    staged_mb = _staged_bytes(batches) / 1e6
    times = []
    for _ in range(TPCDS_EXECUTE_REPEATS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        execute(root, batches, default_join_capacity=jc)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    del batches
    torch.cuda.empty_cache()
    return {"query": name, "sf": sf, "rows": len(rows),
            "host_generation_ms": gen_ms, "first_run_query_ms": first_ms,
            "capacity_reruns": first.stats["capacity_reruns"],
            "capacity_scale": first.stats["capacity_scale"],
            "execute_ms": statistics.median(times),
            "execute_ms_runs": times, "host_syncs": syncs,
            "peak_mb": peak_mb, "staged_mb": staged_mb,
            "fused_limb_sums": launches["fused_limb_sums"],
            "small_table_max_groups": small,
            "window_or_groupid": window_or_groupid}, rows


def phase_tpcds(log_path=None):
    """The 99 TPC-DS queries of the committed corpus
    (presto_tpu_torch/queries/tpcds.json) through run_query on the card.

    * Exactness: each query's small plan at its suite scale factor, its
      rows held to the reference's committed rows in exact form
      (doubles within rel 1e-9).
    * Timing at SF1 (q72 at sf 0.2: its plan's first join outgrows the
      card at SF1, scripts/make_tpcds_corpus.py::TIMED_SF): each
      query's scanned host columns are generated first (those no
      earlier plan generated, host_generation_ms), then its timed plan
      runs once to climb the overflow ladder (first_run_query_ms:
      staging and every attempt, no generation; reruns, largest factor),
      then once more in one attempt with the kernel counts at 0 (the
      launches, host syncs and peak device memory, staged batches
      included, of the attempt that returns the rows; its rows equal
      the first run's), then its staged batches execute
      TPCDS_EXECUTE_REPEATS times (the median is execute_ms). A plan
      with a small-table keyed aggregation must launch fused_limb_sums
      on that attempt; none may launch contains_bytes.
    * Cross-check at SF1: each of the 22 plans with a Window or GroupId
      node runs again through run_query(device="cpu") on this host, in
      the worker processes that start_tpcds_cpu_rows started, beside
      the card's phases; tpcds_cross_check holds their rows to the
      card's (doubles within rel 1e-9) after phase_exec.

    Each timed query's report is also appended to `log_path` (JSON
    lines) as it comes, when given. Returns the reports and the card's
    rows of the 22 cross-checked SF1 plans, by query."""
    import torch
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.queries import load_tpcds_corpus

    corpus = load_tpcds_corpus()
    names = sorted(corpus, key=_tpcds_order)
    if len(names) != 99:
        raise AssertionError(f"{len(names)} TPC-DS queries, not 99")
    t0 = time.perf_counter()
    for name in names:
        e = corpus[name]
        res = run_query(from_json(e["plan"]), sf=e["sf"], prepared=True,
                        default_join_capacity=e["join_capacity"])
        got = _exact_rows(res)
        if res.names != e["names"] or not _close_rows(got, e["rows"]):
            raise AssertionError(
                f"TPC-DS {name} at sf {e['sf']}: rows differ from the "
                f"reference's ({len(got)} vs {len(e['rows'])}):\n got  "
                f"{got[:5]}\n want {e['rows'][:5]}")
    exact_s = time.perf_counter() - t0
    print(f"tpcds: all 99 queries equal the reference's rows at their "
          f"suite scale factors ({exact_s:.1f} s)")

    cross = _tpcds_cross_names(corpus)
    if len(cross) != 22:
        raise AssertionError(f"{len(cross)} SF1 plans with a Window or "
                             f"GroupId node, not 22: {cross}")
    reports, card_rows, failed = [], {}, {}
    for name in names:
        try:
            rep, rows = _tpcds_sf1_query(name, corpus[name], name in cross)
        except Exception as ex:  # the phase fails after the loop
            failed[name] = f"{type(ex).__name__}: {ex}"
            print(f"TPC-DS {name} at SF1 FAILED:\n{traceback.format_exc()}")
            torch.cuda.empty_cache()
            continue
        if name in cross:
            card_rows[name] = rows
        print(json.dumps(rep))
        if log_path:
            with open(log_path, "a") as f:
                f.write(json.dumps(rep) + "\n")
        reports.append(rep)
    if failed:
        raise AssertionError(f"{len(failed)} TPC-DS SF1 plans failed on the "
                             f"card: {sorted(failed, key=_tpcds_order)}")
    print("tpcds: " + json.dumps(
        {r["query"]: {k: r[k] for k in (
            "rows", "host_generation_ms", "first_run_query_ms",
            "capacity_reruns",
            "capacity_scale", "execute_ms", "host_syncs", "peak_mb",
            "staged_mb", "fused_limb_sums")} for r in reports}))
    return {"queries": reports, "exactness_s": exact_s}, card_rows


def tpcds_cross_check(cpu_procs, card_rows):
    """The end of phase_tpcds's cross-check: wait for the CPU workers
    (`cpu_procs`) and hold the card's rows of the 22 Window/GroupId SF1
    plans (`card_rows`) to theirs, doubles within rel 1e-9. It runs
    after phase_exec, so that the workers' tail overlaps phase_exec
    instead of idling the card, and before phase_sql, whose statements
    are timed on a host the workers no longer load. Returns the
    workers' CPU seconds per query and the seconds waited."""
    t0 = time.perf_counter()
    cpu = {}
    for proc, path in cpu_procs:
        if proc.wait() != 0:
            raise AssertionError(f"a TPC-DS CPU worker exited "
                                 f"{proc.returncode}")
        with open(path) as f:
            cpu.update(json.load(f))
    wait_s = time.perf_counter() - t0
    cross = sorted(card_rows, key=_tpcds_order)
    if sorted(cpu) != sorted(cross):
        raise AssertionError(f"the CPU workers ran {sorted(cpu)}")
    for name in cross:
        if not _close_rows(card_rows[name], cpu[name]["rows"]):
            raise AssertionError(f"TPC-DS {name} at SF1: the card's rows "
                                 "differ from the port's CPU rows")
    cross_s = {n: cpu[n]["s"] for n in cross}
    print(f"tpcds: the {len(cross)} Window/GroupId queries at SF1 equal "
          f"the port's CPU rows (CPU seconds each {cross_s}; waited "
          f"{wait_s:.1f} s for the workers)")
    return {"cross_check_cpu_s": cross_s, "cross_check_wait_s": wait_s}


# ---------------------------------------------------------------------------
# exec/ off the main path: dynamic filtering, split streaming, spill,
# the memory connector's writes
# ---------------------------------------------------------------------------

EXEC_SPLIT_ROWS = 1 << 22  # both streamed q1 runs: the peaks compare
EXEC_SORT_SPLIT_ROWS = 1 << 18
EXEC_TPCDS = ("q3", "q42", "q52", "q55")
EXEC_EXECUTE_REPEATS = 3
EXEC_TABLE = "q1_lineitem"  # the memory connector's table


def _reset_launches():
    from presto_tpu_torch.ops import kernels as K
    for k in K.LAUNCHES:
        K.LAUNCHES[k] = 0


@contextlib.contextmanager
def _peak_mb(out):
    """Within the block, the device memory peak above what was
    allocated on entry, in MB, to out["peak_mb"]."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    yield out
    torch.cuda.synchronize()
    out["peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6


def _dyn_pair(name, plan_fn, sf, want, rows, jc=1 << 16, same=None):
    """One query with dynamic filtering on, then off, through run_query
    on the card: equal rows, equal to `want` (when given; `same(got,
    want)` in place of equality), and no more bytes staged on than
    off. The on run's filters, collect ms, rows
    pruned, staged MB, first_run_query_ms, peak MB above the memory
    live before it, and execute_ms over the batches it stages."""
    import torch
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.exec.runner import execute
    from presto_tpu_torch.plan.widths import annotate_widths
    rep = {"query": name, "sf": sf}
    with _peak_mb(rep):
        t0 = time.perf_counter()
        on = run_query(as_built(plan_fn(), sf), sf=sf,
                       default_join_capacity=jc, prepared=True)
        rep["first_run_query_ms"] = (time.perf_counter() - t0) * 1e3
    root = annotate_widths(plan_fn(), sf)
    batches = run_query_batches(root, sf)
    rep["execute_ms"] = wall_ms(lambda: execute(
        root, batches, default_join_capacity=jc),
        repeats=EXEC_EXECUTE_REPEATS)
    del batches
    t0 = time.perf_counter()
    off = run_query(as_built(plan_fn(), sf), sf=sf, prepared=True,
                    default_join_capacity=jc,
                    session={"dynamic_filtering": False})
    rep["off_first_run_query_ms"] = (time.perf_counter() - t0) * 1e3
    got_on, got_off = rows(on), rows(off)
    if got_on != got_off:
        raise AssertionError(f"{name}: rows with dynamic filtering on "
                             f"differ from off:\n on  {got_on[:5]}\n off "
                             f"{got_off[:5]}")
    if want is not None and not (same(got_on, want) if same
                                 else got_on == want):
        raise AssertionError(f"{name}: rows differ from the oracle:\n got "
                             f" {got_on[:5]}\n want {want[:5]}")
    if on.stats["staged_bytes"] > off.stats["staged_bytes"]:
        raise AssertionError(f"{name}: staged more with filtering on "
                             f"({on.stats['staged_bytes']} bytes) than "
                             f"off ({off.stats['staged_bytes']})")
    rep.update(
        rows=len(got_on), filters=on.stats.get("dynamic_filters", 0),
        collect_ms=on.stats["dynamic_filter_collect_s"] * 1e3,
        rows_pruned=on.stats.get("dynamic_filter_rows_pruned", 0),
        rows_staged=on.stats.get("dynamic_filter_rows_staged"),
        staged_mb=on.stats["staged_bytes"] / 1e6,
        off_staged_mb=off.stats["staged_bytes"] / 1e6,
        stage_ms=on.stats["scan_stage_s"] * 1e3,
        off_stage_ms=off.stats["scan_stage_s"] * 1e3)
    print(json.dumps(rep))
    torch.cuda.empty_cache()
    return rep


def exec_dynamic_filters():
    """Part 1: every entry of the committed SF1 TPC-H corpus in which
    collect_dynamic_filters finds a filter (against its committed
    rows), q3 and q14 at SF10 (against the numpy oracles; no filter
    qualifies there), and TPC-DS q3, q42, q52 and q55 at SF1 (on
    against off) and at their suite scale factor (against the
    committed rows)."""
    import torch
    from presto_tpu_torch.exec.dynfilter import collect_dynamic_filters
    from presto_tpu_torch.plan import from_json
    from presto_tpu_torch.plan.widths import annotate_widths
    from presto_tpu_torch.queries import load_corpus, load_tpcds_corpus
    dev = torch.device("cuda")
    reports = []
    corpus = load_corpus()
    for name in sorted(corpus, key=_corpus_order):
        e = corpus[name]
        if not collect_dynamic_filters(
                annotate_widths(from_json(e["plan"]), e["sf"]), e["sf"],
                dev):
            continue
        reports.append(_dyn_pair(name, lambda e=e: from_json(e["plan"]),
                                 e["sf"], e["rows"], _exact_rows))
    for name, plan_fn, oracle, tables in (
            ("q3", q3_plan, numpy_q3, Q3_TABLES),
            ("q14", q14_plan, numpy_q14, Q14_TABLES)):
        want = oracle({t: host_columns(t, SF_JOIN, cols)
                       for t, cols in tables.items()})
        reports.append(_dyn_pair(name, plan_fn, SF_JOIN, want, _plain_rows))
    tpcds = load_tpcds_corpus()
    for name in EXEC_TPCDS:
        e = tpcds[name]
        reports.append(_dyn_pair(
            f"tpcds_{name}", lambda e=e: from_json(e["plan"]), e["sf"],
            e["rows"], _exact_rows, e["join_capacity"], same=_close_rows))
        reports.append(_dyn_pair(
            f"tpcds_{name}_sf1", lambda e=e: from_json(e["plan_timed"]),
            e["timed_sf"], None, _exact_rows, e["timed_join_capacity"]))
    # q3 and q14 find none at SF10, as the reference's rule decides
    # there: q14's part build (2.0M rows) and q3's orders build (15M x
    # the filter's 0.33) pass _MAX_BUILD_ROWS, and q3's customer join
    # probes with a key of that build side
    missing = [r["query"] for r in reports
               if not r["filters"] and r["sf"] != SF_JOIN]
    if missing:
        raise AssertionError("queries of the dynamic-filtering part found "
                             f"no filter on the card: {missing}")
    return reports


def q1_agg_plan():
    """q1's aggregation under an Output alone (q1_plan without its
    Sort): the shape split streaming runs."""
    from presto_tpu_torch.plan import OutputNode
    root = q1_plan()
    return OutputNode(root.source.source, root.names)


def _q1_run(sf, split_rows):
    """q1's aggregation through run_query on the card, streamed in
    splits of `split_rows` (None: unsplit): its rows (sorted),
    fused_limb_sums launches, host syncs, peak MB above the memory live
    before it, wall ms and split counters. No warm-up run: a streamed
    run's wall is its splits' host generation, which no warm-up
    shortens."""
    import torch
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.ops import kernels as K
    _reset_launches()
    rep = {"sf": sf, "split_rows": split_rows}
    with _peak_mb(rep):
        t0 = time.perf_counter()
        res, syncs = _count_syncs(lambda: run_query(
            as_built(q1_agg_plan(), sf), sf=sf, split_rows=split_rows,
            prepared=True))
        rep["run_query_ms"] = (time.perf_counter() - t0) * 1e3
    st = res.stats
    rep.update(host_syncs=syncs,
               fused_limb_sums=K.LAUNCHES["fused_limb_sums"],
               splits=st.get("splits", 1))
    if split_rows is not None:
        # split_device_s: the device timeline of the splits (CUDA only)
        rep.update(
            host_stage_ms_per_split=st["split_stage_s"] * 1e3 / st["splits"],
            device_ms_per_split=st.get("split_device_s", float("nan"))
            * 1e3 / st["splits"],
            host_syncs_per_split=syncs / st["splits"])
    else:
        rep.update(stage_ms=st["scan_stage_s"] * 1e3,
                   execute_ms=st["execute_s"] * 1e3,
                   staged_mb=st["staged_bytes"] / 1e6)
    torch.cuda.empty_cache()
    return sorted(_plain_rows(res)), rep


def exec_streaming(sf10_rows=None):
    """Part 2: q1's aggregation over lineitem streamed in splits of
    EXEC_SPLIT_ROWS at SF1 (6.0M rows, 2 splits), against numpy_q1 and
    the unsplit SF1 run, and at SF10 (60M rows, 15 splits) against
    numpy_q1 at SF10: `sf10_rows()` returns those rows (None: computed
    here; chip_smoke.py's full run has a worker compute them beside the
    earlier phases). One SF10 run, not two, to keep the whole run within
    its time: the unsplit SF10 run took about a minute. The SF10
    streamed peak must stay within 1.1x of the SF1 one, and below the
    bytes an unsplit SF10 run must stage at once (the unsplit SF1 run's
    staged bytes a padded row, times SF10's rows), a floor of the
    unsplit peak. Each split's group-by and each running merge launch
    fused_limb_sums (16 groups; a merge sums 128-bit states, whose limbs
    take more than one launch's sources)."""
    from presto_tpu_torch.exec.runner import _padded
    want = sorted(oracle_rows(numpy_q1, Q1_TABLES, SF))
    out = {}
    streamed, rs = _q1_run(SF, EXEC_SPLIT_ROWS)
    whole, rw = _q1_run(SF, None)
    if streamed != whole or streamed != want:
        raise AssertionError(f"q1 streamed at sf {SF}: rows differ\n "
                             f"streamed {streamed}\n unsplit {whole}")
    if rw["fused_limb_sums"] != 1:
        raise AssertionError(f"q1 unsplit at sf {SF}: {rw}")
    out[f"sf{SF:g}"] = {"streamed": rs, "unsplit": rw}
    streamed10, rs10 = _q1_run(SF_JOIN, EXEC_SPLIT_ROWS)
    want10 = sorted(sf10_rows() if sf10_rows is not None
                    else oracle_rows(numpy_q1, Q1_TABLES, SF_JOIN))
    if streamed10 != want10:
        raise AssertionError(f"q1 streamed at sf {SF_JOIN:g}: rows differ "
                             f"from numpy_q1\n streamed {streamed10}\n "
                             f"numpy {want10}")
    out[f"sf{SF_JOIN:g}"] = {"streamed": rs10}
    for sf, rep in ((SF, rs), (SF_JOIN, rs10)):
        n = -(-tpch_rows("lineitem", sf) // EXEC_SPLIT_ROWS)
        if rep["splits"] != n or rep["fused_limb_sums"] < 2 * n - 1:
            raise AssertionError(f"q1 at sf {sf}: each of {n} splits and "
                                 f"{n - 1} merges must launch "
                                 f"fused_limb_sums (streamed {rep})")
        print(f"exec streaming sf {sf:g}: {json.dumps(out[f'sf{sf:g}'])}")
    if not rs10["peak_mb"] <= 1.1 * rs["peak_mb"]:
        raise AssertionError(f"streamed peaks: SF10 {rs10['peak_mb']:.1f} "
                             f"MB against SF1 {rs['peak_mb']:.1f} MB")
    unsplit10_mb = (rw["staged_mb"] / _padded(tpch_rows("lineitem", SF))
                    * tpch_rows("lineitem", SF_JOIN))
    if not rs10["peak_mb"] < unsplit10_mb:
        raise AssertionError(f"q1 streamed at sf {SF_JOIN:g} peaks at "
                             f"{rs10['peak_mb']:.1f} MB, not below the "
                             f"{unsplit10_mb:.1f} MB an unsplit run stages")
    out[f"sf{SF_JOIN:g}"]["unsplit_staged_mb_floor"] = unsplit10_mb
    return out


def start_q1_rows(out_dir, sf):
    """Start a worker (this script with --q1-rows) that computes
    numpy_q1's rows at `sf` from host columns it generates itself, to a
    file in `out_dir`. Returns (process, path)."""
    path = os.path.join(out_dir, f"q1_rows_sf{sf:g}.json")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--q1-rows", str(sf),
         "--out", path]), path


def q1_rows(sf, out):
    """The worker: numpy_q1's rows at `sf`, as JSON, to `out`."""
    os.nice(10)  # the card's host work comes first
    rows = numpy_q1({"lineitem": host_columns("lineitem", sf,
                                              Q1_TABLES["lineitem"])})
    with open(out, "w") as f:
        json.dump(rows, f)


def wait_q1_rows(worker):
    """The rows of a start_q1_rows worker, once it has exited."""
    proc, path = worker
    t0 = time.perf_counter()
    if proc.wait() != 0:
        raise AssertionError(f"the q1 rows worker exited {proc.returncode}")
    with open(path) as f:
        rows = [tuple(r) for r in json.load(f)]
    print(f"exec streaming: waited {time.perf_counter() - t0:.1f} s for "
          f"numpy_q1's rows")
    return rows


def tpch_rows(table, sf):
    from presto_tpu_torch.connectors import tpch
    return tpch.table_row_count(table, sf)


def _tpch_scan(table, cols):
    from presto_tpu_torch.connectors import tpch
    from presto_tpu_torch.plan import TableScanNode
    return TableScanNode("tpch", table, cols,
                         [tpch.column_type(table, c) for c in cols])


def _sorted_arrays(cols):
    """Rows of int64-able columns in lexicographic order, one array
    each."""
    arrs = [np.asarray(c).astype(np.int64) for c in cols]
    perm = np.lexsort(arrs[::-1])
    return [a[perm] for a in arrs]


def exec_spill():
    """Part 3, at SF1: the aggregation of lineitem by partkey (200,000
    groups) under a budget of a quarter of its planned state table (8
    buckets), lineitem x orders on orderkey under a budget of three
    quarters of its planned inputs (4 buckets), and the external sort of orders by totalprice
    descending then orderkey in splits of EXEC_SORT_SPLIT_ROWS; each
    against the port's unspilled run."""
    import torch
    from presto_tpu_torch import types as T
    from presto_tpu_torch.block import to_numpy
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.exec.spill import (plan_join_bytes,
                                             plan_state_bytes,
                                             run_spilled_join,
                                             spill_bucket_count)
    from presto_tpu_torch.exec.streaming import run_spilled_sort
    from presto_tpu_torch.ops.aggregation import AggSpec
    from presto_tpu_torch.plan import (AggregationNode, JoinNode, OutputNode,
                                       SortNode)
    dev = torch.device("cuda")
    out = {}

    agg = AggregationNode(
        _tpch_scan("lineitem", ["partkey", "quantity", "extendedprice"]),
        [0], [AggSpec("count_star", None, T.BIGINT),
              AggSpec("sum", 1, T.decimal(38, 2)),
              AggSpec("min", 2, T.decimal(12, 2))], max_groups=1 << 18)
    plan = OutputNode(agg, ["partkey", "c", "q", "mn"])
    budget = plan_state_bytes(agg) // 4
    rep, base = {"budget_bytes": budget}, {}
    with _peak_mb(base):
        t0 = time.perf_counter()
        whole = run_query(as_built(plan, SF), sf=SF, prepared=True)
        base["run_query_ms"] = (time.perf_counter() - t0) * 1e3
    with _peak_mb(rep):
        t0 = time.perf_counter()
        spilled = run_query(as_built(plan, SF), sf=SF, prepared=True,
                            split_rows=EXEC_SPLIT_ROWS,
                            hbm_budget_bytes=budget)
        rep["run_query_ms"] = (time.perf_counter() - t0) * 1e3
    if sorted(_plain_rows(spilled)) != sorted(_plain_rows(whole)) or \
            whole.row_count != tpch_rows("part", SF):
        raise AssertionError("the spilled aggregation's rows differ from "
                             "the unspilled run's")
    rep.update(buckets=spilled.stats["spill_buckets"],
               spilled_mb=spilled.stats["spilled_bytes"] / 1e6,
               unspilled=base)
    if rep["buckets"] != spill_bucket_count(plan_state_bytes(agg), budget) \
            or rep["buckets"] < 8:
        raise AssertionError(f"spilled aggregation: {rep}")
    out["aggregation"] = rep
    print(f"exec spill aggregation: {json.dumps(rep)}")
    del whole, spilled
    torch.cuda.empty_cache()

    join = JoinNode(_tpch_scan("lineitem", ["orderkey", "quantity"]),
                    _tpch_scan("orders", ["orderkey", "totalprice"]),
                    [0], [0], "inner")
    rows = tpch_rows("lineitem", SF)
    budget = 3 * plan_join_bytes(join, SF) // 4 + 1  # 4 buckets
    rep, base, stats = {"budget_bytes": budget}, {}, {}
    with _peak_mb(base):
        t0 = time.perf_counter()
        whole = run_query(as_built(OutputNode(join, ["k", "q", "k2", "tp"]),
                                   SF), sf=SF, prepared=True,
                          default_join_capacity=1 << 23)
        base["run_query_ms"] = (time.perf_counter() - t0) * 1e3
    with _peak_mb(rep):
        t0 = time.perf_counter()
        got = run_spilled_join(join, SF, EXEC_SPLIT_ROWS, budget, dev, stats)
        rep["ms"] = (time.perf_counter() - t0) * 1e3
    act = got.active.numpy()
    got_cols = _sorted_arrays([to_numpy(c)[0][act] for c in got.columns])
    want_cols = _sorted_arrays(whole.columns)
    if whole.row_count != rows or \
            any(not np.array_equal(a, b) for a, b in zip(got_cols,
                                                         want_cols)):
        raise AssertionError("the spilled join's rows differ from the "
                             "direct join's")
    # each side partitioned into n buckets, then n bucket joins
    rep.update(buckets=stats["spill_buckets"] // 3,
               spilled_mb=stats["spilled_bytes"] / 1e6, unspilled=base)
    if rep["buckets"] != 4:
        raise AssertionError(f"spilled join: {rep}")
    out["join"] = rep
    print(f"exec spill join: {json.dumps(rep)}")
    del whole, got
    torch.cuda.empty_cache()

    sort = OutputNode(SortNode(_tpch_scan("orders", ["orderkey",
                                                     "totalprice"]),
                               [(1, True, True), (0, False, True)]),
                      ["orderkey", "totalprice"])
    rep, base = {"split_rows": EXEC_SORT_SPLIT_ROWS}, {}
    with _peak_mb(base):
        t0 = time.perf_counter()
        whole = run_query(as_built(sort, SF), sf=SF, prepared=True)
        base["run_query_ms"] = (time.perf_counter() - t0) * 1e3
    with _peak_mb(rep):
        t0 = time.perf_counter()
        cols, _nulls, _names = run_spilled_sort(sort, SF,
                                                EXEC_SORT_SPLIT_ROWS, dev)
        rep["ms"] = (time.perf_counter() - t0) * 1e3
    if any(not np.array_equal(np.asarray(a).astype(np.int64),
                              np.asarray(b).astype(np.int64))
           for a, b in zip(cols, whole.columns)) or \
            len(cols[0]) != tpch_rows("orders", SF):
        raise AssertionError("the spilled sort's order differs from the "
                             "device sort's")
    rep.update(runs=-(-len(cols[0]) // EXEC_SORT_SPLIT_ROWS), unspilled=base)
    out["sort"] = rep
    print(f"exec spill sort: {json.dumps(rep)}")
    del whole
    torch.cuda.empty_cache()
    return out


def exec_writes():
    """Part 4: CTAS of q1's seven lineitem columns at SF1 (6.0M rows)
    into the memory connector; q1 over that table against numpy_q1,
    with one fused_limb_sums launch on the run that returns its rows;
    then DELETE WHERE shipdate > the q1 cutoff, its count and the rows
    left against numpy."""
    import torch
    from presto_tpu_torch import types as T
    from presto_tpu_torch.connectors import memory
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.expr import call, const, input_ref
    from presto_tpu_torch.ops import kernels as K
    from presto_tpu_torch.plan import (OutputNode, ProjectNode,
                                       TableFinishNode, TableRewriteNode,
                                       TableScanNode, TableWriterNode)
    cols = Q1_TABLES["lineitem"]
    host = host_columns("lineitem", SF, cols)
    rows = tpch_rows("lineitem", SF)
    scan = _tpch_scan("lineitem", cols)
    memory.reset()
    rep = {}
    writer = TableWriterNode(scan, "memory", EXEC_TABLE, list(cols))
    ctas = OutputNode(TableFinishNode(writer, "memory", EXEC_TABLE, True,
                                      list(cols), list(scan.column_types)),
                      ["rows"])
    t0 = time.perf_counter()
    res = run_query(ctas, sf=SF)
    rep["ctas_ms"] = (time.perf_counter() - t0) * 1e3
    rep.update(ctas_stage_ms=res.stats["scan_stage_s"] * 1e3,
               ctas_fetch_ms=res.stats["fetch_s"] * 1e3)
    if res.rows() != [(rows,)] or memory.table_row_count(EXEC_TABLE) != rows:
        raise AssertionError(f"CTAS wrote {res.rows()}, not {rows} rows")

    run_query(as_built(q1_plan("memory", EXEC_TABLE), SF), sf=SF,
              prepared=True)
    _reset_launches()
    t0 = time.perf_counter()
    res = run_query(as_built(q1_plan("memory", EXEC_TABLE), SF), sf=SF,
                    prepared=True)
    rep.update(q1_run_query_ms=(time.perf_counter() - t0) * 1e3,
               restage_ms=res.stats["scan_stage_s"] * 1e3,
               q1_execute_ms=res.stats["execute_s"] * 1e3,
               q1_fused_limb_sums=K.LAUNCHES["fused_limb_sums"])
    if _plain_rows(res) != numpy_q1({"lineitem": host}):
        raise AssertionError("q1 over the written table differs from "
                             "numpy_q1")
    if rep["q1_fused_limb_sums"] != 1:
        raise AssertionError(f"q1 over the written table: {rep}")

    cutoff = _days(Q1_CUTOFF)
    mscan = TableScanNode("memory", EXEC_TABLE, list(cols),
                          list(scan.column_types))
    changed = call("gt", T.BOOLEAN, input_ref(6, T.DATE),
                   const(Q1_CUTOFF, T.DATE))
    delete = OutputNode(TableRewriteNode(
        ProjectNode(mscan, [input_ref(i, t) for i, t in
                            enumerate(mscan.column_types)] + [changed]),
        "memory", EXEC_TABLE, "delete"), ["rows"])
    t0 = time.perf_counter()
    res = run_query(delete, sf=SF)
    rep["delete_ms"] = (time.perf_counter() - t0) * 1e3
    gone = int((host["shipdate"] > cutoff).sum())
    if res.rows() != [(gone,)] or \
            memory.table_row_count(EXEC_TABLE) != rows - gone:
        raise AssertionError(f"DELETE removed {res.rows()} rows, numpy "
                             f"{gone}; {memory.table_row_count(EXEC_TABLE)}"
                             " left")
    rep.update(deleted=gone, left=rows - gone)
    memory.reset()
    torch.cuda.empty_cache()
    print(f"exec writes: {json.dumps(rep)}")
    return rep


def phase_exec(q1_sf10_rows=None):
    """exec/ off the main path on the card, in four parts
    (exec_dynamic_filters, exec_streaming, exec_spill, exec_writes);
    `q1_sf10_rows` goes to exec_streaming. Returns their reports and
    the phase's seconds."""
    t0 = time.perf_counter()
    out = {"dynamic_filters": exec_dynamic_filters(),
           "streaming": exec_streaming(q1_sf10_rows), "spill": exec_spill(),
           "writes": exec_writes()}
    out["s"] = time.perf_counter() - t0
    print(f"exec: the phase took {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the port's SQL front door: plans from text, rows from text
# ---------------------------------------------------------------------------

# TPC-H q1 as SQL text: the columns q1_plan computes and numpy_q1 checks
SQL_Q1 = ("SELECT returnflag, linestatus, sum(quantity) AS sum_qty, "
          "sum(extendedprice) AS sum_base_price, "
          "sum(extendedprice * (1 - discount)) AS sum_disc_price, "
          "sum(extendedprice * (1 - discount) * (1 + tax)) AS sum_charge, "
          "avg(quantity) AS avg_qty, avg(extendedprice) AS avg_price, "
          "avg(discount) AS avg_disc, count(*) AS count_order "
          "FROM {table} WHERE shipdate <= date '1998-12-01' - interval "
          "'90' day GROUP BY returnflag, linestatus "
          "ORDER BY returnflag, linestatus")
# q6 with its date and discount as parameters of a prepared statement
SQL_Q6_PREPARE = ("PREPARE q6 FROM SELECT sum(extendedprice * discount) AS "
                  "revenue FROM lineitem WHERE shipdate >= ? AND shipdate "
                  "< date '1995-01-01' AND discount BETWEEN ? - 0.01 AND "
                  "? + 0.01 AND quantity < 24")
SQL_Q6_EXECUTE = "EXECUTE q6 USING date '1994-01-01', 0.06, 0.06"
SQL_TABLE = "memory.l"  # phase_sql's CTAS target
# corpus entries whose committed plan is not prepare_plan(plan_sql(sql)):
# fn_sample puts a SampleNode over the reference's plan and fn_unnest an
# UNNEST (scripts/make_functions_corpus.py::SAMPLES, UNNESTS)
SQL_HAND_BUILT = ("fn_sample", "fn_unnest")
SQL_TPCDS_SESSIONS = {"q24": {"join_reordering_strategy": "NONE"}}
SQL_REPEATS = 2


def canonical_plan(j):
    """Plan JSON with each node id replaced by the index of its first
    appearance (depth first, keys in order): two plans that are equal
    but for their ids' spelling compare equal; a wrong sharing does
    not."""
    ids = {}

    def walk(v):
        if isinstance(v, dict):
            return {k: ids.setdefault(x, len(ids)) if k == "id" else walk(x)
                    for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        return v
    return walk(j)


def plan_difference(got, want, path="", ulps=None):
    """The first place two canonical plans differ, or None. A folded
    double one ulp from the reference's is no difference (the
    reference folds under XLA, whose transcendentals are not all
    correctly rounded); it goes to `ulps`."""
    import math
    if type(got) is not type(want):
        return f"{path}: {got!r} != {want!r}"
    if isinstance(got, dict):
        if set(got) != set(want):
            return f"{path}: keys {sorted(got)} != {sorted(want)}"
        for k in got:
            d = plan_difference(got[k], want[k], f"{path}.{k}", ulps)
            if d:
                return d
        return None
    if isinstance(got, list):
        if len(got) != len(want):
            return f"{path}: {len(got)} items != {len(want)}"
        for i, (a, b) in enumerate(zip(got, want)):
            d = plan_difference(a, b, f"{path}[{i}]", ulps)
            if d:
                return d
        return None
    if isinstance(got, float) and got != want and math.isfinite(want) \
            and abs(got - want) <= math.ulp(want):
        if ulps is not None:
            ulps.append(path)
        return None
    return None if got == want else f"{path}: {got!r} != {want!r}"


def _sql_plan_cases():
    """(name, text, sf, planning keywords, committed plan JSON) of every
    corpus entry with SQL text: the TPC-H entries at SF1 (a two-stage
    one prepared for a mesh, so that the port's own add_exchanges
    distributes it), the 99 TPC-DS queries at their suite and timed
    scales, the function statements at their sf and the timed ones at
    SF1."""
    from presto_tpu_torch.queries import (load_corpus, load_functions_corpus,
                                          load_tpcds_corpus)
    out = []
    for name, e in sorted(load_corpus().items()):
        out.append((name, e["sql"], e["sf"], {
            "max_groups": e["max_groups"],
            "join_capacity": e["join_capacity"],
            "mesh": name.endswith("_two_stage")}, e["plan"]))
    for name, e in sorted(load_tpcds_corpus().items(), key=lambda kv:
                          _tpcds_order(kv[0])):
        kw = {"catalog": "tpcds", "session": SQL_TPCDS_SESSIONS.get(name)}
        out.append((f"tpcds_{name}", e["sql"], e["sf"], {
            **kw, "max_groups": e["max_groups"],
            "join_capacity": e["join_capacity"]}, e["plan"]))
        out.append((f"tpcds_{name}_timed", e["sql"], e["timed_sf"], {
            **kw, "max_groups": e["timed_max_groups"],
            "join_capacity": e["timed_join_capacity"]}, e["plan_timed"]))
    for group, entries in load_functions_corpus().items():
        for name, e in sorted(entries.items()):
            if name in SQL_HAND_BUILT:
                continue
            out.append((name, e["sql"], e["sf"], {}, e["plan"]))
            if group == "timed":
                out.append((f"{name}_sf1", e["sql"], e["sf1"], {},
                            e["plan_sf1"]))
    return out


def _sql_plan_times(text, sf, kw):
    """(prepared plan, parse ms, plan ms, prepare ms) of one text through
    the port: parse_sql alone, then plan_sql (its parse included), then
    prepare_plan (for a mesh of MESH_WORKERS workers where kw["mesh"]:
    add_exchanges among its passes)."""
    from presto_tpu_torch.exec.runner import prepare_plan
    from presto_tpu_torch.parallel import make_mesh
    from presto_tpu_torch.sql import parse_sql, plan_sql
    session = kw.get("session")
    mesh = make_mesh(MESH_WORKERS, devices=("cuda:0",) * MESH_WORKERS) \
        if kw.get("mesh") else None
    kw = {k: v for k, v in kw.items() if k not in ("session", "mesh")}
    t0 = time.perf_counter()
    parse_sql(text)
    t1 = time.perf_counter()
    plan = plan_sql(text, **kw)
    t2 = time.perf_counter()
    plan = prepare_plan(plan, sf, session=session, mesh=mesh)
    t3 = time.perf_counter()
    return plan, (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3


def _sql_time_summary(times):
    """{sum, median, slowest} of {name: ms}."""
    slowest = max(times, key=times.get)
    return {"sum_ms": sum(times.values()),
            "median_ms": statistics.median(times.values()),
            "slowest": slowest, "slowest_ms": times[slowest]}


def sql_plans_from_text():
    """Part 1: every corpus entry with SQL text planned and prepared by
    the port, each plan equal to the committed one (the reference's)
    under canonical_plan, doubles within one ulp."""
    from presto_tpu_torch.plan import from_json, to_json
    cases = _sql_plan_cases()
    times = {"parse": {}, "plan": {}, "prepare": {}}
    differ, ulps = {}, {}
    for name, text, sf, kw, committed in cases:
        plan, parse_ms, plan_ms, prepare_ms = _sql_plan_times(text, sf, kw)
        for k, v in (("parse", parse_ms), ("plan", plan_ms),
                     ("prepare", prepare_ms)):
            times[k][name] = v
        near = []
        d = plan_difference(canonical_plan(to_json(plan)), canonical_plan(
            to_json(from_json(committed))), ulps=near)
        if d:
            differ[name] = d
        if near:
            ulps[name] = near
    rep = {"plans": len(cases), "equal": len(cases) - len(differ),
           "one_ulp": ulps,
           **{k: _sql_time_summary(v) for k, v in times.items()}}
    print(f"sql plans: {rep['equal']} of {rep['plans']} equal the "
          f"committed plans; " + json.dumps(rep))
    if differ:
        raise AssertionError(f"{len(differ)} plans from text differ from "
                             f"the committed ones: {differ}")
    return rep


def _sql_statement(name, text, check, sf=SF, repeats=SQL_REPEATS,
                   launches=None, **kw):
    """One statement through presto_tpu_torch.sql on the card: its parse,
    plan and prepare ms, a first run, then `repeats` runs (the first of
    them with every kernel count at 0 and its host syncs counted),
    run_query_ms their median; `check(result)` must hold for every run,
    and with `launches` the counted run must launch fused_limb_sums
    that many times."""
    import torch
    from presto_tpu_torch import sql
    from presto_tpu_torch.ops import kernels as K
    from presto_tpu_torch.sql.statements import (_DEFAULT_PREPARED,
                                                 PreparedStatements,
                                                 preprocess)
    rep = {"statement": name}
    # the text sql() plans (a copy of its prepared statements, so that a
    # PREPARE here registers nothing)
    pre = preprocess(text, catalog=kw.get("catalog") or "tpch",
                     prepared=PreparedStatements(_DEFAULT_PREPARED))
    if pre.text is not None:
        _, rep["parse_ms"], rep["plan_ms"], rep["prepare_ms"] = \
            _sql_plan_times(pre.text, sf, kw)
    t0 = time.perf_counter()
    res = sql(text, sf=sf, **kw)
    torch.cuda.synchronize()
    rep["first_run_query_ms"] = (time.perf_counter() - t0) * 1e3
    # 0 where the ladder's memo already held this plan's fingerprint
    rep["first_capacity_reruns"] = res.stats.get("capacity_reruns")
    check(res)
    times, stats = [], []
    for i in range(repeats):
        if i == 0:
            _reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            res, rep["host_syncs"] = _count_syncs(
                lambda: sql(text, sf=sf, **kw))
            rep["fused_limb_sums"] = K.LAUNCHES["fused_limb_sums"]
        else:
            res = sql(text, sf=sf, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        stats.append(res.stats)
        check(res)
    if times:
        rep["run_query_ms"] = statistics.median(times)
        rep.update(run_split(stats))
    if launches is not None and rep.get("fused_limb_sums") != launches:
        raise AssertionError(f"{name}: {rep.get('fused_limb_sums')} "
                             f"fused_limb_sums launches, not {launches}")
    print(f"sql: {json.dumps(rep)}")
    return rep


def run_split(stats):
    """Medians of run_query's stage, execute and fetch ms and its staged
    MB over QueryResult.stats of several runs (keys a run lacks, as a
    meta statement's, are left out)."""
    out = {}
    for key, name, scale in (("scan_stage_s", "stage_ms", 1e3),
                             ("execute_s", "execute_ms", 1e3),
                             ("fetch_s", "fetch_ms", 1e3),
                             ("staged_bytes", "staged_mb", 1e-6)):
        vals = [st[key] for st in stats if key in st]
        if vals:
            out[name] = statistics.median(vals) * scale
    return out


def sql_rows_from_text(tpcds_rows):
    """Part 2: statements as SQL text through presto_tpu_torch.sql at SF1,
    each checked on the card: q1 and q6 against the numpy oracles (q1
    with one fused_limb_sums launch), q3 and q14 against the committed
    rows of their two-stage entries, TPC-DS q47 against the card's rows
    of its committed plan (`tpcds_rows`), fn_dates and fn_math against
    the reference's SF1 rows, q6 as PREPARE/EXECUTE, SHOW COLUMNS,
    then CREATE TABLE memory.l AS SELECT of q1's lineitem columns, q1
    over it (numpy_q1, one launch) and DROP TABLE."""
    from presto_tpu_torch import sql
    from presto_tpu_torch.connectors import memory
    from presto_tpu_torch.connectors.tpch import TPCH_SCHEMA
    from presto_tpu_torch.queries import (load_corpus, load_functions_corpus,
                                          load_tpcds_corpus)
    corpus, functions = load_corpus(), load_functions_corpus()["timed"]
    q47 = load_tpcds_corpus()["q47"]

    def equal_to(want, exact=True):
        def check(res):
            got = _exact_rows(res) if exact else _plain_rows(res)
            if not (_close_rows(got, want) if exact else got == want):
                raise AssertionError(f"rows differ:\n got  {got[:5]}\n "
                                     f"want {want[:5]}")
        return check

    q1_rows = oracle_rows(numpy_q1, Q1_TABLES, SF)
    q6_rows = oracle_rows(numpy_q6, Q6_TABLES, SF)
    # q1's own max_groups (TPC-H q1's in the corpus): over memory.l the
    # connector proves no distinct count, so the planner's default table
    # of 65,536 groups would stay, off the small-table path
    q1_groups = corpus["q1_two_stage"]["max_groups"]
    out = [
        _sql_statement("q1", SQL_Q1.format(table="lineitem"),
                       equal_to(q1_rows, exact=False), launches=1,
                       max_groups=q1_groups),
        _sql_statement("q6", corpus["q6_two_stage"]["sql"],
                       equal_to(q6_rows, exact=False))]
    for q in ("q3", "q14"):
        e = corpus[f"{q}_two_stage"]
        out.append(_sql_statement(q, e["sql"], equal_to(e["rows"]),
                                  max_groups=e["max_groups"],
                                  join_capacity=e["join_capacity"]))
    out.append(_sql_statement(
        "tpcds_q47", q47["sql"], equal_to(tpcds_rows), sf=q47["timed_sf"],
        catalog="tpcds", max_groups=q47["timed_max_groups"],
        join_capacity=q47["timed_join_capacity"]))
    for name in ("fn_dates", "fn_math"):
        e = functions[name]
        out.append(_sql_statement(name, e["sql"], equal_to(e["rows_sf1"]),
                                  sf=e["sf1"]))

    def ack(word):
        def check(res):
            if res.names != [word] or res.row_count:
                raise AssertionError(f"not the {word} ack: {res.names}")
        return check

    out.append(_sql_statement("prepare_q6", SQL_Q6_PREPARE, ack("PREPARE"),
                              repeats=0))
    out.append(_sql_statement("execute_q6", SQL_Q6_EXECUTE,
                              equal_to(q6_rows, exact=False)))
    sql("DEALLOCATE PREPARE q6", sf=SF)
    schema = [(c, str(t)) for c, t in TPCH_SCHEMA["lineitem"]]

    def columns(res):
        if [(r[0], r[1]) for r in res.rows()] != schema:
            raise AssertionError(f"SHOW COLUMNS: {res.rows()}")
    out.append(_sql_statement("show_columns", "SHOW COLUMNS FROM lineitem",
                              columns))
    memory.reset()
    rows = tpch_rows("lineitem", SF)
    cols = ", ".join(Q1_TABLES["lineitem"])
    out.append(_sql_statement(
        "ctas", f"CREATE TABLE {SQL_TABLE} AS SELECT {cols} FROM lineitem",
        equal_to([[rows]]), repeats=0))
    out.append(_sql_statement("q1_memory", SQL_Q1.format(table=SQL_TABLE),
                              equal_to(q1_rows, exact=False), launches=1,
                              max_groups=q1_groups))
    out.append(_sql_statement("drop", f"DROP TABLE {SQL_TABLE}",
                              equal_to([[True]]), repeats=0))
    if memory.table_names():
        raise AssertionError(f"tables left: {memory.table_names()}")
    return out


def phase_sql(tpcds_rows):
    """The port's own SQL front door on the card: sql_plans_from_text,
    then sql_rows_from_text (`tpcds_rows`: phase_tpcds's card rows of
    TPC-DS q47's committed SF1 plan). Returns the reports and the
    phase's seconds."""
    import torch
    t0 = time.perf_counter()
    out = {"plans": sql_plans_from_text(),
           "statements": sql_rows_from_text(tpcds_rows)}
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(f"sql: the phase took {out['s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the file connectors and the statement tier
# ---------------------------------------------------------------------------

FILES_ROW_GROUP = 1 << 20  # rows a parquet row group
# q1's and q6's lineitem columns, and orderkey for a pruned count
FILES_COLUMNS = ["orderkey", "returnflag", "linestatus", "quantity",
                 "extendedprice", "discount", "tax", "shipdate"]
# a tenth of the orders: at SF1 the first of six row groups
FILES_PRUNED = "SELECT count(*) FROM lineitem WHERE orderkey < {bound}"
FILES_CSV_JOIN = ("SELECT c.mktsegment, count(*) AS orders, "
                  "sum(o.totalprice) AS total FROM {customer} c "
                  "JOIN orders o ON o.custkey = c.custkey "
                  "GROUP BY c.mktsegment ORDER BY c.mktsegment")
FILES_JOIN_CAPACITY = 1 << 21  # >= orders' 1.5M rows at SF1
# the CSV join's group table: localfile proves no distinct count, so
# without it the planner's default of 65,536 groups stays, off the
# small-table path (phase_sql's q1 over memory.l passes its own too)
FILES_JOIN_GROUPS = 16
STATEMENT_ROUNDS = 2  # q1 over the wire and through sql(), in turns


def _pyarrow_missing():
    """Why pyarrow does not import here, or None where it does."""
    try:
        import pyarrow  # noqa: F401
    except ImportError as e:
        return f"{type(e).__name__}: {e}"
    return None


def _files_statement(name, text, want, launches=None, **kw):
    """One statement through sql() at SF1 with the kernel counts at 0
    and fused_limb_sums' calls recorded, in one attempt (its
    capacities fit at the first: max_groups and the join capacity are
    given, so no first run climbs the ladder): rows (plain form) equal
    to `want` (or `want(result)` raising where they differ); with
    `launches`, at least that many fused_limb_sums launches (a pushdown
    scan stages wide lanes, which may take more than one), the first
    call equal to the plain version. Returns its report."""
    import torch
    from presto_tpu_torch import sql
    from presto_tpu_torch.connectors import parquet
    from presto_tpu_torch.ops import kernels as K
    rep = {"statement": name}
    parquet.read_stats.update(groups_total=0, groups_read=0)
    decode_s = parquet.decode_stats["seconds"]
    _reset_launches()
    with recording_fused() as calls:
        t0 = time.perf_counter()
        res = sql(text, sf=SF, **kw)
        torch.cuda.synchronize()
        rep["ms"] = (time.perf_counter() - t0) * 1e3
        rep["fused_limb_sums"] = K.LAUNCHES["fused_limb_sums"]
        if launches is not None:
            if rep["fused_limb_sums"] < launches:
                raise AssertionError(f"files {name}: fused_limb_sums "
                                     f"launched {rep['fused_limb_sums']} "
                                     f"times, not {launches}")
            rep["fused_limb_sums_max_abs_err"] = check_fused(
                *calls[0], f"files {name}'s lanes")
    if res.stats.get("capacity_reruns"):
        raise AssertionError(f"files {name}: {res.stats['capacity_reruns']}"
                             " capacity reruns, not one attempt")
    got = want(res) if callable(want) else _plain_rows(res)
    if not callable(want) and got != want:
        raise AssertionError(f"files {name}: rows differ:\n got  "
                             f"{got[:5]}\n want {want[:5]}")
    rep["row_groups"] = dict(parquet.read_stats)
    rep["decode_ms"] = (parquet.decode_stats["seconds"] - decode_s) * 1e3
    rep.update(run_split([res.stats]))
    print(f"files: {json.dumps(rep)}")
    return rep


def files_csv_join(d):
    """SF1 customer written as CSV, registered in localfile and joined
    with the generator's SF1 orders, grouped by market segment (5
    groups: fused_limb_sums runs): its rows equal the same statement
    over tpch.customer."""
    import csv
    from presto_tpu_torch import sql
    from presto_tpu_torch.connectors import localfile, tpch
    cols = ["custkey", "mktsegment"]
    t0 = time.perf_counter()
    cust = host_columns("customer", SF, cols)
    path = os.path.join(d, "customer.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        w.writerows(zip(cust["custkey"].tolist(),
                        cust["mktsegment"].tolist()))
    write_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    localfile.register_table("customer", path, schema={
        c: tpch.column_type("customer", c) for c in cols})
    register_ms = (time.perf_counter() - t0) * 1e3
    if localfile.table_row_count("customer") != len(cust["custkey"]):
        raise AssertionError("localfile.customer lost rows")
    kw = {"join_capacity": FILES_JOIN_CAPACITY,
          "max_groups": FILES_JOIN_GROUPS}
    want = _exact_rows(sql(FILES_CSV_JOIN.format(customer="tpch.customer"),
                           sf=SF, **kw))
    if len(want) != 5:
        raise AssertionError(f"the CSV join has {len(want)} groups, not 5")

    def same(res):
        got = _exact_rows(res)
        if got != want:
            raise AssertionError(f"files csv_join: rows differ:\n got  "
                                 f"{got}\n want {want}")
        return got
    rep = _files_statement("csv_join",
                           FILES_CSV_JOIN.format(customer="localfile.customer"),
                           same, launches=1, **kw)
    rep.update(csv_write_ms=write_ms, csv_register_ms=register_ms,
               csv_rows=len(cust["custkey"]))
    localfile.reset()
    return rep


def files_lake(d):
    """SF1 lineitem's q1 and q6 columns (and orderkey) written as
    parquet, row groups of FILES_ROW_GROUP rows: q1 and q6 as text over
    parquet.lineitem against numpy_q1 and numpy_q6, a count that prunes
    row groups by orderkey, a CTAS of q1's columns into parquet and q1
    over it, then q6 over an ORC copy."""
    from presto_tpu_torch import sql
    from presto_tpu_torch.connectors import orc, parquet, tpch
    from presto_tpu_torch.queries import load_corpus
    corpus = load_corpus()
    q1_groups = corpus["q1_two_stage"]["max_groups"]
    q6_sql = corpus["q6_two_stage"]["sql"]
    q1_rows = oracle_rows(numpy_q1, Q1_TABLES, SF)
    q6_rows = oracle_rows(numpy_q6, Q6_TABLES, SF)
    types = {c: tpch.column_type("lineitem", c) for c in FILES_COLUMNS}
    cols = host_columns("lineitem", SF, FILES_COLUMNS)
    out = {}
    t0 = time.perf_counter()
    path = os.path.join(d, "lineitem.parquet")
    parquet.write_table(path, cols, types, row_group_size=FILES_ROW_GROUP)
    parquet.register_table("lineitem", path)
    out["parquet_write_ms"] = (time.perf_counter() - t0) * 1e3
    pruned_sql = FILES_PRUNED.format(bound=int(600_000 * SF))
    out["statements"] = [
        _files_statement("q1_parquet", SQL_Q1.format(table="lineitem"),
                         q1_rows, launches=1, catalog="parquet",
                         max_groups=q1_groups),
        _files_statement("q6_parquet", q6_sql, q6_rows, catalog="parquet"),
        _files_statement("pruned_count", pruned_sql,
                         _plain_rows(sql(pruned_sql, sf=SF)),
                         catalog="parquet")]
    pruned = out["statements"][-1]["row_groups"]
    if not pruned["groups_read"] < pruned["groups_total"]:
        raise AssertionError(f"{pruned_sql} pruned no row group: {pruned}")
    parquet.set_warehouse(d)
    q1_cols = ", ".join(Q1_TABLES["lineitem"])
    t0 = time.perf_counter()
    res = sql(f"CREATE TABLE parquet.q1_lineitem AS SELECT {q1_cols} "
              "FROM tpch.lineitem", sf=SF)
    out["ctas_ms"] = (time.perf_counter() - t0) * 1e3
    if _plain_rows(res) != [(tpch_rows("lineitem", SF),)]:
        raise AssertionError(f"CTAS into parquet: {_plain_rows(res)}")
    out["statements"].append(_files_statement(
        "q1_parquet_ctas", SQL_Q1.format(table="parquet.q1_lineitem"),
        q1_rows, launches=1, max_groups=q1_groups))
    sql("DROP TABLE parquet.q1_lineitem", sf=SF)
    t0 = time.perf_counter()
    q6_cols = Q6_TABLES["lineitem"]
    orc_path = os.path.join(d, "lineitem.orc")
    orc.write_table(orc_path, {c: cols[c] for c in q6_cols},
                    {c: types[c] for c in q6_cols})
    orc.register_table("lineitem", orc_path)
    out["orc_write_ms"] = (time.perf_counter() - t0) * 1e3
    out["statements"].append(_files_statement("q6_orc", q6_sql, q6_rows,
                                              catalog="orc"))
    parquet.set_warehouse(None)
    parquet.reset()
    orc.reset()
    return out


def phase_files():
    """The file connectors on the card: files_csv_join always, and
    files_lake where pyarrow imports (else the import error is printed
    and those parts alone are skipped). Returns the reports and the
    phase's seconds."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        out["csv"] = files_csv_join(d)
        missing = _pyarrow_missing()
        if missing is None:
            import pyarrow
            print(f"files: pyarrow {pyarrow.__version__} imports")
            out["pyarrow"] = pyarrow.__version__
            out["lake"] = files_lake(d)
        else:
            print(f"files: parquet and ORC skipped, pyarrow does not "
                  f"import: {missing}")
            out["lake"] = {"skipped": missing}
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(f"files: the phase took {out['s']:.1f} s")
    return out


def _get_json(url):
    import urllib.request
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read())


def _rendered(rows, columns):
    """Engine rows rendered as the statement protocol renders them."""
    from presto_tpu_torch.server.statement import render_value
    from presto_tpu_torch.types import parse_type
    types = [parse_type(c["type"]) for c in columns]
    return [[render_value(v, v is None, t) for v, t in zip(r, types)]
            for r in rows]


def statement_q1(srv):
    """q1 at SF1 over the wire: POST /v1/statement with the full text,
    in one attempt (its 4 groups fit the 16 of q1's max_groups), the
    rendered rows against numpy_q1 rendered, fused_limb_sums launched
    once and one call equal to the plain version; then the wall from
    the POST to the last nextUri against sql() on the same text, in
    turns."""
    import torch
    from presto_tpu_torch import sql
    from presto_tpu_torch.client import execute
    from presto_tpu_torch.ops import kernels as K
    from presto_tpu_torch.queries import load_corpus
    groups = load_corpus()["q1_two_stage"]["max_groups"]
    text = SQL_Q1.format(table="lineitem")
    session = {"sf": str(SF), "max_groups": str(groups)}
    want = oracle_rows(numpy_q1, Q1_TABLES, SF)
    _reset_launches()
    with recording_fused() as calls:
        c = execute(srv.url, text, session=session)
        launches = K.LAUNCHES["fused_limb_sums"]
        if launches != 1:
            raise AssertionError(f"statement q1 launched fused_limb_sums "
                                 f"{launches} times, not once")
        err = check_fused(*calls[0], "statement q1's lanes")
    stats = _get_json(f"{srv.url}/v1/query/{c.query_id}")["runtimeStats"]
    if stats["capacity_reruns"]:  # q1's 4 groups fit its 16 at once
        raise AssertionError(f"statement q1 reran: {stats}")
    if c.data != _rendered(want, c.columns):
        raise AssertionError(f"statement q1: rows differ:\n got  "
                             f"{c.data[:3]}\n want "
                             f"{_rendered(want, c.columns)[:3]}")
    wire, direct = [], []
    for _ in range(STATEMENT_ROUNDS):
        t0 = time.perf_counter()
        execute(srv.url, text, session=session)
        wire.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        res = sql(text, sf=SF, max_groups=groups)
        torch.cuda.synchronize()
        direct.append((time.perf_counter() - t0) * 1e3)
        if _plain_rows(res) != want:
            raise AssertionError("sql() q1 rows differ from numpy_q1")
    rep = {"query_id": c.query_id, "fused_limb_sums": launches,
           "fused_limb_sums_max_abs_err": err, "wire_ms": wire,
           "sql_ms": direct, "wire_median_ms": statistics.median(wire),
           "sql_median_ms": statistics.median(direct)}
    print(f"statement q1: equals numpy_q1, one fused_limb_sums launch "
          f"equal to the plain version; POST to the last nextUri "
          f"{rep['wire_median_ms']:.1f} ms against sql() "
          f"{rep['sql_median_ms']:.1f} ms (medians of {STATEMENT_ROUNDS}, "
          f"in turns)")
    return rep


def statement_queue_full():
    """A resource group of concurrency 1 and queue 1: with one statement
    running and one queued, a third is rejected QUERY_QUEUE_FULL; the
    two admitted ones then finish."""
    import threading
    from presto_tpu_torch import sql
    from presto_tpu_torch.client import QueryError, StatementClient, execute
    from presto_tpu_torch.server.dispatcher import Dispatcher, ResourceGroup
    from presto_tpu_torch.server.statement import StatementServer
    group = ResourceGroup("global", hard_concurrency_limit=1, max_queued=1)
    started, gate = threading.Event(), threading.Event()

    def held(text, session, qid, tid):
        started.set()
        gate.wait(120)
        return sql("SELECT count(*) AS n FROM region", sf=SF)

    with StatementServer(sf=SF, dispatcher=Dispatcher([group]),
                         device="cuda:0") as srv:
        srv._executor = held
        first = StatementClient(srv.url, "SELECT count(*) AS n FROM region")
        if not started.wait(60):
            raise AssertionError("the first statement never ran")
        second = StatementClient(srv.url, "SELECT count(*) AS n FROM region")
        deadline = time.time() + 60
        while group.stats()["queued"] != 1 and time.time() < deadline:
            time.sleep(0.01)
        rejected = None
        try:
            execute(srv.url, "SELECT count(*) AS n FROM nation")
        except QueryError as e:
            rejected = e.error_name
        gate.set()
        done = [first.drain().data, second.drain().data]
    if rejected != "QUERY_QUEUE_FULL" or done != [[[5]], [[5]]]:
        raise AssertionError(f"queue-full: third statement {rejected}, the "
                             f"admitted ones {done}")
    print("statement: a third statement in a group of concurrency 1 and "
          "queue 1 is rejected QUERY_QUEUE_FULL")
    return rejected


LEDGER_ROUTES = ("metrics", "profile", "history", "datapath", "accuracy",
                 "timeline")


def ledger_routes(base, tier, trace_of=None):
    """GET a server's ledger routes (and /v1/cluster on the statement
    tier, /v1/trace/{trace_of} where given): each must answer 200 with
    its document; returns their sizes in bytes and the trace's span
    names. No query runs."""
    import urllib.request
    from presto_tpu_torch.server.metrics import parse_prometheus
    routes = list(LEDGER_ROUTES) + (["cluster"] if tier == "statement"
                                    else [])
    if trace_of is not None:
        routes.append(f"trace/{trace_of}")
    sizes, spans = {}, []
    for route in routes:
        deadline = time.time() + 5
        while True:
            with urllib.request.urlopen(f"{base}/v1/{route}") as r:
                body = r.read()
            # a statement's root span lands a beat after its last
            # document: the trace is read again until it has it
            if not route.startswith("trace/") or time.time() > deadline \
                    or b'"name": "query"' in body:
                break
            time.sleep(0.05)
        sizes[route] = len(body)
        if route == "metrics":
            fams = parse_prometheus(body.decode())
            for fam in ("presto_tpu_stage_seconds_count",
                        "presto_tpu_datapath_bytes_total",
                        "presto_tpu_q_error_count"):
                if fam not in fams:
                    raise AssertionError(f"{tier} /v1/metrics lacks {fam}")
            continue
        doc = json.loads(body)
        if route == "profile" and not doc["kernels"]:
            raise AssertionError(f"{tier} /v1/profile has no kernel row")
        if route == "datapath" and \
                not doc["hops"]["device_put"]["bytes"]:
            raise AssertionError(f"{tier} /v1/datapath has no device_put")
        if route.startswith("trace/"):
            spans = [sp["name"] for sp in doc["spans"]]
            for want in ("query", "stage.staging", "stage.execute",
                         "stage.fetch"):
                if want not in spans:
                    raise AssertionError(f"{tier} trace lacks {want}: "
                                         f"{spans}")
    print(f"{tier}: ledger routes answer ({sizes})"
          + (f"; the trace of {trace_of} has spans {sorted(set(spans))}"
             if trace_of is not None else ""))
    return {"bytes": sizes, "spans": spans}


def observe_q1():
    """q1 at SF1 through run_query with every ledger on: rows against
    numpy_q1, one fused_limb_sums launch equal to the plain version;
    the run's stage walls, datapath hops, timeline occupancy and
    verdict, profiler row and accuracy records, printed."""
    import torch
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.exec.plan_cache import plan_fingerprint
    from presto_tpu_torch.exec.profiler import profile_snapshot
    from presto_tpu_torch.exec.timeline import bubble_verdict, occupancy
    from presto_tpu_torch.ops import kernels as K
    want = oracle_rows(numpy_q1, Q1_TABLES, SF)
    plan = as_built(q1_plan(), SF)
    run_query(plan, sf=SF, prepared=True, query_id="observe.warm")
    _reset_launches()
    with recording_fused() as calls:
        res = run_query(plan, sf=SF, prepared=True, query_id="observe.q1")
        launches = dict(K.LAUNCHES)
        if launches["fused_limb_sums"] != 1:
            raise AssertionError(f"observe q1 launches {launches}")
        err = check_fused(*calls[0], "observe q1's lanes")
    del calls
    if _plain_rows(res) != want:
        raise AssertionError("observe q1 rows differ from numpy_q1")
    qs = res.query_stats
    stages = {k: qs.stage_us(k) / 1e3
              for k in ("staging", "compile", "execute", "fetch")}
    hops = {k: {"bytes": h.bytes, "wall_ms": h.wall_us / 1e3,
                "invocations": h.invocations}
            for k, h in qs.datapath.items()}
    occ = occupancy(qs.timeline.intervals)
    verdict = bubble_verdict(qs.timeline.intervals, occ)
    fp = plan_fingerprint(plan)
    row = next(p for p in profile_snapshot() if p["fingerprint"] == fp)
    accuracy = {k: {"est": r.est, "actual": r.actual}
                for k, r in qs.accuracy.items()}
    skew = qs.counters.get("device_anchor_skew_us")
    on_card = res.query_stats.timeline.totals.get("kernel") is not None \
        and torch.cuda.is_available()
    if qs.datapath["kernel"].invocations != 1 or (on_card and skew is None):
        raise AssertionError(f"observe q1: kernel hop "
                             f"{qs.datapath['kernel']}, anchor skew {skew}")
    print(f"observe q1: equals numpy_q1, one fused_limb_sums launch "
          f"(max abs err {err}); stage ms {stages}; wall "
          f"{qs.wall_us / 1e3:.3f} ms")
    print(f"observe q1 datapath: {json.dumps(hops)}")
    print(f"observe q1 timeline: outside the dispatch spans "
          f"{occ['deviceIdleFraction']:.4f} of {occ['wallUs']} us "
          f"(dispatch span {occ['lanes']['device']['busyUs']} us, event "
          f"anchor within {skew} us); {verdict['message']}")
    print(f"observe q1 profiler row: dispatch spans {row['device_us']} us "
          f"over {row['calls']} calls of this plan in the process, rows "
          f"in {row['rows_in']}, out {row['rows_out']}, bytes in "
          f"{row['bytes_in']}")
    print(f"observe q1 accuracy: {json.dumps(accuracy)}")
    return {"stage_ms": stages, "wall_ms": qs.wall_us / 1e3,
            "datapath": hops, "occupancy": occ, "verdict": verdict,
            "profile": row, "accuracy": accuracy,
            "anchor_skew_us": skew, "launches": launches,
            "fused_limb_sums_max_abs_err": err,
            "staged_bytes": res.stats["staged_bytes"]}


def observe_span():
    """How much of q1's dispatch span is work on the card: one run of
    q1 at SF1 through run_query inside a torch.profiler window. The
    span is the run's `kernel` hop, the stream time between the CUDA
    events around its dispatch. The work is the run's device events
    other than host <-> device copies (kernels, memsets, device copies;
    staging makes few of them, its time is the copies): their count,
    summed time and the union of their intervals. The copies are
    counted and timed apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from presto_tpu_torch.exec import run_query
    plan = as_built(q1_plan(), SF)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = run_query(plan, sf=SF, prepared=True,
                        query_id="observe.span")
        torch.cuda.synchronize()
    span_ms = res.query_stats.datapath["kernel"].wall_us / 1e3
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = {d: [e for e in evs if d in e.name] for d in ("HtoD", "DtoH")}
    work = [e for e in evs if "HtoD" not in e.name and "DtoH" not in e.name]
    sum_ms = sum(e.time_range.elapsed_us() for e in work) / 1e3
    union_us, end = 0, None
    for e in sorted(work, key=lambda e: e.time_range.start):
        t0, t1 = e.time_range.start, e.time_range.end
        if end is None or t0 > end:
            union_us += t1 - t0
            end = t1
        elif t1 > end:
            union_us += t1 - end
            end = t1
    out = {"span_ms": span_ms, "work_sum_ms": sum_ms,
           "work_union_ms": union_us / 1e3, "work_events": len(work),
           "busy_share": union_us / 1e3 / span_ms if span_ms else None,
           **{f"{d}_{k}": v for d, es in copies.items() for k, v in (
               ("copies", len(es)),
               ("ms", sum(e.time_range.elapsed_us() for e in es) / 1e3))}}
    if not work:
        raise AssertionError(f"observe span: the profiler saw no device "
                             f"work ({len(evs)} events)")
    print(f"observe q1 span: dispatch span {span_ms:.3f} ms (CUDA events); "
          f"device work of the same run (torch.profiler, {len(work)} "
          f"events, copies left out) summed {sum_ms:.3f} ms, union "
          f"{union_us / 1e3:.3f} ms ({out['busy_share']:.4f} of the span); "
          f"host to device copies {out['HtoD_copies']} in "
          f"{out['HtoD_ms']:.3f} ms, device to host {out['DtoH_copies']} "
          f"in {out['DtoH_ms']:.3f} ms")
    return out


LEDGER_PAIRS = 3
LEDGERS_OFF = {"continuous_profiling": False, "timeline": False}


def observe_cost():
    """The ledgers' cost on q1 at SF1: run_query with them on (the
    default) against off (LEDGERS_OFF: the two ledgers with a session
    gate, as in the reference; progress, datapath, accuracy and stats
    have none), after a warm run of each, LEDGER_PAIRS pairs in turns,
    each timed to the rows on the host and counting its host syncs and
    kernel launches (torch's sync-debug warnings on, in both modes
    alike). Every run's launches and host syncs must equal those of
    its pair in the other mode; where they do not, the sync sites that
    the two runs do not share are named. Prints where the first on
    run's syncs come from."""
    import collections
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.ops import kernels as K
    plan = as_built(q1_plan(), SF)
    modes = (("on", None), ("off", LEDGERS_OFF))
    out = {"on_ms": [], "off_ms": [], "syncs": {"on": [], "off": []},
           "launches": {"on": [], "off": []}, "sites": {"on": [], "off": []}}
    for _, session in modes:
        run_query(plan, sf=SF, prepared=True, session=session)
    for _ in range(LEDGER_PAIRS):
        for mode, session in modes:
            _reset_launches()
            sites = []
            t0 = time.perf_counter()
            _, syncs = _count_syncs(lambda: run_query(
                plan, sf=SF, prepared=True, session=session), sites)
            out[f"{mode}_ms"].append((time.perf_counter() - t0) * 1e3)
            out["syncs"][mode].append(syncs)
            out["launches"][mode].append(dict(K.LAUNCHES))
            out["sites"][mode].append(sites)
    where = collections.Counter(
        site.split(" | ", 1)[1].split(" < ")[0]
        for site in out["sites"]["on"][0])
    print(f"observe: the first on run's {out['syncs']['on'][0]} host syncs "
          f"by innermost frame: {json.dumps(dict(where))}")
    for i, (on, off) in enumerate(zip(out["sites"]["on"],
                                      out["sites"]["off"])):
        if len(on) != len(off) or out["launches"]["on"][i] != \
                out["launches"]["off"][i]:
            only_on = collections.Counter(on) - collections.Counter(off)
            only_off = collections.Counter(off) - collections.Counter(on)
            raise AssertionError(
                f"the ledgers change q1's warm run, pair {i}: syncs on "
                f"{out['syncs']['on']} off {out['syncs']['off']}, "
                f"launches {out['launches']}; sync sites only on "
                f"{dict(only_on)}, only off {dict(only_off)}")
    out["sites"] = {"on_first": out["sites"]["on"][0]}
    print(f"observe: run_query_ms ledgers on {out['on_ms']} against off "
          f"{out['off_ms']} (in turns); host syncs on "
          f"{out['syncs']['on']}, off {out['syncs']['off']}; launches "
          f"{out['launches']['on'][0]} in each")
    return out


def observe_explain():
    """EXPLAIN ANALYZE of q1 and of q3 from their text at SF1 on the
    card: the executed tree with its host-visible rows, then every
    section."""
    from presto_tpu_torch import sql
    from presto_tpu_torch.queries import load_corpus
    out = {}
    corpus = load_corpus()
    for name, entry in (("q1", corpus["q1_two_stage"]),
                        ("q3", corpus["q3_two_stage"])):
        kw = {"max_groups": entry["max_groups"]}
        if entry.get("join_capacity"):
            kw["join_capacity"] = entry["join_capacity"]
        t0 = time.perf_counter()
        res = sql("EXPLAIN ANALYZE " + entry["sql"], sf=SF, **kw)
        ms = (time.perf_counter() - t0) * 1e3
        lines = [str(v) for v in res.columns[0]]
        for section in ("-- stages --", "-- kernels", "-- datapath --",
                        "-- accuracy --", "-- timeline --"):
            if not any(ln.startswith(section) for ln in lines):
                raise AssertionError(f"EXPLAIN ANALYZE {name} lacks "
                                     f"{section}:\n" + "\n".join(lines))
        if "rows=" not in lines[0]:
            raise AssertionError(f"EXPLAIN ANALYZE {name}: {lines[0]}")
        out[name] = {"ms": ms, "lines": len(lines)}
        print(f"observe: EXPLAIN ANALYZE {name} at SF1, {len(lines)} "
              f"lines in {ms:.1f} ms:\n" + "\n".join(lines))
    return out


def phase_observe():
    """The observability ledgers on the card: observe_q1, observe_span,
    observe_cost and observe_explain. Returns the reports and the
    phase's seconds."""
    import torch
    t0 = time.perf_counter()
    out = {"q1": observe_q1(), "span": observe_span(),
           "cost": observe_cost(), "explain": observe_explain()}
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(f"observe: the phase took {out['s']:.1f} s")
    return out


def phase_batching(seed):
    """Concurrent-query batching on the card at SF1:
    scripts/batching_phase.py::phase_batching over this module's host
    tables and helpers. Returns its report and seconds."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import batching_phase
    return batching_phase.phase_batching(sys.modules[__name__], seed)


def phase_audit():
    """The kernel audit and buffer donation on the card:
    scripts/audit_phase.py::phase_audit over this module's host tables
    and helpers. Returns its report and seconds."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import audit_phase
    return audit_phase.phase_audit(sys.modules[__name__])


def witnessed(fn, *a, **kw):
    """fn(*a, **kw) with the lock-order witness armed (utils/locks.py):
    every OrderedLock acquire of the port's server and exec tiers
    checks the order; any inversion raises after fn returns, and so
    does an ordered pair the witness saw that is not an edge of the
    static graph (presto_tpu_torch/lint/LOCK_ORDER.json, the lint's
    C002 artifact). Returns fn's result."""
    from presto_tpu_torch.lint.lockgraph import DEFAULT_ARTIFACT
    from presto_tpu_torch.utils import locks
    locks.reset_witness()
    locks.arm_witness()
    try:
        out = fn(*a, **kw)
    finally:
        locks.disarm_witness()
    violations = locks.witness_violations()
    t0 = time.perf_counter()
    pairs = sorted((a_, b_) for a_, bs in locks.witness_edges().items()
                   for b_ in bs)
    with open(DEFAULT_ARTIFACT, encoding="utf-8") as f:
        edges = {(e["from"], e["to"]) for e in json.load(f)["edges"]}
    unknown = [p for p in pairs if p not in edges]
    print(f"lock-order witness over {fn.__name__}: {len(violations)} "
          f"violations, {len(pairs)} ordered pairs seen "
          f"{[' -> '.join(p) for p in pairs]}; {len(unknown)} outside "
          f"LOCK_ORDER.json's {len(edges)} edges (checked in "
          f"{time.perf_counter() - t0:.4f} s)")
    if violations:
        raise AssertionError(f"lock-order inversions in {fn.__name__}: "
                             f"{violations}")
    if unknown:
        raise AssertionError(
            f"{fn.__name__}: ordered pairs the witness saw that the static "
            f"lock graph lacks: {[' -> '.join(p) for p in unknown]}")
    return out


def phase_statement():
    """The statement tier on the card: a StatementServer on cuda:0
    (port 0) answering statement_q1, q6 through a DB-API cursor against
    numpy_q6, START TRANSACTION and COMMIT, SHOW CATALOGS (system, and
    parquet and orc where pyarrow imports), system.queries holding the
    q1 query, and statement_queue_full. Returns the reports and the
    phase's seconds."""
    import torch
    from presto_tpu_torch import dbapi
    from presto_tpu_torch.client import execute
    from presto_tpu_torch.queries import load_corpus
    from presto_tpu_torch.server.statement import StatementServer
    from presto_tpu_torch.server.tracing import RecordingTracer, set_tracer
    t0 = time.perf_counter()
    out = {}
    q6_sql = load_corpus()["q6_two_stage"]["sql"]
    set_tracer(RecordingTracer())
    with StatementServer(sf=SF, device="cuda:0") as srv:
        out["q1"] = statement_q1(srv)
        out["routes"] = ledger_routes(srv.url, "statement",
                                      trace_of=out["q1"]["query_id"])
        conn = dbapi.connect(server=srv.url, sf=SF, user="smoke")
        cur = conn.cursor()
        t1 = time.perf_counter()
        cur.execute(q6_sql)
        out["q6_dbapi_ms"] = (time.perf_counter() - t1) * 1e3
        got = [[str(v) for v in r] for r in cur.fetchall()]
        want = _rendered(oracle_rows(numpy_q6, Q6_TABLES, SF),
                         [{"type": d[1]} for d in cur.description])
        if got != want or conn._txn_id is None:
            raise AssertionError(f"DB-API q6: {got} != {want}")
        conn.commit()
        conn.close()
        tid = execute(srv.url, "START TRANSACTION").started_transaction_id
        in_txn = execute(srv.url, "SELECT count(*) FROM region",
                         transaction_id=tid, session={"sf": str(SF)}).data
        commit = execute(srv.url, "COMMIT", transaction_id=tid)
        if not tid or in_txn != [[5]] or not commit.clear_transaction:
            raise AssertionError(f"transaction: {tid} {in_txn} "
                                 f"{commit.update_type}")
        catalogs = [r[0] for r in execute(srv.url, "SHOW CATALOGS").data]
        lake = {"parquet", "orc"} <= set(catalogs)
        if "system" not in catalogs or lake != (_pyarrow_missing() is None):
            raise AssertionError(f"SHOW CATALOGS: {catalogs}")
        queries = execute(srv.url, "SELECT query_id, state FROM "
                          "system.queries").data
        if [out["q1"]["query_id"], "FINISHED"] not in queries:
            raise AssertionError("system.queries does not hold the q1 "
                                 "statement")
        out["catalogs"] = catalogs
    set_tracer(None)
    out["queue_full"] = statement_queue_full()
    torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    print(f"statement: DB-API q6 equals numpy_q6, a transaction commits, "
          f"SHOW CATALOGS {catalogs}, system.queries holds q1; the phase "
          f"took {out['s']:.1f} s")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the report JSON here")
    ap.add_argument("--tpcds-cpu-rows", metavar="DIR",
                    help="a cross-check worker: run the SF1 plans it "
                         "claims in DIR on the CPU, their rows to --out")
    ap.add_argument("--q1-rows", metavar="SF", type=float,
                    help="a worker: numpy_q1's rows at SF to --out")
    ap.add_argument("--cluster-worker", metavar="DISCOVERY_URL",
                    help="a worker of phase_cluster: serve on the card, "
                         "announced to DISCOVERY_URL, until killed")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import presto_tpu_torch  # noqa: F401  (fails outside the checkout)
    from presto_tpu_torch.ops import kernels as K
    if args.tpcds_cpu_rows:
        tpcds_cpu_rows(args.tpcds_cpu_rows, args.out)
        return 0
    if args.q1_rows is not None:
        q1_rows(args.q1_rows, args.out)
        return 0
    if args.cluster_worker:
        serve_cluster_worker(args.cluster_worker)
        return 0

    import tempfile
    cpu_procs = []
    with tempfile.TemporaryDirectory() as tmp:
        def start_cpu_workers():
            tpcds = start_tpcds_cpu_rows(tmp)
            q1 = start_q1_rows(tmp, SF_JOIN)
            cpu_procs.extend([*tpcds, q1])
            return tpcds, q1

        try:
            return run_phases(args, start_cpu_workers)
        finally:
            for proc, _ in cpu_procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def run_phases(args, start_cpu_workers) -> int:
    """The phases in order. `start_cpu_workers()` starts phase_tpcds's
    CPU workers and the worker of exec_streaming's SF10 numpy_q1 rows
    and returns them: after the last kernel timed by its device time, so
    that their load on the host's cores does not reach the kernels'
    timed windows."""
    import torch
    from presto_tpu_torch.ops import kernels as K

    t_start = time.perf_counter()
    install_host_cache()
    phase_s = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            phase_s[name] = time.perf_counter() - t0

    build_s = timed("environment", phase_environment)
    kernel_rows = timed("kernels", phase_kernels, args.seed,
                        Q1_KERNEL_SHAPES)

    timed("fused", phase_fused, args.seed)

    # the shapes and lanes the main path really hands the kernels
    seen, fused_calls = [], []
    per_tile = K.limb_partial_sums

    def recording(ids, limbs, groups):
        if limbs.is_cuda:
            seen.append((limbs.shape[0], groups, limbs.shape[1],
                         str(limbs.dtype)))
        return per_tile(ids, limbs, groups)

    K.limb_partial_sums = recording
    try:
        q1 = timed("q1", phase_query, "q1", q1_plan, numpy_q1, Q1_TABLES,
                   SF, ("narrow", "wide"), fused_calls=fused_calls)
    finally:
        K.limb_partial_sums = per_tile
    print(f"main path per-tile kernel shapes: {sorted(set(seen))}")
    narrow, wide = q1["launches"]["narrow"], q1["launches"]["wide"]
    if (narrow["fused_limb_sums"], narrow["limb_partial_sums"]) != (1, 0):
        raise AssertionError(f"q1 (narrow) must launch fused_limb_sums once "
                             f"and the per-tile kernel never: {narrow}")
    if wide["fused_limb_sums"] != 0 or wide["limb_partial_sums"] < 1:
        raise AssertionError(f"q1 (wide) must take the per-tile kernel: "
                             f"{wide}")
    for row in kernel_rows:
        if row["form"] == "f32x13":
            if Q1_KERNEL_SHAPES["f32x13"] not in [s_[:3] for s_ in seen]:
                raise AssertionError("q1 (wide) did not hand the per-tile "
                                     f"kernel {Q1_KERNEL_SHAPES['f32x13']}")
            row["launches"] = wide["limb_partial_sums"]
        else:  # the int16 entry: off the narrow path since the fusion
            row["launches"] = narrow["limb_partial_sums"]
    kernel_rows.insert(0, fused_row(fused_calls[0],
                                    narrow["fused_limb_sums"]))
    del fused_calls
    torch.cuda.empty_cache()
    q6 = timed("q6", phase_query, "q6", q6_plan, numpy_q6, Q6_TABLES, SF)
    kernel_rows += timed("contains", phase_contains, args.seed)
    q3 = timed("q3", phase_query, "q3", q3_plan, numpy_q3, Q3_TABLES,
               SF_JOIN)
    q14 = timed("q14", phase_query, "q14", q14_plan, numpy_q14,
                Q14_TABLES, SF_JOIN)
    corpus, second_call = timed("corpus", phase_corpus)
    second = next(r for r in corpus if r["query"] == SECOND_G_QUERY)
    kernel_rows.insert(1, fused_row(second_call, second["launches"][
        "narrow"]["fused_limb_sums"], SECOND_G_QUERY))
    del second_call
    torch.cuda.empty_cache()
    cpu_procs, q1_worker = start_cpu_workers()
    two_stage = timed("two_stage", phase_two_stage)
    mesh = timed("mesh", phase_mesh)
    aggregates = timed("aggregates", phase_aggregates)
    functions = timed("functions", phase_functions)
    nested = timed("nested", phase_nested, args.seed)
    tpcds, tpcds_rows = timed(
        "tpcds", phase_tpcds,
        args.out + ".tpcds.jsonl" if args.out else None)
    exec_ = timed("exec", phase_exec, lambda: wait_q1_rows(q1_worker))
    tpcds.update(timed("tpcds_cross_check", tpcds_cross_check, cpu_procs,
                       tpcds_rows))
    sql_ = timed("sql", phase_sql, tpcds_rows["q47"])
    files = timed("files", phase_files)
    statement = timed("statement", phase_statement)
    observe = timed("observe", phase_observe)
    batching = timed("batching", phase_batching, args.seed)
    kernel_rows.insert(2, batched_row(
        batching.pop("dashboard_call"),
        batching["families"]["dashboard"]["B64"]["launches"][
            "fused_limb_sums_batched"]))
    torch.cuda.empty_cache()
    kernel_rows.insert(3, batched_row(
        batching.pop("lineitem_call"),
        batching["families"]["batch"]["B64"]["launches"][
            "fused_limb_sums_batched"], "the lineitem batch of 64",
        plain_repeats=2))
    torch.cuda.empty_cache()
    audit = timed("audit", phase_audit)
    cluster = timed("cluster", witnessed, phase_cluster)
    fleet = timed("fleet", witnessed, phase_fleet)

    gpu = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    report = {"kernels": kernel_rows, "queries": [q1, q6, q3, q14, *corpus],
              "two_stage": two_stage, "mesh": mesh,
              "aggregates": aggregates,
              "functions": functions, "nested": nested, "tpcds": tpcds,
              "exec": exec_, "sql": sql_, "files": files,
              "statement": statement, "observe": observe,
              "batching": batching, "audit": audit, "cluster": cluster,
              "fleet": fleet,
              "build_s": build_s, "phase_s": phase_s,
              "host_generation_s": GEN_S, "gpu": gpu,
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "total_s": time.perf_counter() - t_start}
    print(f"host generation: {GEN_S}")
    print(f"seconds by phase: {json.dumps(phase_s)}; total "
          f"{report['total_s']:.1f} s")
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
