"""Verifier: replay a query corpus across execution configurations and
compare the results.

Counterpart of presto_tpu/verifier.py (`verify_corpus`, `DEFAULT_CORPUS`,
`TPCDS_CORPUS`, `check_plan_determinism`; presto-verifier's replay of a
corpus against a control and a test cluster). The configurations are
those of one engine: "control" (one device), "streaming" (splits of
`split_rows`), "mesh" (the workers of a mesh, parallel/mesh.py) and
"cluster" (the fragments of the statement's distributed plan,
scheduled by server/coordinator.py on the workers of `cluster_urls`).
Rows must match exactly: decimals are scaled integers, so the sorted
row sets compare with plain equality.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

__all__ = ["VerifierResult", "verify_corpus", "DEFAULT_CORPUS",
           "TPCDS_CORPUS", "check_plan_determinism"]


@dataclasses.dataclass
class VerifierResult:
    query: str
    configs: List[str]
    ok: bool
    detail: str = ""


def _canon(res) -> list:
    return sorted(res.rows(), key=lambda r: tuple(str(x) for x in r))


def verify_corpus(corpus: Sequence[str], sf: float = 0.01,
                  mesh=None, split_rows: Optional[int] = None,
                  max_groups: int = 1 << 14,
                  cluster_urls: Optional[Sequence[str]] = None,
                  device=None) -> List[VerifierResult]:
    """Run each statement under every configuration that applies (the
    control on `device`, CUDA unless named) and compare the sorted row
    sets for exact equality. A failed run is recorded, not raised.
    With `cluster_urls` the statement's add_exchanges plan also runs
    through the coordinator on those workers."""
    from .sql import sql

    out: List[VerifierResult] = []
    for text in corpus:
        runs: Dict[str, list] = {}
        errors: Dict[str, str] = {}

        def attempt(name: str, **kwargs):
            try:
                runs[name] = _canon(sql(text, sf=sf, max_groups=max_groups,
                                        **kwargs))
            except Exception as e:  # noqa: BLE001 - the verifier records drift
                errors[name] = f"{type(e).__name__}: {e}"

        attempt("control", device=device)
        if split_rows is not None:
            attempt("streaming", device=device, split_rows=split_rows)
        if mesh is not None:
            attempt("mesh", mesh=mesh)
        if cluster_urls:
            try:
                runs["cluster"] = _canon(_run_on_cluster(
                    text, sf, max_groups, cluster_urls))
            except Exception as e:  # noqa: BLE001 - the verifier records drift
                errors["cluster"] = f"{type(e).__name__}: {e}"
        if errors:
            out.append(VerifierResult(text, list(runs) + list(errors), False,
                                      f"errors: {errors}"))
            continue
        names = list(runs)
        mismatch = [n for n in names[1:] if runs[n] != runs[names[0]]]
        if mismatch:
            out.append(VerifierResult(text, names, False,
                                      f"result drift in {mismatch}"))
        else:
            out.append(VerifierResult(text, names, True))
    return out


def _run_on_cluster(text: str, sf: float, max_groups: int, urls):
    """A statement's add_exchanges plan through the coordinator, its
    rows as a QueryResult."""
    from .exec.runner import QueryResult
    from .plan.distribute import add_exchanges
    from .server import Coordinator
    from .sql import plan_sql
    plan = add_exchanges(plan_sql(text, max_groups=max_groups))
    cols, names = Coordinator(list(urls)).execute(plan, sf=sf)
    return QueryResult([v for v, _ in cols], [n for _, n in cols], names,
                       len(cols[0][0]) if cols else 0)


DEFAULT_CORPUS = [
    "SELECT returnflag, linestatus, sum(quantity), count(*) FROM lineitem "
    "WHERE shipdate <= date '1998-09-02' GROUP BY returnflag, linestatus",
    "SELECT sum(extendedprice * discount) FROM lineitem "
    "WHERE discount BETWEEN 0.05 AND 0.07 AND quantity < 24",
    "SELECT custkey, count(*) FROM orders GROUP BY custkey "
    "HAVING count(*) >= 25",
    "SELECT shipmode, min(quantity), max(quantity) FROM lineitem "
    "WHERE shipmode IN ('AIR', 'MAIL') GROUP BY shipmode",
    "SELECT count(*) FROM lineitem WHERE orderkey IN "
    "(SELECT orderkey FROM orders WHERE totalprice > 300000.00)",
    # set operations (NULL=NULL membership, precedence)
    "SELECT regionkey FROM nation INTERSECT "
    "SELECT regionkey FROM region WHERE regionkey >= 2",
    "SELECT nationkey FROM nation WHERE nationkey < 5 UNION "
    "SELECT regionkey FROM region",
    # join + aggregation
    "SELECT n.name, count(*) FROM supplier s "
    "JOIN nation n ON s.nationkey = n.nationkey GROUP BY n.name",
    # distinct aggregates (non-mergeable partials: raw-row repartition)
    "SELECT custkey, count(DISTINCT orderpriority) FROM orders "
    "GROUP BY custkey HAVING count(*) > 20",
    # HLL sketch states (mergeable registers across the mesh)
    "SELECT returnflag, approx_distinct(partkey) FROM lineitem "
    "GROUP BY returnflag",
    # scalar subquery
    "SELECT count(*) FROM customer WHERE acctbal > "
    "(SELECT avg(acctbal) FROM customer)",
    # grouping sets
    "SELECT returnflag, linestatus, sum(quantity) AS q FROM lineitem "
    "GROUP BY ROLLUP(returnflag, linestatus) ORDER BY q DESC",
    # window functions
    "SELECT orderkey, linenumber, "
    "lag(quantity) OVER (PARTITION BY orderkey ORDER BY linenumber) AS p "
    "FROM lineitem WHERE orderkey <= 30",
    # correlated EXISTS
    "SELECT count(*) FROM orders o WHERE EXISTS "
    "(SELECT l.orderkey FROM lineitem l WHERE l.orderkey = o.orderkey "
    " AND l.quantity > 49.00)",
    # long-decimal (int128 lane) sums + avg finalization across the
    # PARTIAL -> exchange -> FINAL path
    "SELECT returnflag, sum(extendedprice) AS s, avg(extendedprice) AS a "
    "FROM lineitem GROUP BY returnflag ORDER BY returnflag",
    # MERGE exchange: root-observable global order, no gather
    "SELECT orderkey, totalprice FROM orders "
    "WHERE totalprice > 400000.00 ORDER BY totalprice DESC, orderkey",
    # RANGE value frames over the mesh repartition
    "SELECT orderkey, quantity, sum(quantity) OVER (PARTITION BY orderkey "
    "ORDER BY quantity RANGE BETWEEN 5 PRECEDING AND CURRENT ROW) "
    "FROM lineitem WHERE orderkey <= 20",
    # array lambdas capture grouped columns
    "SELECT regionkey, sum(reduce(sequence(1, 4), 0, (s, x) -> s + x * "
    "regionkey, s -> s)) FROM nation GROUP BY regionkey",
    # interval arithmetic + date filters (a 180-day
    # window lands INSIDE the data range -- ~360 rows at sf 0.01 -- so
    # wrong interval math is observable, not a trivially-empty result)
    "SELECT count(*) FROM orders WHERE orderdate >= "
    "date '1998-12-01' - interval '180' day",
    # RIGHT/FULL OUTER: unmatched-build emission under partitioned
    # distribution
    "SELECT r.name, count(n.nationkey) FROM nation n "
    "RIGHT JOIN region r ON n.regionkey = r.regionkey GROUP BY r.name",
    "SELECT count(*), count(o.orderkey), count(c.custkey) FROM orders o "
    "FULL OUTER JOIN customer c ON o.custkey = c.custkey",
    # large-cardinality group-by (sorted-mode kernel): ~15k groups at
    # sf=0.01 -- kernel output must be OBSERVABLE (a filter that empties
    # the result would compare empty==empty and hide drift)
    "SELECT orderkey, count(*), sum(quantity) FROM lineitem "
    "GROUP BY orderkey HAVING sum(quantity) >= 90.00",
]

# TPC-DS shapes resolved against the tpcds catalog (star join + dim
# filters -- the q3 family the CBO/dynamic-filter work targets)
TPCDS_CORPUS = [
    "SELECT dt.d_year, item.i_brand_id, sum(ss_sales_price) AS s "
    "FROM date_dim dt, store_sales, item "
    "WHERE dt.d_date_sk = store_sales.ss_sold_date_sk "
    "  AND store_sales.ss_item_sk = item.i_item_sk "
    "  AND item.i_manufact_id = 128 AND dt.d_moy = 11 "
    "GROUP BY dt.d_year, item.i_brand_id "
    "ORDER BY dt.d_year, s DESC, item.i_brand_id",
]


def check_plan_determinism(corpus: Sequence[str], repeats: int = 3
                           ) -> List[str]:
    """PlanDeterminismChecker analog: plan each statement `repeats`
    times and compare the plans' fingerprints (node ids left out).
    Returns the statements whose plans drifted; an empty list passes."""
    from .exec.runner import _fingerprint
    from .sql import plan_sql

    return [q for q in corpus
            if len({_fingerprint(plan_sql(q)) for _ in range(repeats)}) != 1]
