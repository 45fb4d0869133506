"""Write presto_tpu_torch/queries/functions.json from the reference.

    python scripts/make_functions_corpus.py [--out PATH] [--no-sf1]

The file holds three groups of SQL statements, each planned by
presto_tpu's `plan_sql` and prepared with `prepare_plan`:

* "statements": every statement of the reference's function tests that
  takes no array, map, row or lambda and whose answer does not depend
  on the clock (current_timestamp, current_date, now() and
  localtimestamp are left out): the `sql(...)`/`one(...)` statements of
  tests/test_function_breadth.py and tests/test_regex_datefmt.py (one(q)
  is `SELECT q FROM region LIMIT 1`), the window statements of
  tests/test_sql_window.py and the SQL statements of
  tests/test_scalar_breadth.py. Each has the reference's plan and rows
  at sf 0.01.
* "later": the statements of those files that take arrays, maps, rows
  or lambdas, with the reference's plan and rows at sf 0.01 (arrays,
  maps and rows in the nested exact form of presto_tpu_torch.queries).
* "timed": the statements of TIMED, the function library over TPC-H
  columns at SF1, each with the reference's plan and rows at sf 0.01
  and its plan and rows at SF1, computed by the reference on the CPU.
  Each aggregates its function outputs, so the rows stay small, and
  none groups by a transcendental double.

Rows are in the exact form of presto_tpu_torch.queries (scaled
integers, days, text, float.hex, null). The SF1 rows take about 25
minutes of CPU (the reference's per-row host kernels of fn_host over
SF1 part about 23 of them); --no-sf1 keeps the SF1 entries of an
existing file, computing only those it lacks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

SF_SMALL, SF1 = 0.01, 1.0


def one(expr: str) -> str:
    """tests/test_function_breadth.py's `one(q)`."""
    return f"SELECT {expr} FROM region LIMIT 1"


_TS = "timestamp '2020-03-01 12:30:45'"
_DOC = '{"a": {"b": [1, 42, 7]}, "s": "x"}'

# name -> SQL of the flat statements (tests/test_function_breadth.py,
# test_regex_datefmt.py, test_sql_window.py, test_scalar_breadth.py)
STATEMENTS = {
    # zoned timestamps
    "ts_literal_micros": one(f"cast({_TS} as bigint)"),
    "ts_hour": one(f"hour({_TS})"),
    "ts_minute": one(f"minute({_TS})"),
    "ts_second": one(f"second({_TS})"),
    "tz_hour_at_zone": one(f"hour({_TS} AT TIME ZONE '+05:30')"),
    "tz_minute_at_zone": one(f"minute({_TS} AT TIME ZONE '+05:30')"),
    "tz_timezone_hour": one(f"timezone_hour({_TS} AT TIME ZONE '-08:00')"),
    "tz_same_instant": one(f"{_TS} AT TIME ZONE '+05:30' = "
                           f"{_TS} AT TIME ZONE 'UTC'"),
    "tz_equal_across_zones": one(
        "timestamp '2020-01-01 13:00:00 +01:00' = "
        "timestamp '2020-01-01 12:00:00 UTC'"),
    "tz_less_across_zones": one(
        "timestamp '2020-01-01 13:00:00 +01:00' < "
        "timestamp '2020-01-01 12:00:01 UTC'"),
    "tz_cast_to_local": one(
        "cast(cast(timestamp '2020-01-01 12:00:00' AT TIME ZONE '+02:00' "
        "as timestamp) as bigint)"),
    # intervals
    "iv_day_second_add": one(
        "cast(cast(date '2020-01-01' as timestamp) + interval '36' hour "
        "as bigint)"),
    "iv_minute_subtract": one(
        "cast(timestamp '2020-01-01 00:00:00' - interval '90' minute "
        "as bigint)"),
    "iv_whole_days_keep_date": one(
        "date '1998-12-01' - interval '90' day = date '1998-09-02'"),
    "iv_month_end_clamp": one(
        "cast(timestamp '2020-01-31 10:00:00' + interval '1' month "
        "as bigint)"),
    "iv_date_month": one(
        "date '2020-03-31' + interval '1' month = date '2020-04-30'"),
    "iv_timestamp_difference": one(
        "cast(timestamp '2020-01-02 00:00:00' - "
        "timestamp '2020-01-01 12:00:00' as bigint)"),
    "time_literal": one("cast(time '12:34:56' as bigint)"),
    # JSON
    "json_scalar_index": one(f"json_extract_scalar('{_DOC}', '$.a.b[1]')"),
    "json_extract_array": one(f"json_extract('{_DOC}', '$.a.b')"),
    "json_scalar_string": one(f"json_extract_scalar('{_DOC}', '$.s')"),
    "json_scalar_missing": one(f"json_extract_scalar('{_DOC}', "
                               "'$.missing')"),
    "json_size_object": one(f"json_size('{_DOC}', '$.a')"),
    "json_size_array": one(f"json_size('{_DOC}', '$.a.b')"),
    "json_array_length": one("json_array_length(json_parse('[1, 2, 3]'))"),
    "json_contains_number": one("json_array_contains('[1, 2, 3]', 2)"),
    "json_contains_absent": one("json_array_contains('[1, 2, 3]', 9)"),
    "json_contains_string": one(
        "json_array_contains('[\"a\", \"b\"]', 'b')"),
    "json_is_scalar": one("is_json_scalar('42')"),
    "json_is_not_scalar": one("is_json_scalar('[1]')"),
    "json_malformed_is_null": one("json_array_length('{nope')"),
    "json_parse_longer": one("json_parse('[1e2,1e2,1e2,1e2,1e2]')"),
    "json_contains_bool_vs_number": one("json_array_contains('[1, 2]', "
                                        "true)"),
    "json_contains_bool": one("json_array_contains('[true]', true)"),
    "json_contains_number_vs_bool": one("json_array_contains('[true]', 1)"),
    # regex capture
    "rx_extract": one(r"regexp_extract('presto-tpu-42', '(\d+)')"),
    "rx_extract_group": one(r"regexp_extract('a1b22', '([a-z])(\d+)', 2)"),
    "rx_extract_none": one(r"regexp_extract('abc', '(\d+)')"),
    "rx_replace": one(r"regexp_replace('a1b22c', '\d+', 'X')"),
    "rx_replace_group": one(r"regexp_replace('x=1,y=2', '(\w)=(\d)', "
                            "'$2')"),
    "rx_position": one("regexp_position('hello world', 'wor')"),
    "rx_count": one(r"regexp_count('a1b22c333', '\d+')"),
    # varbinary
    "vb_to_hex": one("to_hex(to_utf8('AB'))"),
    "vb_from_hex": one("from_utf8(from_hex('4142'))"),
    "vb_length": one("length(to_utf8('abc'))"),
    "vb_md5": one("to_hex(md5(to_utf8('abc')))"),
    "vb_sha256": one("to_hex(sha256(to_utf8('abc')))"),
    "vb_crc32": one("crc32(to_utf8('abc'))"),
    "vb_from_hex_odd": one("from_hex('abc')"),
    "vb_from_hex_invalid": one("from_hex('zz')"),
    # FROM-less SELECT: VALUES
    "values_select": "SELECT 2 AS x LIMIT 1",
    "values_union": "SELECT 1 AS x UNION ALL SELECT 2",
    # tests/test_regex_datefmt.py
    "regexp_like_clerk": "SELECT count(*) FROM orders "
                         r"WHERE regexp_like(clerk, 'Clerk#0+1\d')",
    "date_format_orders": "SELECT orderkey, date_format(orderdate, "
                          "'%Y-%m-%d') d FROM orders ORDER BY orderkey "
                          "LIMIT 5",
    # tests/test_sql_window.py
    "window_row_number": "SELECT custkey, orderkey, totalprice, "
                         "row_number() OVER (PARTITION BY custkey ORDER BY "
                         "totalprice DESC) AS rn FROM orders "
                         "WHERE custkey <= 50",
    "window_running_sum_rank": "SELECT orderkey, linenumber, sum(quantity) "
                               "OVER (PARTITION BY orderkey ORDER BY "
                               "linenumber) AS running, rank() OVER "
                               "(PARTITION BY orderkey ORDER BY linenumber) "
                               "AS rk FROM lineitem WHERE orderkey <= 40",
    "window_lag_lead": "SELECT orderkey, linenumber, lag(quantity) OVER "
                       "(PARTITION BY orderkey ORDER BY linenumber) AS prev, "
                       "lead(quantity, 2) OVER (PARTITION BY orderkey ORDER "
                       "BY linenumber) AS nxt2 FROM lineitem "
                       "WHERE orderkey <= 20",
    "window_json_roundtrip": "SELECT custkey, row_number() OVER (PARTITION "
                             "BY custkey ORDER BY totalprice) AS rn "
                             "FROM orders",
    # tests/test_scalar_breadth.py
    "scalar_math": "SELECT sin(1.0) AS s, log2(8.0) AS l, cbrt(27.0) AS c, "
                   "degrees(3.141592653589793) AS d, atan2(1.0, 1.0) AS a, "
                   "log(3.0, 81.0) AS lg, is_nan(0.0) AS nn "
                   "FROM region LIMIT 1",
    "scalar_bitwise": "SELECT bitwise_and(regionkey, 1) AS a, "
                      "bitwise_or(regionkey, 8) AS o, "
                      "bitwise_left_shift(regionkey, 2) AS sh, "
                      "bit_count(regionkey) AS bc "
                      "FROM region ORDER BY regionkey",
    "scalar_ends_with": "SELECT count(*) AS n FROM region "
                        "WHERE ends_with(name, 'ICA')",
    "scalar_unixtime": "SELECT to_unixtime(from_unixtime(1500000000)) AS u "
                       "FROM region LIMIT 1",
    "scalar_shift_mod_64": "SELECT bitwise_left_shift(regionkey + 1, 64) "
                           "AS a, bitwise_left_shift(regionkey + 1, 65) AS b "
                           "FROM region ORDER BY regionkey LIMIT 1",
}

# name -> SQL of the statements over arrays, maps, rows and lambdas
LATER = {
    "lambda_transform": one("transform(sequence(1, 4), x -> x * 10)"),
    "lambda_filter": one("filter(sequence(1, 6), x -> x % 2 = 0)"),
    "lambda_reduce_sum": one("reduce(sequence(1, 5), 0, (s, x) -> s + x, "
                             "s -> s)"),
    "lambda_reduce_product": one("reduce(sequence(1, 5), 1, (s, x) -> "
                                 "s * x, s -> s)"),
    "lambda_any_match": one("any_match(sequence(1, 5), x -> x > 4)"),
    "lambda_any_match_none": one("any_match(sequence(1, 5), x -> x > 5)"),
    "lambda_all_match": one("all_match(sequence(1, 5), x -> x > 0)"),
    "lambda_none_match": one("none_match(sequence(1, 5), x -> x > 9)"),
    "lambda_captures": "SELECT regionkey, transform(sequence(1, 3), "
                       "x -> x + regionkey) t, filter(sequence(1, 4), "
                       "x -> x <= regionkey) f FROM region ORDER BY "
                       "regionkey",
    "lambda_in_aggregation": "SELECT sum(reduce(sequence(1, 3), 0, "
                             "(s, x) -> s + x * regionkey, s -> s)) "
                             "FROM region",
    "array_constructor": one("ARRAY[3, 1, 2]"),
    "array_subscript": one("ARRAY[3, 1, 2][2]"),
    "array_sort": one("array_sort(ARRAY[3, 1, 2])"),
    "array_distinct": one("array_distinct(ARRAY[3, 1, 3, 2, 1])"),
    "array_slice": one("slice(ARRAY[1, 2, 3, 4], 2, 2)"),
    "array_slice_negative": one("slice(ARRAY[1, 2, 3, 4], -2, 2)"),
    "array_cardinality_filter": one("cardinality(filter(ARRAY[1, 2, 3], "
                                    "x -> x > 1))"),
    "array_slice_start_zero": one("slice(ARRAY[1, 2, 3], 0, 2)"),
    "array_slice_beyond": one("slice(ARRAY[1, 2, 3], -5, 5)"),
    "array_cardinality_slice": one("cardinality(slice(ARRAY[1, 2, 3], "
                                   "-5, 5))"),
}

# The timed statements: the function library over TPC-H columns (the
# engine's column names, without TPC-H's prefixes), lifted from the
# reference's function tests and the function reference of Presto's
# documentation (presto-docs/src/main/sphinx/functions/: math, date,
# string, regexp, json, binary). Forms the reference's plan_sql refuses
# were rewritten: decimal arithmetic yields decimal(38) lanes, which
# the reference's sign/ceil/truncate cannot read, so those take plain
# columns; there is no cast of a number to varchar, so the JSON text is
# built from varchar columns; there is no TABLESAMPLE, so fn_sample is a
# SampleNode put over the scan (SAMPLES). fn_arrays reaches every
# nested name the reference's SQL plans (it has no type rule for
# array_max, array_min, row_pack, row_field, map_keys, map_values or
# element_at of a map); fn_unnest is its SQL's plan under a hand-built
# UNNEST WITH ORDINALITY and aggregation (UNNESTS): plan_sql has no
# UNNEST.
TIMED = {
    "fn_dates": "SELECT year(shipdate) y, quarter(shipdate) q, "
                "day_of_week(shipdate) dw, "
                "sum(date_diff('day', shipdate, receiptdate)) dd, "
                "max(date_format(shipdate, '%Y-%m-%d')) mf, "
                "min(last_day_of_month(commitdate)) ld, count(*) c "
                "FROM lineitem GROUP BY year(shipdate), quarter(shipdate), "
                "day_of_week(shipdate) ORDER BY y, q, dw",
    "fn_date_trunc": "SELECT date_trunc('month', orderdate) m, "
                     "sum(totalprice) s, count(*) c FROM orders "
                     "WHERE date_add('day', 45, orderdate) >= "
                     "date '1994-01-01' AND orderdate + interval '1' month "
                     "< date '1996-01-01' "
                     "GROUP BY date_trunc('month', orderdate) ORDER BY m",
    "fn_timestamps": "SELECT orderpriority, count(*) c, "
                     "sum(hour(cast(orderdate as timestamp) + "
                     "interval '13' hour)) h, "
                     "sum(minute(from_unixtime(to_unixtime(cast(orderdate "
                     "as timestamp)) + custkey))) mi, "
                     "sum(to_unixtime(cast(orderdate as timestamp) + "
                     "interval '90' minute)) ux, "
                     "min(timezone_hour(cast(orderdate as timestamp) "
                     "AT TIME ZONE 'America/New_York')) tzh, "
                     "sum(hour(at_timezone(cast(orderdate as timestamp) + "
                     "interval '3' hour, 'America/New_York'))) hny "
                     "FROM orders GROUP BY orderpriority "
                     "ORDER BY orderpriority",
    "fn_math": "SELECT returnflag, sum(round(extendedprice, 1)) r1, "
               "sum(floor(extendedprice)) fl, sum(ceil(extendedprice)) ce, "
               "sum(truncate(extendedprice)) tr, "
               "sum(sign(linenumber - 4)) sg, sum(sqrt(quantity)) sq, "
               "sum(ln(extendedprice)) lnx, sum(power(discount, 2)) pw, "
               "sum(round(sqrt(quantity), 2)) rd, "
               "max(greatest(quantity, linenumber * 10)) gr, "
               "min(least(quantity, linenumber)) le, "
               "sum(orderkey % 7) m7, sum(bitwise_and(orderkey, 255)) ba, "
               "sum(bitwise_right_shift(partkey, 3)) rs, "
               "cast(sum(quantity) as decimal(12, 2)) sqd, count(*) c "
               "FROM lineitem GROUP BY returnflag ORDER BY returnflag",
    "fn_strings": "SELECT linestatus, sum(length(comment)) ln, "
                  "sum(strpos(comment, 'the')) sp, "
                  "sum(if(starts_with(comment, 'the'), 1, 0)) sw, "
                  "sum(if(ends_with(comment, 'ly'), 1, 0)) ew, "
                  "max(upper(trim(shipinstruct))) ui, "
                  "min(lower(reverse(shipmode))) lr, "
                  "sum(codepoint(substr(comment, 2, 1))) cp, count(*) c "
                  "FROM lineitem GROUP BY linestatus ORDER BY linestatus",
    "fn_regexp_like": "SELECT count(*) c FROM lineitem WHERE "
                      "regexp_like(comment, "
                      "'(fur|blith)ely [a-z]{2,6} (dep|req|pac)')",
    "fn_split_part": "SELECT split_part(phone, '-', 1) cc, count(*) c "
                     "FROM customer GROUP BY split_part(phone, '-', 1) "
                     "ORDER BY cc",
    "fn_host": "SELECT count(*) c, "
               "count(DISTINCT to_hex(md5(to_utf8(name)))) dh, "
               "sum(crc32(to_utf8(type))) cr, "
               "max(regexp_extract(name, '[a-z]+ [a-z]+')) rx, "
               "min(regexp_replace(type, '(\\w+) (\\w+)', '$2')) rr, "
               "max(json_extract_scalar(concat('{\"b\": \"', brand, "
               "'\", \"t\": \"', container, '\"}'), '$.t')) js "
               "FROM part",
    "fn_sample": "SELECT count(*) c, sum(quantity) q FROM lineitem",
    "fn_arrays": "SELECT returnflag, "
                 "sum(cardinality(filter(transform(sequence(1, 8), "
                 "x -> x * linenumber), y -> y > 20))) fc, "
                 "sum(reduce(sequence(1, 4), 0, (s, x) -> s + x * "
                 "linenumber, s -> s)) rd, "
                 "sum(array_sum(slice(ARRAY[linenumber, suppkey % 100, "
                 "partkey % 100], 2, 2))) sl, "
                 "sum(array_position(array_sort(ARRAY[suppkey % 5, "
                 "linenumber, 3]), 3)) ap, "
                 "sum(if(any_match(sequence(1, 8), x -> x * linenumber > "
                 "30), 1, 0)) am, "
                 "sum(if(all_match(sequence(1, 2), x -> x < linenumber), "
                 "1, 0)) al, "
                 "sum(if(none_match(sequence(2, 3), x -> x = linenumber), "
                 "1, 0)) nm, "
                 "sum(element_at(ARRAY[partkey, suppkey], -1)) ea, "
                 "sum(if(contains(ARRAY[1, 3, 5], linenumber), 1, 0)) ct, "
                 "sum(ARRAY[orderkey, partkey][2]) sb, "
                 "sum(cardinality(array_distinct(ARRAY[suppkey % 3, "
                 "linenumber % 3, 1]))) ad, count(*) c "
                 "FROM lineitem GROUP BY returnflag ORDER BY returnflag",
    "fn_unnest": "SELECT orderkey, transform(sequence(1, 4), "
                 "x -> x * linenumber) a FROM lineitem",
}
# timed statements that run over a SampleNode: name -> BERNOULLI ratio.
# The reference samples by a hash of the row slot; both packages stage
# the whole table in one batch in generator order, so the slots, and
# the rows kept, are the same.
SAMPLES = {"fn_sample": 0.1}
# timed statements whose array column (channel) is unnested WITH
# ORDINALITY, then aggregated by the ordinality: sum of the elements
# and count(*), ordered by the ordinality
UNNESTS = {"fn_unnest": 1}


def _with_sample(plan, ratio: float):
    """The prepared plan with a SampleNode over its one table scan."""
    from presto_tpu.plan import nodes as RN

    def walk(n):
        if isinstance(n, RN.TableScanNode):
            return RN.SampleNode(n, ratio)
        changes = {}
        for f in dataclasses.fields(n):
            v = getattr(n, f.name)
            if isinstance(v, RN.PlanNode):
                changes[f.name] = walk(v)
        return dataclasses.replace(n, **changes) if changes else n
    return walk(plan)


def _with_unnest(plan, channel: int):
    """The prepared plan's rows (below its OutputNode) unnested at
    `channel` WITH ORDINALITY, then grouped by the ordinality: its
    sum of the elements and count(*), in ordinality order."""
    from presto_tpu import types as RT
    from presto_tpu.ops.aggregation import AggSpec
    from presto_tpu.plan import nodes as RN
    src = plan.source
    width = len(src.output_types())
    u = RN.UnnestNode(src, channel, with_ordinality=True)
    agg = RN.AggregationNode(u, [width], [
        AggSpec("sum", width - 1, RT.BIGINT),
        AggSpec("count_star", None, RT.BIGINT)], max_groups=16)
    return RN.OutputNode(RN.SortNode(agg, [(0, False, False)]),
                         ["ordinality", "s", "c"])


def prepared(name: str, sql: str, sf: float):
    """The reference's prepared plan of a statement at `sf`."""
    from presto_tpu.exec.runner import prepare_plan
    from presto_tpu.sql import plan_sql
    plan = prepare_plan(plan_sql(sql), sf=sf)
    if name in SAMPLES:
        plan = _with_sample(plan, SAMPLES[name])
    if name in UNNESTS:
        plan = _with_unnest(plan, UNNESTS[name])
    return plan


def reference_rows(plan, sf: float):
    """(names, types, exact rows) of the reference's run of a prepared
    plan."""
    from presto_tpu.exec import run_query
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.queries import exact_rows
    res = run_query(plan, sf=sf, prepared=True)
    types = [PT.parse_type(str(t)) for t in res.types]
    return (list(res.names), [str(t) for t in types],
            exact_rows(res.columns, res.nulls, types, res.row_count))


def entry(name: str, sql: str, sf: float) -> dict:
    from presto_tpu.plan import nodes as RN
    plan = prepared(name, sql, sf)
    names, types, rows = reference_rows(plan, sf)
    return {"sql": sql, "sf": sf, "plan": RN.to_json(plan), "names": names,
            "types": types, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        REPO, "presto_tpu_torch", "queries", "functions.json"))
    ap.add_argument("--no-sf1", action="store_true",
                    help="keep the SF1 plans and rows of --out")
    args = ap.parse_args(argv)
    import presto_tpu  # noqa: F401  (jax x64 first)
    from presto_tpu.plan import nodes as RN

    old = {}
    if args.no_sf1:
        with open(args.out) as f:
            old = json.load(f)["timed"]
    out = {"statements": {}, "later": {}, "timed": {}}
    for name, sql in STATEMENTS.items():
        out["statements"][name] = entry(name, sql, SF_SMALL)
    for name, sql in LATER.items():
        out["later"][name] = entry(name, sql, SF_SMALL)
    for name, sql in TIMED.items():
        e = entry(name, sql, SF_SMALL)
        if args.no_sf1 and name in old:
            big = {k: old[name][k] for k in ("plan_sf1", "rows_sf1")}
        else:
            t0 = time.perf_counter()
            b = entry(name, sql, SF1)
            big = {"plan_sf1": b["plan"], "rows_sf1": b["rows"]}
            print(f"{name}: {len(b['rows'])} rows at SF1 in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        out["timed"][name] = {**e, "sf1": SF1, **big,
                              "sample": SAMPLES.get(name)}
    data = {"source": "tests/test_function_breadth.py, "
                      "tests/test_regex_datefmt.py, tests/test_sql_window.py, "
                      "tests/test_scalar_breadth.py and "
                      "scripts/make_functions_corpus.py::TIMED, planned "
                      "(plan_sql, prepare_plan) and run (run_query) by "
                      "presto_tpu on the CPU",
            **out}
    with open(args.out, "w") as f:
        json.dump(data, f, separators=(",", ":"), sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
