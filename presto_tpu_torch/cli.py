"""Command-line SQL client over the port, the counterpart of
presto_tpu/cli.py: the statement runs in this process through
`presto_tpu_torch.sql`, on CUDA unless `--device` names another, or,
with `--server URL`, on a statement server over the client protocol
(client.py; the port's server/statement.py or the reference's).

  python -m presto_tpu_torch.cli "SELECT ... FROM lineitem ..." [--sf 0.1]
        [--device cpu] [--catalog tpcds]
  python -m presto_tpu_torch.cli --server http://127.0.0.1:8080 \
        [--user alice] "SELECT ..."
  python -m presto_tpu_torch.cli              # REPL

`EXPLAIN [ANALYZE] ...` (or `--explain`) prints the plan (plan/
explain.py); `--stats` prints the QueryStats summary; `--trace` renders
the query's trace as a waterfall (traceview.py): the in-process
tracer's, or the server's GET /v1/trace/{queryId}, under a trace
context the client sends.
"""

from __future__ import annotations

import argparse
import re
import sys
import time

_EXPLAIN_RE = re.compile(r"\s*explain(\s+analyze)?\b", re.IGNORECASE)


def _render(v, ty):
    if v is None:
        return "NULL"
    if ty is not None and ty.is_decimal and ty.scale > 0:
        s = ty.scale
        sign = "-" if v < 0 else ""
        a = abs(int(v))
        return f"{sign}{a // 10**s}.{a % 10**s:0{s}d}"
    if ty is not None and ty.base == "date":
        import numpy as np
        return str(np.datetime64("1970-01-01") + int(v))
    return str(v)


def _format_table(names, rows, types=None, max_rows=50):
    types = types or [None] * len(names)
    rendered = [[_render(r[i], types[i]) for i in range(len(names))]
                for r in rows[:max_rows]]
    widths = [max([len(str(n))] + [len(rr[i]) for rr in rendered])
              for i, n in enumerate(names)]

    def line(vals):
        return " | ".join(v.ljust(w) for v, w in zip(vals, widths))

    out = [line([str(n) for n in names]),
           "-+-".join("-" * w for w in widths)]
    for rr in rendered:
        out.append(line(rr))
    if len(rows) > max_rows:
        out.append(f"... ({len(rows) - max_rows} more rows)")
    return "\n".join(out)


def _print_trace(doc) -> None:
    from .traceview import render_waterfall
    print(render_waterfall(doc))


def run_one(query: str, sf: float, device=None, catalog=None,
            explain_only: bool = False, stats: bool = False,
            trace: bool = False) -> int:
    """Run one statement and print its rows as a table (its plan for
    EXPLAIN or `explain_only`)."""
    import uuid

    from .plan.explain import explain, explain_analyze
    from .sql import plan_sql, sql

    m = _EXPLAIN_RE.match(query)
    if m and m.group(1):
        print(explain_analyze(plan_sql(query[m.end():].strip(),
                                       catalog=catalog),
                              sf=sf, device=device))
        return 0
    if explain_only or m:
        q = query[m.end():].strip() if m else query
        print(explain(plan_sql(q, catalog=catalog), sf=sf))
        return 0
    kwargs = {"query_id": f"cli_{uuid.uuid4().hex[:8]}"}
    if trace:
        # a tracer, so that the stage spans land somewhere to render
        from .server.tracing import RecordingTracer, get_tracer, set_tracer
        if get_tracer() is None:
            set_tracer(RecordingTracer())
    t0 = time.time()
    res = sql(query, sf=sf, device=device, catalog=catalog, **kwargs)
    dt = time.time() - t0
    print(_format_table(res.names, res.rows(), res.types))
    print(f"({res.row_count} rows in {dt:.2f}s)")
    if stats and res.query_stats is not None:
        print(f"stats: {res.query_stats.summary()}")
    if trace:
        from .server.tracing import get_tracer, trace_doc_of
        doc = trace_doc_of(get_tracer(), kwargs["query_id"])
        if doc is None:
            print("(no spans recorded for this query)")
        else:
            _print_trace(doc)
    return 0


def _watch_line(stats: dict, elapsed: float) -> str:
    """One line of the live ticker from a poll's stats: state, stage,
    rows, percent, elapsed."""
    return (f"{stats.get('state', 'QUEUED'):>9s} | "
            f"{stats.get('stage', '-'):<8s} | "
            f"rows {int(stats.get('processedRows', 0)):>12,} | "
            f"{float(stats.get('progressPercent', 0.0)):5.1f}% | "
            f"{elapsed:6.1f}s")


def run_one_remote(query: str, server: str, user: str = "presto",
                   session=None, stats: bool = False,
                   trace: bool = False, watch: bool = False) -> int:
    """Run one statement on a statement server (POST /v1/statement and
    its nextUri hops) and print its rows, which arrive rendered; with
    `trace`, under a trace context of the client's, whose stitched
    trace it then fetches and renders; with `watch`, a one-line ticker
    of the live progress on stderr while it runs."""
    from .client import QueryError, StatementClient, execute
    extra_headers = None
    if trace:
        from .server.tracing import (TRACE_HEADER, TraceContext,
                                     new_span_id, new_trace_id)
        ctx = TraceContext(new_trace_id(), new_span_id())
        extra_headers = {TRACE_HEADER: ctx.header()}
    t0 = time.time()
    try:
        if watch:
            client = StatementClient(server, query, user=user,
                                     session=session or {},
                                     extra_headers=extra_headers)
            try:
                while True:
                    print("\r" + _watch_line(client.stats or {},
                                             time.time() - t0),
                          end="", file=sys.stderr, flush=True)
                    if not client.advance():
                        break
            finally:
                print(file=sys.stderr)
            client.drain()
        else:
            client = execute(server, query, user=user,
                             session=session or {},
                             extra_headers=extra_headers)
    except QueryError as e:
        print(f"error [{e.error_name}]: {e}", file=sys.stderr)
        return 1
    dt = time.time() - t0
    names = [c["name"] for c in (client.columns or [])]
    rows = [tuple(r) for r in client.data]
    print(_format_table(names, rows))
    extra = f", {client.update_type}" if client.update_type else ""
    print(f"({len(rows)} rows in {dt:.2f}s via {client.query_id}{extra})")
    if stats and client.stats:
        s = client.stats
        parts = [f"wall {s.get('elapsedTimeMillis', 0) / 1e3:.3f}s"]
        if "compileTimeMicros" in s:
            parts.append(f"compile {s['compileTimeMicros'] / 1e6:.3f}s")
        if "executeTimeMicros" in s:
            parts.append(f"execute {s['executeTimeMicros'] / 1e6:.3f}s")
        parts.append(f"rows {s.get('processedRows', len(rows))}")
        parts.append(f"bytes {s.get('processedBytes', 0)}")
        print("stats: " + ", ".join(parts))
    if trace and client.query_id:
        from .traceview import fetch_trace
        try:
            doc = fetch_trace(server, client.query_id)
        except OSError as e:
            print(f"(no trace for {client.query_id} from {server}: "
                  f"{type(e).__name__}: {e}; is a tracer installed on "
                  f"the server?)", file=sys.stderr)
            return 0
        _print_trace(doc)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="presto-tpu-torch")
    ap.add_argument("query", nargs="?", help="SQL to run (omit for a REPL)")
    ap.add_argument("--sf", type=float, default=0.01,
                    help="tpch/tpcds scale factor (default 0.01)")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default cuda)")
    ap.add_argument("--catalog", default=None,
                    help="catalog searched first for unqualified tables")
    ap.add_argument("--explain", action="store_true",
                    help="print the plan instead of running it")
    ap.add_argument("--stats", action="store_true",
                    help="print the QueryStats summary after each query")
    ap.add_argument("--trace", action="store_true",
                    help="render the query's trace as a waterfall")
    ap.add_argument("--watch", action="store_true",
                    help="with --server: a one-line live progress "
                         "ticker while the statement runs")
    ap.add_argument("--server", default=None,
                    help="statement server URL: statements go over the "
                         "client protocol instead of this process")
    ap.add_argument("--user", default="presto")
    args = ap.parse_args(argv)

    def run(stmt: str) -> int:
        if args.server:
            if args.explain and not _EXPLAIN_RE.match(stmt):
                stmt = f"EXPLAIN {stmt}"  # the server's EXPLAIN
            return run_one_remote(stmt, args.server, args.user,
                                  {"sf": str(args.sf)}, stats=args.stats,
                                  trace=args.trace, watch=args.watch)
        return run_one(stmt, args.sf, args.device, args.catalog,
                       explain_only=args.explain, stats=args.stats,
                       trace=args.trace)

    if args.query:
        return run(args.query)

    print("presto-tpu-torch> (end statements with ';', \\q to quit)")
    buf = []
    while True:
        try:
            line = input("presto-tpu-torch> " if not buf else "          > ")
        except EOFError:
            break
        if line.strip() in ("\\q", "quit", "exit"):
            break
        buf.append(line)
        if line.rstrip().endswith(";"):
            stmt = "\n".join(buf).rstrip().rstrip(";")
            buf = []
            try:
                run(stmt)
            except Exception as e:  # noqa: BLE001 - the REPL reports and goes on
                print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
