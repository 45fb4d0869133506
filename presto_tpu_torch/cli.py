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

EXPLAIN (`plan/explain.py`, ROADMAP queue 1 item 15) and `--trace` (the
tracer, item 15) are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import re
import sys
import time

_EXPLAIN_RE = re.compile(r"\s*explain\b", re.IGNORECASE)


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


def run_one(query: str, sf: float, device=None, catalog=None) -> int:
    """Run one statement and print its rows as a table."""
    from .sql import sql

    if _EXPLAIN_RE.match(query):
        raise NotImplementedError("EXPLAIN is not ported yet (ROADMAP "
                                  "queue 1 item 15: plan/explain.py)")
    t0 = time.time()
    res = sql(query, sf=sf, device=device, catalog=catalog)
    dt = time.time() - t0
    print(_format_table(res.names, res.rows(), res.types))
    print(f"({res.row_count} rows in {dt:.2f}s)")
    return 0


def run_one_remote(query: str, server: str, user: str = "presto",
                   session=None) -> int:
    """Run one statement on a statement server (POST /v1/statement and
    its nextUri hops) and print its rows, which arrive rendered."""
    from .client import QueryError, execute
    t0 = time.time()
    try:
        client = execute(server, query, user=user, session=session or {})
    except QueryError as e:
        print(f"error [{e.error_name}]: {e}", file=sys.stderr)
        return 1
    dt = time.time() - t0
    names = [c["name"] for c in (client.columns or [])]
    rows = [tuple(r) for r in client.data]
    print(_format_table(names, rows))
    extra = f", {client.update_type}" if client.update_type else ""
    print(f"({len(rows)} rows in {dt:.2f}s via {client.query_id}{extra})")
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
    ap.add_argument("--explain", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--server", default=None,
                    help="statement server URL: statements go over the "
                         "client protocol instead of this process")
    ap.add_argument("--user", default="presto")
    args = ap.parse_args(argv)
    if args.explain:
        raise NotImplementedError("EXPLAIN is not ported yet (ROADMAP "
                                  "queue 1 item 15: plan/explain.py)")
    if args.trace:
        raise NotImplementedError("--trace is not ported yet (ROADMAP "
                                  "queue 1 item 15: the tracer)")

    def run(stmt: str) -> int:
        if args.server:
            return run_one_remote(stmt, args.server, args.user,
                                  {"sf": str(args.sf)})
        return run_one(stmt, args.sf, args.device, args.catalog)

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
