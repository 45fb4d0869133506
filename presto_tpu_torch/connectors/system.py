"""System connector: the cluster's own state as tables.

Counterpart of presto_tpu/connectors/system.py (presto-main's system
connector: runtime.queries, runtime.tasks, runtime.nodes,
metadata.catalogs). Statement servers and worker task managers register
themselves when they start; a scan takes a snapshot of their state on
the host, and no table holds device data.

    SELECT query_id, state, query FROM system.queries
    SELECT task_id, state, rows FROM system.tasks
    SELECT * FROM system.catalogs

The tables of the observability ledgers read them as the reference's
do: `kernels` (exec/profiler.py), `datapath` (exec/datapath.py),
`cardinality` (exec/accuracy.py), `occupancy` (exec/timeline.py) and
`query_history` (server/history.py); `queries` takes its bytes, memory,
compile time and progress from each statement's QueryStats and live
progress, and `live_tasks` lists every in-flight entry of the progress
registry (exec/progress.py), and `plan_cache` the compiled-plan
cache's entries, hits and misses (exec/plan_cache.py).
"""

from __future__ import annotations

import threading
import weakref
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import types as T
from ..block import batch_from_numpy

__all__ = ["SCHEMA", "register_statement_server", "register_task_manager",
           "register_discovery", "reset", "table_row_count",
           "generate_columns", "generate_nulls", "generate_batch",
           "column_type"]

_lock = threading.Lock()
# weak references: a registration must not keep a stopped server alive
_statement_servers: List[weakref.ref] = []
_task_managers: List[weakref.ref] = []
_discovery_urls: List[str] = []


def _live(refs: List[weakref.ref]) -> List[object]:
    out = [r() for r in refs]
    refs[:] = [r for r, o in zip(refs, out) if o is not None]
    return [o for o in out if o is not None]


def register_statement_server(server) -> None:
    with _lock:
        if server not in _live(_statement_servers):
            _statement_servers.append(weakref.ref(server))


def register_task_manager(manager) -> None:
    with _lock:
        if manager not in _live(_task_managers):
            _task_managers.append(weakref.ref(manager))


def register_discovery(url: str) -> None:
    with _lock:
        if url not in _discovery_urls:
            _discovery_urls.append(url)


def reset() -> None:
    with _lock:
        _statement_servers.clear()
        _task_managers.clear()
        _discovery_urls.clear()


_V = T.varchar(256)
SCHEMA = {
    "queries": {"query_id": _V, "state": _V, "user": _V, "query": _V,
                "elapsed_ms": T.BIGINT,
                "cumulative_bytes": T.BIGINT,
                "peak_memory_bytes": T.BIGINT,
                "compile_us": T.BIGINT,
                "processed_rows": T.BIGINT,
                "processed_bytes": T.BIGINT,
                "progress_percent": T.DOUBLE,
                "stage": _V,
                "last_advance_age_ms": T.BIGINT,
                "resource_group": _V,
                "batch_size": T.BIGINT},
    "live_tasks": {"task_id": _V, "query_id": _V, "kind": _V,
                   "worker": _V, "state": _V, "stage": _V,
                   "splits_done": T.BIGINT, "splits_planned": T.BIGINT,
                   "rows": T.BIGINT, "bytes": T.BIGINT,
                   "peak_memory_bytes": T.BIGINT,
                   "progress_percent": T.DOUBLE,
                   "elapsed_ms": T.BIGINT,
                   "last_advance_age_ms": T.BIGINT,
                   "speculative": T.BOOLEAN},
    "tasks": {"task_id": _V, "state": _V, "rows": T.BIGINT,
              "buffered_pages": T.BIGINT, "elapsed_s": T.DOUBLE,
              "output_bytes": T.BIGINT, "peak_memory_bytes": T.BIGINT,
              "compile_us": T.BIGINT},
    "nodes": {"node_id": _V, "uri": _V, "coordinator": T.BOOLEAN,
              "age_seconds": T.DOUBLE},
    "catalogs": {"catalog_name": _V, "connector_id": _V},
    "tables": {"catalog_name": _V, "table_name": _V,
               "column_count": T.BIGINT},
    "plan_cache": {"entries": T.BIGINT, "hits": T.BIGINT,
                   "misses": T.BIGINT},
    "kernels": {"fingerprint": _V, "plan": _V, "tables": _V,
                "calls": T.BIGINT, "device_time_us": T.BIGINT,
                "max_device_time_us": T.BIGINT,
                "rows_in": T.BIGINT, "bytes_in": T.BIGINT,
                "rows_out": T.BIGINT, "bytes_out": T.BIGINT,
                "retraces": T.BIGINT, "footprint_bytes": T.BIGINT},
    "datapath": {"hop": _V, "bytes": T.BIGINT, "wall_us": T.BIGINT,
                 "invocations": T.BIGINT,
                 "achieved_b_per_s": T.DOUBLE,
                 "ceiling_b_per_s": T.DOUBLE,
                 "utilization": T.DOUBLE},
    "cardinality": {"query_id": _V, "node": _V, "node_type": _V,
                    "unit": _V, "est": T.DOUBLE, "actual": T.DOUBLE,
                    "q_error": T.DOUBLE, "direction": _V,
                    "tasks": T.BIGINT},
    "occupancy": {"query_id": _V, "lane": _V, "busy_us": T.BIGINT,
                  "busy_fraction": T.DOUBLE, "wall_us": T.BIGINT,
                  "overlap_fraction": T.DOUBLE,
                  "device_idle_us": T.BIGINT, "bubble_hop": _V},
    "session_properties": {"name": _V, "default_value": _V, "type": _V,
                           "description": _V},
    "functions": {"function_name": _V, "kind": _V},
    "query_history": {"query_id": _V, "state": _V, "user": _V,
                      "query": _V, "fingerprint": _V, "trace_id": _V,
                      "ts_us": T.BIGINT, "wall_us": T.BIGINT,
                      "compile_us": T.BIGINT, "execute_us": T.BIGINT,
                      "staged_bytes": T.BIGINT,
                      "narrowed_bytes_saved": T.BIGINT,
                      "retraces": T.BIGINT, "spill_bytes": T.BIGINT,
                      "peak_memory_bytes": T.BIGINT,
                      "output_rows": T.BIGINT,
                      "failpoint_hits": T.BIGINT,
                      "regressions": _V,
                      "max_q_error": T.DOUBLE,
                      "misestimated_node": _V},
}

def _compile_us_of(qs: dict) -> int:
    """Total compile micros of a QueryStats JSON document."""
    return int(sum(int(st.get("compile_us", 0))
                   for st in (qs.get("stages") or {}).values()))


def _query_rows() -> List[tuple]:
    with _lock:
        servers = _live(_statement_servers)
    out = []
    for s in servers:
        for doc in s.queries_doc():
            qs = doc.get("queryStats") or {}
            prog = doc.get("progress") or {}
            out.append((doc["queryId"], doc["state"], doc["user"],
                        doc["query"], int(doc.get("elapsedTimeMillis", 0)),
                        int(qs.get("outputBytes", 0)),
                        int(qs.get("peakMemoryBytes", 0)),
                        _compile_us_of(qs), int(prog.get("rows", 0)),
                        int(prog.get("bytes", 0)),
                        float(prog.get("progressPercent", 0.0)),
                        str(prog.get("stage", "")),
                        int(prog.get("lastAdvanceAgeMs", 0)),
                        str(doc.get("resourceGroup", "")),
                        int(doc.get("batchSize", 0))))
    return out


def _task_infos() -> List[dict]:
    with _lock:
        managers = _live(_task_managers)
    out = []
    for m in managers:
        with m._tasks_lock:
            tasks = list(m.tasks.values())
        out.extend(t.info() for t in tasks)
    return out


def _live_task_rows() -> List[tuple]:
    from ..exec.progress import live_snapshots
    return [(e["key"], e["query"], e["kind"], e["worker"] or "",
             e["state"], e["stage"], int(e["splitsDone"]),
             int(e["splitsPlanned"]), int(e["rows"]), int(e["bytes"]),
             int(e["peakMemoryBytes"]), float(e["progressPercent"]),
             int(e["elapsedMs"]), int(e["lastAdvanceAgeMs"]),
             bool(e.get("speculative", False)))
            for e in live_snapshots()]


def _history_rows() -> List[tuple]:
    from ..server.history import get_history_archive
    out = []
    for r in get_history_archive().records():
        st = r.get("stats") or {}
        out.append((r.get("queryId", ""), r.get("state", ""),
                    r.get("user", ""), r.get("query", ""),
                    r.get("fingerprint", ""), r.get("traceId", ""),
                    int(r.get("tsUs", 0)), int(st.get("wall_us", 0)),
                    int(st.get("compile_us", 0)),
                    int(st.get("execute_us", 0)),
                    int(st.get("staged_bytes", 0)),
                    int(st.get("narrowed_bytes_saved", 0)),
                    int(st.get("retraces", 0)),
                    int(st.get("spill_bytes", 0)),
                    int(st.get("peak_memory_bytes", 0)),
                    int(st.get("output_rows", 0)),
                    int(r.get("failpointHits", 0)),
                    ",".join(r.get("regressions") or ()),
                    float(st.get("max_q_error", 0.0)),
                    r.get("misestimatedNode", "")))
    return out


def _ledger_rows(table: str) -> List[tuple]:
    """The rows of one ledger-fed table, as the reference builds them."""
    if table == "query_history":
        return _history_rows()
    if table == "datapath":
        from ..exec.datapath import snapshot
        return [(r["hop"], int(r["bytes"]), int(r["wall_us"]),
                 int(r["invocations"]), float(r["achievedBPerS"]),
                 float(r["ceilingBPerS"]), float(r["utilization"]))
                for r in snapshot()]
    if table == "cardinality":
        from ..exec.accuracy import snapshot
        return [(r["queryId"], r["node"], r["node_type"], r["unit"],
                 float(r["est"]) if r["est"] is not None else 0.0,
                 float(r["actual"]) if r["actual"] is not None else 0.0,
                 float(r["qError"]) if r["qError"] is not None else 0.0,
                 r["direction"], int(r["tasks"]))
                for r in snapshot()]
    if table == "occupancy":
        from ..exec.timeline import snapshot
        return [(r["queryId"], r["lane"], int(r["busyUs"]),
                 float(r["busyFraction"]), int(r["wallUs"]),
                 float(r["overlapFraction"]), int(r["deviceIdleUs"]),
                 r["bubbleHop"])
                for r in snapshot()]
    from ..exec.profiler import profile_snapshot
    return [(p["fingerprint"], p["label"], p["tables"], int(p["calls"]),
             int(p["device_us"]), int(p["max_device_us"]),
             int(p["rows_in"]), int(p["bytes_in"]), int(p["rows_out"]),
             int(p["bytes_out"]), int(p["retraces"]),
             int(p["footprint_bytes"]))
            for p in profile_snapshot()]


def _rows_of(table: str) -> List[tuple]:
    if table == "plan_cache":
        from ..exec.plan_cache import cache_stats
        st = cache_stats()
        return [(st["entries"], st["hits"], st["misses"])]
    if table in ("kernels", "datapath", "cardinality", "occupancy",
                 "query_history"):
        return _ledger_rows(table)
    if table == "queries":
        return _query_rows()
    if table == "live_tasks":
        return _live_task_rows()
    if table == "tasks":
        out = []
        for i in _task_infos():
            st = i.get("stats") or {}
            qs = st.get("queryStats") or {}
            out.append((i["taskId"], i["state"],
                        int(st.get("outputRows", 0)), i["bufferedPages"],
                        i["elapsedSeconds"], int(st.get("outputBytes", 0)),
                        int(qs.get("peakMemoryBytes", 0)),
                        _compile_us_of(qs)))
        return out
    if table == "nodes":
        from ..server.discovery import alive_nodes
        with _lock:
            urls = list(_discovery_urls)
        out = []
        for url in urls:
            try:
                nodes = alive_nodes(url, max_age_s=1e9)
            except OSError:  # a discovery service that is down
                continue
            out.extend((n.get("nodeId", ""), n.get("uri", ""),
                        bool(n.get("coordinator", False)),
                        float(n.get("ageSeconds", 0.0))) for n in nodes)
        return out
    if table == "catalogs":
        from . import catalogs
        return [(name, name) for name in sorted(catalogs())]
    if table == "tables":
        from . import catalogs
        out = []
        for cat, mod in sorted(catalogs().items()):
            sch = mod.SCHEMA
            for t in sorted(sch.keys()):
                try:
                    out.append((cat, t, len(sch[t])))
                except KeyError:  # a table dropped while listed
                    pass
        return out
    if table == "session_properties":
        from ..utils.config import SESSION_PROPERTIES
        return [(name, str(prop.default), prop.kind, prop.description)
                for name, prop in sorted(
                    SESSION_PROPERTIES.properties.items())]
    if table == "functions":
        from ..expr.functions import REGISTRY
        from ..ops.aggregation import _AGGS
        from ..ops.window import _FUNCS as _WIN
        from ..sql.udf import get_function_namespace_manager
        out = [(n, "scalar") for n in sorted(REGISTRY)
               if not n.startswith("$")]
        out += [(n, "aggregate") for n in sorted(_AGGS)]
        out += [(n, "window") for n in sorted(_WIN)]
        out += [(f.qualified_name, "sql-invoked")
                for f in get_function_namespace_manager().list_functions()]
        return out
    raise KeyError(f"no system table {table!r}")


def column_type(table: str, column: str) -> T.Type:
    return SCHEMA[table][column]


def table_row_count(table: str, sf: float = 0.0) -> int:
    return len(_rows_of(table))


def generate_columns(table: str, sf: float, columns: Sequence[str],
                     start: int = 0, count: Optional[int] = None
                     ) -> Dict[str, np.ndarray]:
    rows = _rows_of(table)
    count = len(rows) - start if count is None else count
    rows = rows[start:start + count]
    names = list(SCHEMA[table])
    out = {}
    for c in columns:
        i = names.index(c)
        ty = SCHEMA[table][c]
        vals = [r[i] for r in rows]
        if ty.is_string:
            out[c] = np.array([str(v) for v in vals], dtype=object)
        else:
            out[c] = np.array(vals, dtype=ty.to_dtype())
    return out


def generate_nulls(table: str, columns: Sequence[str], start: int = 0,
                   count: Optional[int] = None) -> Dict[str, np.ndarray]:
    n = table_row_count(table) - start if count is None else count
    return {c: np.zeros(max(n, 0), dtype=bool) for c in columns}


def generate_batch(table: str, sf: float, columns: Sequence[str],
                   start: int = 0, count: Optional[int] = None,
                   capacity: Optional[int] = None, device=None):
    """The snapshot's rows staged as one Batch on `device` (None:
    CUDA)."""
    data = generate_columns(table, sf, columns, start, count)
    vals = [data[c] for c in columns]
    n = len(vals[0]) if vals else 0
    return batch_from_numpy([SCHEMA[table][c] for c in columns], vals,
                            capacity=capacity or max(n, 1), device=device)
