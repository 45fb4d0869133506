"""System connector: the cluster's own state as tables.

Counterpart of presto_tpu/connectors/system.py (presto-main's system
connector: runtime.queries, runtime.tasks, runtime.nodes,
metadata.catalogs). Statement servers and worker task managers register
themselves when they start; a scan takes a snapshot of their state on
the host, and no table holds device data.

    SELECT query_id, state, query FROM system.queries
    SELECT task_id, state, rows FROM system.tasks
    SELECT * FROM system.catalogs

The tables that read the observability ledgers (plan_cache, kernels,
datapath, cardinality, occupancy and query_history) keep their columns
and raise naming ROADMAP queue 1 item 15, which ports those ledgers;
so do the ledger-fed columns of `queries` (bytes, memory, compile time,
progress) and `live_tasks` (splits, rows, bytes), which read 0 until
then. `live_tasks` lists the registered servers' queries and tasks
that have not ended.
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

# the tables fed by the observability ledgers, and the ledger each reads
_LEDGER_TABLES = {"plan_cache": "exec/plan_cache.py",
                  "kernels": "exec/profiler.py",
                  "datapath": "exec/datapath.py",
                  "cardinality": "exec/accuracy.py",
                  "occupancy": "exec/timeline.py",
                  "query_history": "server/history.py"}


def _query_rows() -> List[tuple]:
    with _lock:
        servers = _live(_statement_servers)
    return [(d["queryId"], d["state"], d["user"], d["query"],
             int(d.get("elapsedTimeMillis", 0)), 0, 0, 0, 0, 0, 0.0, "", 0,
             str(d.get("resourceGroup", "")), int(d.get("batchSize", 0)))
            for s in servers for d in s.queries_doc()]


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
    out = []
    for r in _query_rows():
        if r[1] not in ("FINISHED", "FAILED", "CANCELED"):
            out.append((r[0], r[0], "query", "", r[1], "", 0, 0, 0, 0, 0,
                        0.0, r[4], 0, False))
    for i in _task_infos():
        if i["state"] in ("PLANNED", "RUNNING"):
            out.append((i["taskId"], i["taskId"].split(".")[0], "task", "",
                        i["state"], "", 0, 0, 0, 0, 0, 0.0,
                        int(i["elapsedSeconds"] * 1000), 0, False))
    return out


def _rows_of(table: str) -> List[tuple]:
    if table in _LEDGER_TABLES:
        raise NotImplementedError(
            f"system.{table} reads {_LEDGER_TABLES[table]}, which is not "
            "ported yet (ROADMAP queue 1 item 15: the observability "
            "ledgers)")
    if table == "queries":
        return _query_rows()
    if table == "live_tasks":
        return _live_task_rows()
    if table == "tasks":
        out = []
        for i in _task_infos():
            st = i.get("stats") or {}
            out.append((i["taskId"], i["state"],
                        int(st.get("outputRows", 0)), i["bufferedPages"],
                        i["elapsedSeconds"], int(st.get("outputBytes", 0)),
                        0, 0))
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
