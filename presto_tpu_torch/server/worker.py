"""Worker: the task REST protocol over the port's runner.

Counterpart of presto_tpu/server/worker.py (the TaskResource /
TaskManager analog; worker-protocol.rst, TaskResource.java:79):

  GET    /v1/info                     node id, state, uptime
  GET    /v1/status                   node status (memory, tasks)
  POST   /v1/task/{taskId}            create or update: the plan JSON
                                      and its scan ranges, remote
                                      sources and output partitions;
                                      idempotent. A Presto coordinator's
                                      TaskUpdateRequest is translated
                                      (server/protocol.py)
  GET    /v1/task/{taskId}            TaskInfo JSON (state, stats)
  GET    /v1/task/{taskId}/status     the spec's TaskStatus
  GET    /v1/task/{taskId}/results/{bufferId}/{token}
                                      SerializedPage bytes; token/ack
                                      pull with X-Presto-Page-* headers
  GET    /v1/task/{taskId}/results/{bufferId}/{token}/acknowledge
  DELETE /v1/task/{taskId}            abort
  GET, POST, DELETE /v1/failpoint     the failpoint admin surface

Each task runs `run_query` on a thread of its own, admitted through a
pool of `task_concurrency` slots, on the worker's device: CUDA unless
the caller passes device="cpu" or a mesh. Results buffer as
SerializedPages with increasing tokens per buffer, dropped on ack.

Each task's end fires a TaskCompleted event (server/events.py), and
the task manager registers for the `system.tasks` table.

Not here yet: the worker's drain and page migration, authentication,
TLS and the stuck-task watchdog (ROADMAP queue 1 item 14e); its
metrics, spans and the flight recorder (item 15). A coordinator's
`traceparent` is accepted and not read.
"""

from __future__ import annotations

import collections
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from .. import failpoints
from ..block import batch_from_numpy, resolve_device
from ..plan import nodes as N
from ..serde import PageCodec, serialize_page
from ..utils.config import session_flag, session_value
from .buffers import SpoolingOutputBuffer
from .events import event_listeners

__all__ = ["TpuWorkerServer", "TaskManager", "FragmentResultCache"]


def _hash_partition_rows(res, channels: List[int], nparts: int, device):
    """The destination partition of each result row, by the engine's
    row hash (expr/functions.py::hash64_block folded with combine_hash,
    modulo nparts as an unsigned 64-bit number): the reference's
    routing bit for bit. One index array per partition."""
    from ..parallel.exchange import bucket_of, row_hash

    if res.row_count == 0:
        return [np.array([], dtype=np.int64)] * nparts
    keys = batch_from_numpy([res.types[c] for c in channels],
                            [res.columns[c] for c in channels],
                            [res.nulls[c] for c in channels], device=device)
    dest = bucket_of(row_hash(keys.columns), nparts).cpu().numpy()
    return [np.nonzero(dest == p)[0] for p in range(nparts)]


def _mesh_fragment(node: N.PlanNode) -> N.PlanNode:
    """A fragment for a worker on a mesh. Its remote batches are cut
    into shards across the mesh like a scan, but a FINAL or
    INTERMEDIATE aggregation over a remote source expects every row of
    a group in one place, and add_exchanges rewrites only SINGLE ones:
    give each such source the exchange the fragmenter cut, a
    REPARTITION on the group keys (a GATHER without keys)."""
    import dataclasses
    changed = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, N.PlanNode):
            nv = _mesh_fragment(v)
            if isinstance(node, N.AggregationNode) and \
                    node.step in ("FINAL", "INTERMEDIATE") and \
                    isinstance(nv, N.RemoteSourceNode):
                keys = list(node.group_channels)
                nv = N.ExchangeNode(
                    nv, kind="REPARTITION" if keys else "GATHER",
                    scope="REMOTE", partition_channels=keys,
                    slot_capacity=node.max_groups if keys else None)
            if nv is not v:
                changed[f.name] = nv
        elif isinstance(v, list) and v and isinstance(v[0], N.PlanNode):
            nl = [_mesh_fragment(x) for x in v]
            if any(a is not b for a, b in zip(nl, v)):
                changed[f.name] = nl
    return dataclasses.replace(node, **changed) if changed else node


class _GoneError(Exception):
    """The requested pages were acked away by an earlier consumer
    (HTTP 410)."""


class FragmentResultCache:
    """Leaf-fragment output cache (FileFragmentResultCacheManager
    analog): serialized result pages keyed by the plan's fingerprint,
    sf, scan ranges, output partitioning, codec and the scanned
    tables' data versions. A fragment over a catalog without
    `data_version`, a remote source or a write is not cached. An LRU
    bounded by bytes."""

    def __init__(self, max_bytes: int = 256 << 20):
        self.max_bytes = max_bytes
        self._entries = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key_of(plan: N.PlanNode, sf: float, scan_ranges: dict,
               out_part, compression) -> Optional[tuple]:
        """None: not cacheable."""
        from ..connectors import catalog
        from ..exec.runner import _fingerprint

        scans: List[Optional[N.TableScanNode]] = []

        def walk(n):
            if isinstance(n, (N.RemoteSourceNode, N.TableWriterNode,
                              N.TableFinishNode, N.TableRewriteNode,
                              N.DdlNode)):
                # remote inputs are not pure; a write must never be
                # skipped by a replay
                scans.append(None)
            if isinstance(n, N.TableScanNode):
                scans.append(n)
            for s in n.sources:
                walk(s)

        walk(plan)
        versions = []
        for s in scans:
            if s is None:
                return None
            try:
                fn = getattr(catalog(s.connector), "data_version", None)
                if fn is None:
                    return None
                versions.append((s.connector, s.table, fn(s.table)))
            except KeyError:
                return None
        return (_fingerprint(plan), sf,
                tuple(sorted((k, tuple(v)) for k, v in scan_ranges.items())),
                repr(out_part), compression, tuple(versions))

    def get(self, key) -> Optional[dict]:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return e

    def put(self, key, buffers: Dict[int, List[bytes]], rows: int,
            stats: Dict[str, float]) -> None:
        size = sum(len(p) for pages in buffers.values() for p in pages)
        if size > self.max_bytes:
            return
        with self._lock:
            if key in self._entries:
                return
            self._entries[key] = {"buffers": {k: list(v) for k, v
                                              in buffers.items()},
                                  "rows": rows, "stats": dict(stats),
                                  "bytes": size}
            self._bytes += size
            while self._bytes > self.max_bytes and self._entries:
                _k, old = self._entries.popitem(last=False)
                self._bytes -= old["bytes"]


class _Task:
    """One task's state; every field the HTTP threads and the task
    thread share is written under `lock`."""

    def __init__(self, task_id: str, spool_threshold: int = 64 << 20,
                 spool_dir: Optional[str] = None):
        self.task_id = task_id
        self.state = "PLANNED"  # -> RUNNING -> FINISHED | FAILED | ABORTED
        self.error: Optional[str] = None
        self._spool_threshold = spool_threshold
        self._spool_dir = spool_dir
        # output buffer id -> pages; an unpartitioned result is buffer 0
        self.buffers: Dict[int, SpoolingOutputBuffer] = {
            0: self._new_buffer()}
        self.first_token: Dict[int, int] = {}  # per buffer: acked prefix
        self.no_more_pages = False
        self.created_at = time.time()
        self.finished_at: Optional[float] = None
        self.stats: Dict[str, object] = {}
        self.lock = threading.Lock()

    def _new_buffer(self) -> SpoolingOutputBuffer:
        return SpoolingOutputBuffer(self._spool_threshold, self._spool_dir)

    def info(self) -> dict:
        with self.lock:
            return {
                "taskId": self.task_id,
                "state": self.state,
                "error": self.error,
                "bufferedPages": sum(len(p) for p in self.buffers.values()),
                "spooledBytes": sum(b.spooled_bytes
                                    for b in self.buffers.values()),
                "noMorePages": self.no_more_pages,
                "stats": dict(self.stats),
                "elapsedSeconds": round(time.time() - self.created_at, 3),
            }


class TaskManager:
    """createOrUpdateTask and the result buffers (TaskManager.cpp:506
    analog). Execution admits through `task_concurrency` slots (the
    TaskExecutor analog): a long task holds one slot while short ones
    pass through the others; the staged bytes of every task reserve
    from one MemoryPool."""

    def __init__(self, sf: float = 0.01, mesh=None, device=None,
                 memory_bytes: int = 12 << 30,
                 task_ttl_s: float = 600.0,
                 task_concurrency: int = 4,
                 output_spool_threshold_bytes: int = 64 << 20,
                 output_spool_dir: Optional[str] = None):
        from ..exec.memory import MemoryPool
        self.sf = sf
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None \
            else resolve_device(device)
        self.tasks: Dict[str, _Task] = {}
        # concurrent tasks wait (bounded) for admission rather than fail
        self.memory_pool = MemoryPool(memory_bytes,
                                      admission_timeout_s=60.0)
        self.task_ttl_s = task_ttl_s
        self.task_concurrency = max(1, int(task_concurrency))
        self.output_spool_threshold_bytes = output_spool_threshold_bytes
        self.output_spool_dir = output_spool_dir
        self._exec_slots = threading.BoundedSemaphore(self.task_concurrency)
        self._tasks_lock = threading.Lock()
        self.fragment_cache = FragmentResultCache()
        self.counters: Dict[str, int] = {
            "tasks_created": 0, "tasks_finished": 0, "tasks_failed": 0,
            "tasks_aborted": 0, "rows_produced": 0, "exchange_bytes": 0}
        self._counters_lock = threading.Lock()
        from ..connectors.system import register_task_manager
        register_task_manager(self)  # system.tasks

    def _count(self, name: str, delta: int = 1):
        with self._counters_lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def _prune_locked(self):
        """Drop terminal tasks older than the TTL: coordinators DELETE
        tasks after use; this is the backstop against leaked ones."""
        cutoff = time.time() - self.task_ttl_s
        for tid in [tid for tid, t in self.tasks.items()
                    if t.finished_at is not None and t.finished_at < cutoff]:
            del self.tasks[tid]

    def create_or_update(self, task_id: str, body: dict) -> dict:
        with self._tasks_lock:
            self._prune_locked()
            task = self.tasks.get(task_id)
            if task is None:
                task = _Task(task_id, self.output_spool_threshold_bytes,
                             self.output_spool_dir)
                self.tasks[task_id] = task
                self._count("tasks_created")
                threading.Thread(target=self._run, args=(task, body),
                                 name=f"task-{task_id}",
                                 daemon=True).start()
        return task.info()

    def active_task_count(self) -> int:
        with self._tasks_lock:
            self._prune_locked()
            return sum(1 for t in self.tasks.values()
                       if t.state in ("PLANNED", "RUNNING"))

    def _run(self, task: _Task, body: dict):
        # the `failpoints` session property arms a schedule for this
        # task's whole scope (pull, serde, execution), undone after
        session = body.get("session") if isinstance(body.get("session"),
                                                    dict) else {}
        try:
            with failpoints.session_scope(session.get("failpoints")):
                self._run_task(task, body, session)
        except Exception as e:  # noqa: BLE001 - a task's failure is data
            with task.lock:
                aborted = task.state == "ABORTED"
                if not aborted:
                    task.state = "FAILED"
                    task.error = f"{type(e).__name__}: {e}"
                task.finished_at = time.time()
            self._count("tasks_aborted" if aborted else "tasks_failed")
            event_listeners().task_completed(
                task.task_id, "ABORTED" if aborted else "FAILED")

    def _pull_remote_sources(self, body: dict, codec: PageCodec):
        """The batches of the fragment's RemoteSourceNodes, pulled from
        the upstream tasks, and the pull's seconds, rows and pages."""
        from ..types import parse_type
        from .http_exchange import fetch_remote_batch
        pad = (self.mesh.size if self.mesh is not None else 1) * 8
        remote, stats = {}, {"pull_s": 0.0, "rows_in": 0, "pages_in": 0,
                             "page_bytes_in": 0}
        for node_id, spec in (body.get("remoteSources") or {}).items():
            t0 = time.perf_counter()
            remote[node_id] = fetch_remote_batch(
                spec["sources"], spec["taskIds"],
                [parse_type(t) for t in spec["types"]], codec,
                pad_multiple=pad, device=self.device,
                buffer_id=int(spec.get("bufferId", 0)),
                ack=bool(spec.get("ack", True)),
                merge_keys=spec.get("mergeKeys"),
                timeout=float(spec.get("timeoutS", 60.0)), stats=stats)
            stats["pull_s"] += time.perf_counter() - t0
            stats["rows_in"] += int(remote[node_id].active.sum())
        return remote, stats

    def _replay(self, task: _Task, hit: dict) -> None:
        """Finish a task from the fragment cache: the original run's
        pages, its rows and bytes, no device time."""
        with task.lock:
            if task.state == "ABORTED":
                return
            for pid, pages in hit["buffers"].items():
                task.buffers.setdefault(pid, task._new_buffer()).extend(pages)
            task.no_more_pages = True
            task.stats = {**{k: v for k, v in hit["stats"].items()
                             if k != "queryStats"},
                          "queryStats": {"fragment_cache_replay": 1},
                          "fragmentCacheHit": 1}
            task.state = "FINISHED"
            task.finished_at = time.time()
        self._count("tasks_finished")
        self._count("rows_produced", hit["rows"])
        event_listeners().task_completed(task.task_id, "FINISHED",
                                         hit["rows"])

    def _run_task(self, task: _Task, body: dict, session: dict):
        from ..exec.runner import run_query
        with task.lock:
            if task.state == "ABORTED":
                return
            task.state = "RUNNING"
        if failpoints.ARMED:
            # error = a crash mid-task, hang/delay = a wedged or slow
            # worker
            failpoints.hit("worker.run_task")
        plan = N.from_json(body["plan"])
        if self.mesh is not None:
            plan = _mesh_fragment(plan)
        if not session_flag(session, "tpu_execution_enabled", True):
            raise RuntimeError(
                "tpu_execution_enabled=false: fragment refused by the "
                "worker (route it to a row-engine cluster)")
        sf = float(body.get("sf", self.sf))
        compression = session_value(session, "exchange_compression", "none")
        codec = PageCodec(compression=None if compression == "none"
                          else compression)
        scan_ranges = {k: tuple(v) for k, v in
                       (body.get("scanRanges") or {}).items()}
        out_part = body.get("outputPartitions")
        # the session's codec on both sides of every exchange (the
        # reference's consumer reads compressed pages with none)
        remote, pull = self._pull_remote_sources(body, codec)
        ckey = None
        if session_flag(session, "fragment_result_cache", True) \
                and not body.get("remoteSources"):
            ckey = FragmentResultCache.key_of(plan, sf, scan_ranges,
                                              out_part, compression)
        if ckey is not None:
            hit = self.fragment_cache.get(ckey)
            if hit is not None:
                self._replay(task, hit)
                return
        t0 = time.perf_counter()
        with self._exec_slots:
            res = run_query(plan, sf=sf, device=self.device, mesh=self.mesh,
                            scan_ranges=scan_ranges, remote_sources=remote,
                            memory_pool=self.memory_pool,
                            query_id=task.task_id, session=session)
        wall = time.perf_counter() - t0
        del remote
        types = plan.output_types()
        t_pack = time.perf_counter()
        if out_part:
            # the PartitionedOutputBuffer analog: one page per consumer
            # partition, routed by the engine's row hash
            parts = _hash_partition_rows(res, list(out_part["channels"]),
                                         int(out_part["count"]), self.device)
            pages = {pid: [serialize_page(
                [(types[i], res.columns[i][sel], res.nulls[i][sel])
                 for i in range(len(res.columns))], codec)]
                for pid, sel in enumerate(parts)}
        else:
            pages = {0: [serialize_page(
                [(types[i], res.columns[i], res.nulls[i])
                 for i in range(len(res.columns))], codec)]}
        serialize_s = time.perf_counter() - t_pack
        total_bytes = sum(len(p) for ps in pages.values() for p in ps)
        qs = {**res.stats, "exchange_pull_s": pull["pull_s"],
              "exchange_rows_in": pull["rows_in"],
              "exchange_pages_in": pull["pages_in"],
              "exchange_page_bytes_in": pull["page_bytes_in"],
              "exchange_serialize_s": serialize_s,
              "exchange_pages_out": sum(len(ps) for ps in pages.values()),
              "exchange_page_bytes_out": total_bytes}
        with task.lock:
            if task.state == "ABORTED":
                return  # abandoned by the coordinator: drop the results
            for pid, ps in pages.items():
                task.buffers.setdefault(pid, task._new_buffer()).extend(ps)
            task.no_more_pages = True
            task.stats = {"wallSeconds": round(wall, 4),
                          "outputRows": res.row_count,
                          "outputBytes": total_bytes, "queryStats": qs}
            task.state = "FINISHED"
            task.finished_at = time.time()
        self._count("tasks_finished")
        self._count("rows_produced", res.row_count)
        self._count("exchange_bytes", total_bytes)
        if ckey is not None:
            self.fragment_cache.put(ckey, pages, res.row_count, task.stats)
        event_listeners().task_completed(task.task_id, "FINISHED",
                                         res.row_count)

    def get(self, task_id: str) -> Optional[_Task]:
        with self._tasks_lock:
            return self.tasks.get(task_id)

    def results(self, task_id: str, token: int, buffer_id: int = 0):
        """-> (page bytes or None, next token, complete). Tokens are
        absolute per buffer; acked pages are dropped but their tokens
        stay consumed. An unknown task raises KeyError (HTTP 404)."""
        task = self.get(task_id)
        if task is None:
            raise KeyError(task_id)
        with task.lock:
            pages = task.buffers.get(buffer_id)
            npages = 0 if pages is None else len(pages)
            first = task.first_token.get(buffer_id, 0)
            if token < first:
                raise _GoneError(
                    f"token {token} below acked prefix {first} of "
                    f"{task_id}/{buffer_id}")
            idx = token - first
            if idx < npages:
                return pages.get(idx), token + 1, False
            done = task.no_more_pages or task.state in ("FAILED", "ABORTED")
            return None, token, done and idx >= npages

    def acknowledge(self, task_id: str, token: int, buffer_id: int = 0):
        task = self.get(task_id)
        if task is None:
            return
        with task.lock:
            first = task.first_token.get(buffer_id, 0)
            pages = task.buffers.get(buffer_id)
            if token - first > 0 and pages is not None:
                pages.drop_prefix(token - first)
                task.first_token[buffer_id] = token

    def abort(self, task_id: str):
        task = self.get(task_id)
        if task is None:
            return
        with task.lock:
            if task.state not in ("FINISHED", "FAILED"):
                task.state = "ABORTED"
            for b in task.buffers.values():
                b.clear()
            task.buffers = {0: task._new_buffer()}
            task.first_token = {}
            if task.finished_at is None:
                task.finished_at = time.time()


class _Handler(BaseHTTPRequestHandler):
    server_version = "presto-tpu-torch/0.1"
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: a response's headers and body go out in two writes,
    # and with Nagle's algorithm the second waits for the client's
    # delayed ACK (~40 ms a request on Linux)
    disable_nagle_algorithm = True

    # set on the bound subclass by TpuWorkerServer
    manager: TaskManager = None
    node_id: str = ""
    started_at: float = 0.0

    def log_message(self, fmt, *args):  # quiet
        pass

    def _body(self):
        length = int(self.headers.get("Content-Length", "0"))
        return json.loads(self.rfile.read(length) or b"{}")

    def _send_json(self, obj, code=200):
        self._send_bytes(json.dumps(obj).encode(),
                         {"Content-Type": "application/json"}, code)

    def _send_bytes(self, body: bytes, headers: Dict[str, str], code=200):
        self.send_response(code)
        if "Content-Type" not in headers:
            self.send_header("Content-Type", "application/x-presto-pages")
        for k, v in headers.items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _failpoint_gate(self, site: str) -> bool:
        """Evaluate a server-side site; False when the request was
        answered (an injected error: 500) or severed (drop_conn: the
        socket closes with no response, as a crashed peer leaves it)."""
        try:
            failpoints.hit(site)
        except failpoints.InjectedConnDrop:
            self.close_connection = True
            self.connection.close()
            return False
        except Exception as e:  # noqa: BLE001 - the injected error
            self._send_json({"error": f"failpoint {site}: "
                                      f"{type(e).__name__}: {e}"}, 500)
            return False
        return True

    def do_GET(self):  # noqa: N802
        parts = [p for p in self.path.split("/") if p]
        m = self.manager
        if parts == ["v1", "info"]:
            return self._send_json({
                "nodeId": self.node_id, "nodeVersion": {"version": "0.1"},
                "environment": "tpu", "coordinator": False,
                "uptime": round(time.time() - self.started_at, 1),
                "state": "ACTIVE"})
        if parts == ["v1", "failpoint"]:
            return self._send_json(failpoints.admin_get_doc())
        if parts == ["v1", "status"]:
            pool = m.memory_pool
            return self._send_json({
                "nodeId": self.node_id,
                "activeTasks": m.active_task_count(),
                "uptimeSeconds": round(time.time() - self.started_at, 1),
                "state": "ACTIVE", "device": str(m.device),
                "memory": {"reservedBytes": pool.reserved_bytes,
                           "capacityBytes": pool.capacity},
                "counters": dict(m.counters)})
        if len(parts) == 3 and parts[:2] == ["v1", "task"]:
            tid, _, query = parts[2].partition("?")
            task = m.get(tid)
            if task is None:
                return self._send_json({"error": "no such task"}, 404)
            if "format=spec" in query:
                from .protocol import task_info_json
                tstats = task.stats
                return self._send_json(task_info_json(
                    tid, task.state, f"http://{self.node_id}",
                    self.node_id, int(time.time() * 1000),
                    rows=tstats.get("outputRows", 0)))
            return self._send_json(task.info())
        if len(parts) == 4 and parts[:2] == ["v1", "task"] and \
                parts[3] == "status":
            task = m.get(parts[2])
            if task is None:
                return self._send_json({"error": "no such task"}, 404)
            from .protocol import task_status_json
            return self._send_json(task_status_json(
                parts[2], task.state, f"http://{self.node_id}",
                failures=[task.error] if task.error else None))
        if len(parts) == 7 and parts[:2] == ["v1", "task"] and \
                parts[3] == "results" and parts[6] == "acknowledge":
            m.acknowledge(parts[2], int(parts[5]), int(parts[4]))
            return self._send_json({"acknowledged": True})
        if len(parts) == 6 and parts[:2] == ["v1", "task"] and \
                parts[3] == "results":
            if failpoints.ARMED and not self._failpoint_gate(
                    "exchange.serve"):
                return
            task_id, buffer_id, token = parts[2], int(parts[4]), int(parts[5])
            try:
                page, next_token, complete = m.results(task_id, token,
                                                       buffer_id)
            except KeyError:
                return self._send_json(
                    {"error": f"no such task {task_id}"}, 404)
            except _GoneError as e:
                return self._send_json({"error": str(e)}, 410)
            task = m.get(task_id)
            if task is not None and task.state == "FAILED":
                return self._send_json({"error": task.error}, 500)
            return self._send_bytes(page or b"", {
                "X-Presto-Task-Instance-Id": task_id,
                "X-Presto-Page-Token": str(token),
                "X-Presto-Page-Next-Token": str(next_token),
                "X-Presto-Buffer-Complete": str(complete).lower()})
        return self._send_json({"error": f"unknown path {self.path}"}, 404)

    def do_POST(self):  # noqa: N802
        parts = [p for p in self.path.split("/") if p]
        if parts == ["v1", "failpoint"]:
            doc, code = failpoints.admin_post(self._body())
            return self._send_json(doc, code)
        if len(parts) == 3 and parts[:2] == ["v1", "task"]:
            body = self._body()
            if "outputIds" in body or "extraCredentials" in body:
                body, err = _translate_presto_request(body)
                if err is not None:
                    return self._send_json(err, 400)
            return self._send_json(
                self.manager.create_or_update(parts[2], body))
        return self._send_json({"error": f"unknown path {self.path}"}, 404)

    def do_DELETE(self):  # noqa: N802
        parts = [p for p in self.path.split("/") if p]
        if parts[:2] == ["v1", "failpoint"] and len(parts) in (2, 3):
            return self._send_json(failpoints.admin_delete(
                parts[2] if len(parts) == 3 else None))
        if len(parts) == 3 and parts[:2] == ["v1", "task"]:
            self.manager.abort(parts[2])
            task = self.manager.get(parts[2])
            return self._send_json(task.info() if task else {"aborted": True})
        return self._send_json({"error": f"unknown path {self.path}"}, 404)


def _translate_presto_request(body: dict):
    """A Presto coordinator's TaskUpdateRequest -> (the worker's body,
    None), or (None, the 400 document): its PlanFragment translated
    into the port's plan vocabulary, refused with the PlanChecker's
    reason where the protocol or `validate_plan` says so. The
    aggregates' masks and fractions come from the protocol: the plan
    object carries them and the plan JSON writes them."""
    from ..plan.validator import validate_plan
    from .protocol import ProtocolUnsupported, parse_task_update_request
    try:
        parsed = parse_task_update_request(body)
    except (ProtocolUnsupported, KeyError, TypeError) as e:
        return None, {"error": f"plan not executable: "
                               f"{type(e).__name__}: {e}",
                      "retriable": False}
    if parsed["plan"] is None:
        return None, {"error": "TaskUpdateRequest without fragment"}
    violations = validate_plan(parsed["plan"])
    if violations:
        return None, {"error": f"plan not executable: {violations}",
                      "retriable": False}
    out = {"plan": N.to_json(parsed["plan"]),
           "session": parsed["session"].get("systemProperties", {})}
    sf = parsed["fragmentInfo"].get("scaleFactor")
    if sf is not None:  # else the worker's own sf
        out["sf"] = sf
    return out, None


class TpuWorkerServer:
    """The HTTP worker (PrestoServer.cpp:493 registerHttpEndpoints
    analog): start() binds a port on 127.0.0.1 and serves on
    background threads; with `discovery_url` it announces itself there
    every `announce_interval_s`."""

    def __init__(self, port: int = 0, sf: float = 0.01, mesh=None,
                 device=None, node_id: Optional[str] = None,
                 discovery_url: Optional[str] = None,
                 announce_interval_s: float = 1.0,
                 task_concurrency: int = 4):
        self.manager = TaskManager(sf=sf, mesh=mesh, device=device,
                                   task_concurrency=task_concurrency)
        self.node_id = node_id or f"tpu-worker-{uuid.uuid4().hex[:8]}"
        handler = type("BoundHandler", (_Handler,), {
            "manager": self.manager, "node_id": self.node_id,
            "started_at": time.time()})
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._announcer = None
        if discovery_url:
            from .discovery import Announcer
            self._announcer = Announcer(discovery_url, self.node_id,
                                        self.url,
                                        interval_s=announce_interval_s)

    def start(self):
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        if self._announcer:
            self._announcer.start()
        return self

    def stop(self, unannounce: bool = True):
        """Stop serving; `unannounce` False is a crash, not a goodbye:
        discovery notices only when the announcement ages out."""
        if self._announcer:
            self._announcer.stop(unannounce=unannounce)
        self.httpd.shutdown()
        self.httpd.server_close()
