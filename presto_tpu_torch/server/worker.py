"""Worker: the task REST protocol over the port's runner.

Counterpart of presto_tpu/server/worker.py (the TaskResource /
TaskManager analog; worker-protocol.rst, TaskResource.java:79):

  GET    /v1/info                     node id, state, uptime
  GET    /v1/status                   node status (memory, tasks)
  GET    /v1/metrics, /v1/info/metrics
                                      Prometheus text (OpenMetrics on
                                      Accept)
  GET    /v1/{profile,datapath,accuracy,timeline,history}
                                      this process's ledger slices
  GET    /v1/trace/{traceId}          the spans this process recorded
  POST   /v1/task/{taskId}            create or update: the plan JSON
                                      and its scan ranges, remote
                                      sources and output partitions;
                                      idempotent. A Presto coordinator's
                                      TaskUpdateRequest is translated
                                      (server/protocol.py)
  GET    /v1/task/{taskId}            TaskInfo JSON (state, stats)
  GET    /v1/task/{taskId}/status     the spec's TaskStatus (thrift
                                      bytes under Accept:
                                      application/x-thrift)
  GET    /v1/task/{taskId}/results/{bufferId}/{token}
                                      SerializedPage bytes; token/ack
                                      pull with X-Presto-Page-* headers
  GET    /v1/task/{taskId}/results/{bufferId}/{token}/acknowledge
  DELETE /v1/task/{taskId}            abort
  POST   /v1/task/{taskId}/migrate    adopt a draining peer's finished
                                      task and its buffered pages
  POST   /v1/worker/drain             graceful drain ({"migrateTo":
                                      url, "timeoutMs": ms})
  GET    /v1/worker/drain             the drain's state and pages
  PUT    /v1/info/state               "SHUTTING_DOWN": refuse new tasks
  GET, POST, DELETE /v1/failpoint     the failpoint admin surface

Each task runs `run_query` on a thread of its own, admitted through a
pool of `task_concurrency` slots, on the worker's device: CUDA unless
the caller passes device="cpu" or a mesh. Results buffer as
SerializedPages with increasing tokens per buffer, dropped on ack.

Each task's end fires a TaskCompleted event (server/events.py), and
the task manager registers for the `system.tasks` table.

With `shared_secret` (or the process-wide secret of server/auth.py)
every route requires the internal bearer (401 otherwise); with
`tls=(cert, key)` the worker serves https.

A graceful drain (TpuWorkerServer.begin_drain) refuses new tasks,
announces DRAINING, waits for the running ones, moves every finished
task's buffered pages to the `migrateTo` peer (which adopts them at
their absolute tokens; a consumer's pull here is redirected there),
and unannounces once no page is left: ACTIVE -> DRAINING -> DRAINED.
A failed migration keeps the pages served here until consumed.

A task runs under the coordinator's trace: the body's `traceparent`
(else its `traceId`, else the task id) names the trace, the task's
span hangs under the propagated span, and the engine's stage spans and
the exchange fetches hang under the task's span. The spans the task
recorded ride its final TaskInfo (`spans`) for the coordinator to
stitch, and its QueryStats ride `stats.queryStats` in the reference's
JSON shape (the port's flat counters beside it as
`stats.runtimeStats`). A task's live progress (exec/progress.py)
rides every TaskInfo poll from the moment it runs, and a stuck-progress
watchdog (server/watchdog.py) scans the running tasks. A failed task
leaves a flight-recorder dump.
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
from .auth import authorize_request, make_authenticator
from .buffers import SpoolingOutputBuffer
from .events import event_listeners
from .flight_recorder import record_event
from ..utils.locks import OrderedLock

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


class _MovedError(Exception):
    """The task's pages were migrated by a drain: the argument is the
    url of the peer that adopted them."""


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
        self._lock = OrderedLock("worker.FragmentResultCache._lock")
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
                 spool_dir: Optional[str] = None, session_stuck_ms=None):
        self.task_id = task_id
        # the task session's stuck_query_threshold_ms (None: the
        # PRESTO_TPU_STUCK_MS environment variable at scan time)
        self.session_stuck_ms = session_stuck_ms
        # the spans the task recorded, set once it is terminal
        self.spans: List[dict] = []
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
        # the adopting peer's url once a drain migrated the pages
        self.moved_to: Optional[str] = None
        self.lock = OrderedLock("worker._Task.lock")

    def _new_buffer(self) -> SpoolingOutputBuffer:
        return SpoolingOutputBuffer(self._spool_threshold, self._spool_dir)

    def info(self) -> dict:
        with self.lock:
            doc = {
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
            if self.moved_to is not None:
                doc["movedTo"] = self.moved_to
            if self.spans:
                doc["spans"] = list(self.spans)
        # the live progress rides every poll (the coordinator folds it
        # into its own registry)
        from ..exec.progress import get_progress
        ent = get_progress(self.task_id)
        if ent is not None:
            doc["progress"] = ent.snapshot()
        return doc


class TaskManager:
    """createOrUpdateTask and the result buffers (TaskManager.cpp:506
    analog). Execution admits through `task_concurrency` slots (the
    TaskExecutor analog): a long task holds one slot while short ones
    pass through the others; the staged bytes of every task reserve
    from one MemoryPool. `draining` and `drained` change under the
    tasks lock, so that refusing a new task is atomic with creating
    one."""

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
        self.draining = False  # refuses new tasks (SHUTTING_DOWN)
        self.drained = False   # every buffered page replayed or migrated
        # concurrent tasks wait (bounded) for admission rather than fail
        self.memory_pool = MemoryPool(memory_bytes,
                                      admission_timeout_s=60.0)
        self.task_ttl_s = task_ttl_s
        self.task_concurrency = max(1, int(task_concurrency))
        self.output_spool_threshold_bytes = output_spool_threshold_bytes
        self.output_spool_dir = output_spool_dir
        self._exec_slots = threading.BoundedSemaphore(self.task_concurrency)
        self._tasks_lock = OrderedLock("worker.TaskManager._tasks_lock")
        self.fragment_cache = FragmentResultCache()
        self.counters: Dict[str, int] = {
            "tasks_created": 0, "tasks_finished": 0, "tasks_failed": 0,
            "tasks_aborted": 0, "tasks_adopted": 0, "pages_migrated": 0,
            "rows_produced": 0, "exchange_bytes": 0, "compile_us": 0,
            "execute_us": 0}
        self._counters_lock = OrderedLock("worker.TaskManager._counters_lock")
        from ..connectors.system import register_task_manager
        register_task_manager(self)  # system.tasks

    def _count(self, name: str, delta: int = 1):
        with self._counters_lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def drain(self) -> None:
        """Enter SHUTTING_DOWN: refuse new tasks, let running ones
        finish."""
        with self._tasks_lock:
            self.draining = True

    def mark_drained(self) -> None:
        """The drain is complete: every buffered page was replayed or
        migrated."""
        with self._tasks_lock:
            self.draining = True
            self.drained = True

    @property
    def drain_state(self) -> str:
        """ACTIVE, DRAINING or DRAINED: the fleet state of /v1/status
        and /v1/worker/drain."""
        with self._tasks_lock:
            if self.drained:
                return "DRAINED"
            return "DRAINING" if self.draining else "ACTIVE"

    def unreplayed_pages(self) -> int:
        """Buffered result pages this worker still owns (migrated tasks
        excluded): what a drain must bring to zero before the node
        unannounces."""
        with self._tasks_lock:
            tasks = list(self.tasks.values())
        total = 0
        for t in tasks:
            with t.lock:
                if t.moved_to is None:
                    total += sum(len(b) for b in t.buffers.values())
        return total

    def migrate_buffers(self, peer_url: str, timeout: float = 30.0,
                        secret: Optional[str] = None) -> int:
        """Move every finished task's remaining buffered pages (the
        spooled tail included) to `peer_url`; returns the pages moved.
        A task's export and its `moved_to` flip happen in one critical
        section of its lock, so no consumer can ack a page here after
        its copy left. A failed POST is probed: only an adoption the
        peer confirms absent rolls the flip back, and the pages stay
        served here; a drain never loses or doubles a page."""
        from .client import WorkerClient
        with self._tasks_lock:
            tasks = list(self.tasks.values())
        # an internal hop like any other: on a secured cluster it
        # carries the secret, or every adoption answers 401
        client = WorkerClient(peer_url, timeout=timeout,
                              shared_secret=secret)
        moved = 0
        for task in tasks:
            with task.lock:
                if task.moved_to is not None or task.state != "FINISHED" \
                        or not task.no_more_pages:
                    continue
                npages = sum(len(b) for b in task.buffers.values())
                if npages == 0:
                    continue
                doc = {"state": task.state, "noMorePages": True,
                       "stats": dict(task.stats),
                       "firstToken": {str(b): task.first_token.get(b, 0)
                                      for b in task.buffers},
                       "buffers": {str(b): buf.export_pages()
                                   for b, buf in task.buffers.items()}}
                # consumers are redirected from here on; the peer's
                # adoption races them by at most a short retry
                task.moved_to = peer_url.rstrip("/")
            try:
                client.migrate(task.task_id, doc)
            except Exception:  # noqa: BLE001 - the peer refused or died
                # a timed-out POST may still have landed: roll back only
                # when the peer has no copy, or two nodes would serve
                # the same pages (the suppressed-error counts are item
                # 15's)
                adopted = False
                try:
                    adopted = client.task_info(task.task_id) is not None
                except Exception:  # noqa: BLE001 - 404 or a dead peer
                    adopted = False
                if not adopted:
                    with task.lock:
                        task.moved_to = None
                    continue
            with task.lock:
                for b in task.buffers.values():
                    b.clear()
                task.buffers = {}
            moved += npages
            self._count("pages_migrated", npages)
        return moved

    def adopt_task(self, task_id: str, doc: dict) -> dict:
        """Adopt a draining peer's finished task: its buffered pages at
        their original absolute tokens, so that redirected consumers
        resume here. Idempotent; refused while this worker drains."""
        with self._tasks_lock:
            self._prune_locked()
            task = self.tasks.get(task_id)
            if task is None:
                if self.draining:
                    raise RuntimeError(
                        "worker is SHUTTING_DOWN: not adopting tasks")
                task = _Task(task_id, self.output_spool_threshold_bytes,
                             self.output_spool_dir)
                self.tasks[task_id] = task
                adopted = True
            else:
                adopted = False
        if not adopted:
            return task.info()
        # restored (and perhaps spooled to disk) outside the task lock:
        # only this thread adopts the task, and a consumer that comes
        # first sees an empty task and retries
        buffers: Dict[int, SpoolingOutputBuffer] = {}
        for bid, pages in (doc.get("buffers") or {}).items():
            buf = task._new_buffer()
            buf.restore_pages(pages)
            buffers[int(bid)] = buf
        with task.lock:
            task.buffers = buffers or {0: task._new_buffer()}
            task.first_token = {int(b): int(t) for b, t in
                                (doc.get("firstToken") or {}).items()}
            task.no_more_pages = bool(doc.get("noMorePages", True))
            task.stats = dict(doc.get("stats") or {})
            task.state = str(doc.get("state", "FINISHED"))
            task.finished_at = time.time()
        self._count("tasks_adopted")
        return task.info()

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
                # a drain refuses only new tasks: a repeated POST of a
                # running one still answers
                if self.draining:
                    raise RuntimeError(
                        "worker is SHUTTING_DOWN: not accepting tasks")
                sess = body.get("session") \
                    if isinstance(body.get("session"), dict) else {}
                task = _Task(task_id, self.output_spool_threshold_bytes,
                             self.output_spool_dir,
                             session_stuck_ms=sess.get(
                                 "stuck_query_threshold_ms"))
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

    def _stuck_candidates(self):
        """The RUNNING tasks offered to the stuck-progress watchdog:
        threshold from the task's session (env fallback at scan time),
        last advance from its progress entry (its creation where the
        runner registered nothing yet)."""
        from ..exec.progress import get_progress
        from .watchdog import StuckCandidate, resolve_stuck_threshold_ms
        with self._tasks_lock:
            tasks = list(self.tasks.values())
        out = []
        for t in tasks:
            with t.lock:
                state = t.state
            if state != "RUNNING":
                continue
            sess = None if t.session_stuck_ms is None else \
                {"stuck_query_threshold_ms": t.session_stuck_ms}
            thr = resolve_stuck_threshold_ms(sess)
            if thr <= 0:
                continue
            ent = get_progress(t.task_id)
            snap = ent.snapshot() if ent is not None else None
            out.append(StuckCandidate(
                t.task_id, thr,
                snap["lastAdvanceTsUs"] / 1e6 if snap else t.created_at,
                trace_id=snap["query"] if snap else None,
                extra={"stage": snap["stage"] if snap else "start"}))
        return out

    def _run(self, task: _Task, body: dict):
        """The task under its trace: the propagated context parsed,
        the task run with a span buffer and the context installed, then
        the task's span emitted and the recorded spans pinned to the
        task for its final status."""
        from ..exec.progress import finish_task
        from .flight_recorder import get_flight_recorder
        from .metrics import observe_histogram
        from .tracing import (TraceContext, emit_span, new_span_id,
                              parse_traceparent, span_buffer,
                              trace_context)
        session = body.get("session") if isinstance(body.get("session"),
                                                    dict) else {}
        ctx = parse_traceparent(body.get("traceparent"))
        trace_id = (ctx.trace_id if ctx else None) or \
            body.get("traceId") or task.task_id
        task_ctx = TraceContext(trace_id, new_span_id())
        t_start = time.time()
        with span_buffer() as buf, trace_context(task_ctx):
            try:
                # the `failpoints` session property arms a schedule for
                # this task's whole scope (pull, serde, execution)
                with failpoints.session_scope(session.get("failpoints")):
                    self._run_task(task, body, session, task_ctx)
            except Exception as e:  # noqa: BLE001 - a task's failure is data
                with task.lock:
                    aborted = task.state == "ABORTED"
                    if not aborted:
                        task.state = "FAILED"
                        task.error = f"{type(e).__name__}: {e}"
                    task.finished_at = time.time()
                self._count("tasks_aborted" if aborted else "tasks_failed")
                record_event("task_state", query_id=task.task_id,
                             state="ABORTED" if aborted else "FAILED",
                             error=f"{type(e).__name__}: {e}"[:200])
                event_listeners().task_completed(
                    task.task_id, "ABORTED" if aborted else "FAILED")
            finally:
                # the task's state machine owns its finality: its
                # progress entry ends with it
                with task.lock:
                    state = task.state
                    tstats = dict(task.stats)
                finish_task(task.task_id, state)
                emit_span(trace_id, f"task.{task.task_id}", t_start,
                          time.time(),
                          {"state": state,
                           "rows": tstats.get("outputRows", 0),
                           "bytes": tstats.get("outputBytes", 0)},
                          span_id=task_ctx.span_id,
                          parent_id=ctx.span_id if ctx else None)
                observe_histogram("presto_tpu_task_seconds",
                                  time.time() - t_start, trace_id=trace_id)
        with task.lock:
            task.spans = buf.spans
        if state == "FAILED":
            get_flight_recorder().maybe_dump(task.task_id, "failed")

    def _pull_remote_sources(self, body: dict, codec: PageCodec, task_ctx):
        """The batches of the fragment's RemoteSourceNodes, pulled from
        the upstream tasks, and the pull's seconds, rows, pages and
        decode seconds; one `exchange.fetch` span per source under the
        task's span."""
        from .tracing import emit_span
        from ..types import parse_type
        from .http_exchange import fetch_remote_batch
        pad = (self.mesh.size if self.mesh is not None else 1) * 8
        remote, stats = {}, {"pull_s": 0.0, "rows_in": 0, "pages_in": 0,
                             "page_bytes_in": 0, "decode_s": 0.0}
        for node_id, spec in (body.get("remoteSources") or {}).items():
            t0 = time.perf_counter()
            t_span0 = time.time()
            remote[node_id] = fetch_remote_batch(
                spec["sources"], spec["taskIds"],
                [parse_type(t) for t in spec["types"]], codec,
                pad_multiple=pad, device=self.device,
                buffer_id=int(spec.get("bufferId", 0)),
                ack=bool(spec.get("ack", True)),
                merge_keys=spec.get("mergeKeys"),
                timeout=float(spec.get("timeoutS", 60.0)), stats=stats)
            stats["pull_s"] += time.perf_counter() - t0
            rows_in = int(remote[node_id].active.sum())
            stats["rows_in"] += rows_in
            emit_span(task_ctx.trace_id, "exchange.fetch", t_span0,
                      time.time(),
                      {"node": node_id, "rows": rows_in,
                       "upstreams": len(spec.get("taskIds", []))},
                      parent_id=task_ctx.span_id)
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
            # the replay did no device work: rows and bytes are the
            # original run's, its compile and execute micros are not
            orig = hit["stats"].get("queryStats") or {}
            task.stats = {**{k: v for k, v in hit["stats"].items()
                             if k not in ("queryStats", "runtimeStats")},
                          "queryStats": {
                              "wallUs": 0,
                              "outputRows": int(orig.get("outputRows", 0)),
                              "outputBytes": int(orig.get("outputBytes",
                                                          0)),
                              "taskCount": 1,
                              "counters": {"fragment_cache_replay": 1}},
                          "runtimeStats": {"fragment_cache_replay": 1},
                          "fragmentCacheHit": 1}
            task.state = "FINISHED"
            task.finished_at = time.time()
        self._count("tasks_finished")
        self._count("rows_produced", hit["rows"])
        event_listeners().task_completed(task.task_id, "FINISHED",
                                         hit["rows"])

    def _run_task(self, task: _Task, body: dict, session: dict, task_ctx):
        from ..exec.progress import begin as progress_begin
        from ..exec.runner import run_query
        from ..exec.stats import StageStats
        with task.lock:
            if task.state == "ABORTED":
                return
            task.state = "RUNNING"
        record_event("task_state", query_id=task.task_id, state="RUNNING")
        # the progress entry exists before any failpoint or staging, so
        # a task wedged here still shows, with a stalling age
        progress_begin(task.task_id, kind="task", query=task_ctx.trace_id)
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
        remote, pull = self._pull_remote_sources(body, codec, task_ctx)
        remote_ids = list(remote)
        ckey = None
        if session_flag(session, "fragment_result_cache", True) \
                and not body.get("remoteSources"):
            ckey = FragmentResultCache.key_of(plan, sf, scan_ranges,
                                              out_part, compression)
        if ckey is not None:
            hit = self.fragment_cache.get(ckey)
            record_event("fragment_cache", query_id=task.task_id,
                         hit=hit is not None)
            if hit is not None:
                self._replay(task, hit)
                return
        t0 = time.perf_counter()
        with self._exec_slots:
            # the stage spans hang under this task's span
            res = run_query(plan, sf=sf, device=self.device, mesh=self.mesh,
                            scan_ranges=scan_ranges, remote_sources=remote,
                            memory_pool=self.memory_pool,
                            query_id=task.task_id, session=session,
                            trace_id=task_ctx)
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
        # the exchange's pack and unpack sides are the task's exchange
        # stage, as in the reference
        qs = getattr(res, "query_stats", None)
        if qs is not None:
            ex = StageStats("exchange",
                            wall_us=int((serialize_s + pull["pull_s"]) * 1e6),
                            invocations=1 + len(remote_ids),
                            rows=pull["rows_in"], bytes=total_bytes)
            qs.stages["exchange"] = ex.merge(qs.stages["exchange"]) \
                if "exchange" in qs.stages else ex
            qs.output_bytes = max(qs.output_bytes, total_bytes)
        flat = {**res.stats, "exchange_pull_s": pull["pull_s"],
              "exchange_rows_in": pull["rows_in"],
              "exchange_pages_in": pull["pages_in"],
              "exchange_page_bytes_in": pull["page_bytes_in"],
              "exchange_decode_s": pull["decode_s"],
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
                          "outputBytes": total_bytes,
                          "runtimeStats": flat}
            if qs is not None:
                task.stats["queryStats"] = qs.to_json()
            task.state = "FINISHED"
            task.finished_at = time.time()
        self._count("tasks_finished")
        self._count("rows_produced", res.row_count)
        self._count("exchange_bytes", total_bytes)
        if qs is not None:
            self._count("compile_us", qs.compile_us)
            self._count("execute_us", qs.stage_us("execute"))
        record_event("task_state", query_id=task.task_id, state="FINISHED",
                     rows=res.row_count)
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
            if task.moved_to is not None:
                # migrated by a drain: the consumer goes on at the peer
                # with the same absolute tokens
                raise _MovedError(task.moved_to)
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
            if task.moved_to is not None:
                return  # the pages live at the peer: acks land there
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


# GET /v1/<name>: this process's slice of each ledger, which the
# statement tier merges cluster-wide
_LEDGER_SLICES = ("profile", "datapath", "accuracy", "timeline", "history")


def _ledger_slice(name: str) -> dict:
    if name == "profile":
        from ..exec.profiler import profile_doc
        return profile_doc()
    if name == "datapath":
        from ..exec.datapath import datapath_doc
        return datapath_doc()
    if name == "accuracy":
        from ..exec.accuracy import accuracy_doc
        return accuracy_doc()
    if name == "timeline":
        from ..exec.timeline import timeline_doc
        return timeline_doc()
    from .history import get_history_archive
    return get_history_archive().history_doc()


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
    authenticator = None  # an InternalAuthenticator when a secret is set
    worker_server = None  # the TpuWorkerServer (the drain routes)

    def log_message(self, fmt, *args):  # quiet
        pass

    def _authorized(self) -> bool:
        """With a cluster secret, every route requires a valid internal
        bearer (the InternalAuthenticationFilter analog)."""
        return authorize_request(self, self.authenticator, self._send_json)

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

    def _metric_families(self):
        """The worker's /v1/metrics families, in the reference's order,
        less the two whose sources are not ported (server/metrics.py)."""
        from . import metrics as M
        MF = M.MetricFamily
        m = self.manager
        fams = [
            MF("presto_tpu_active_tasks", "gauge",
               "tasks in PLANNED/RUNNING state").add(m.active_task_count()),
            MF("presto_tpu_memory_reserved_bytes", "gauge",
               "admission pool reserved").add(m.memory_pool.reserved_bytes),
            MF("presto_tpu_memory_capacity_bytes", "gauge",
               "admission pool capacity").add(m.memory_pool.capacity),
            MF("presto_tpu_memory_revoked_bytes", "gauge",
               "bytes freed by spill revocation").add(
                   m.memory_pool.revoked_bytes),
            MF("presto_tpu_memory_peak_bytes", "gauge",
               "admission pool high-water mark").add(
                   m.memory_pool.peak_bytes),
            M.uptime_family(self.started_at, "worker"),
            MF("presto_tpu_fragment_cache_hits_total", "counter",
               "fragment result cache hits").add(m.fragment_cache.hits),
            MF("presto_tpu_fragment_cache_misses_total", "counter",
               "fragment result cache misses").add(m.fragment_cache.misses),
        ]
        with m._counters_lock:
            counters = dict(m.counters)
        for k in sorted(counters):
            if k in ("compile_us", "execute_us"):
                # in seconds, as the coordinator's *_seconds_total
                fams.append(MF(f"presto_tpu_{k[:-3]}_seconds_total",
                               "counter", f"lifetime task {k[:-3]} time")
                            .add(counters[k] / 1e6))
                continue
            fams.append(MF(f"presto_tpu_{k}_total", "counter",
                           f"lifetime {k}").add(counters[k]))
        for build in (M.plan_cache_families, M.narrowing_families,
                      M.batching_families, M.datapath_families,
                      M.accuracy_families, M.suppressed_error_families,
                      M.tracing_families, M.flight_recorder_families,
                      M.failpoint_families, M.timeline_families,
                      M.kernel_audit_families, M.donation_families,
                      M.lock_families, M.query_history_families):
            fams.extend(build())
        # a worker's alive view is itself; its draining gauge its own
        # drain (DRAINED is not DRAINING)
        fams.extend(M.live_introspection_families(workers_alive=1))
        fams.extend(M.fleet_families(
            workers_draining=1 if m.drain_state == "DRAINING" else 0))
        fams.extend(M.histogram_families())
        return fams

    def do_GET(self):  # noqa: N802
        if not self._authorized():
            return
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
        if parts in (["v1", "metrics"], ["v1", "info", "metrics"]):
            # /v1/info/metrics is the legacy alias; exemplars only under
            # an OpenMetrics Accept
            from .metrics import negotiate_exposition, render_prometheus
            om, ctype = negotiate_exposition(self.headers.get("Accept"))
            return self._send_bytes(
                render_prometheus(self._metric_families(), openmetrics=om),
                {"Content-Type": ctype})
        if len(parts) == 2 and parts[0] == "v1" and \
                parts[1] in _LEDGER_SLICES:
            return self._send_json(_ledger_slice(parts[1]))
        if len(parts) == 3 and parts[:2] == ["v1", "trace"]:
            # the spans this process recorded (the coordinator serves
            # the stitched whole)
            from .tracing import get_tracer, trace_doc_of
            doc = trace_doc_of(get_tracer(), parts[2])
            return self._send_json(
                doc if doc else {"error": f"no trace {parts[2]}"},
                200 if doc else 404)
        if parts == ["v1", "worker", "drain"]:
            return self._send_json(self.worker_server.drain_status())
        if parts == ["v1", "status"]:
            pool = m.memory_pool
            # the NodeStatus row of the statement tier's /v1/cluster, in
            # the reference's shape (the flat memory keys for older
            # pollers)
            return self._send_json({
                "nodeId": self.node_id,
                "nodeVersion": {"version": "presto-tpu-0.4"},
                "activeTasks": m.active_task_count(),
                "runningTasks": m.active_task_count(),
                "uptimeSeconds": round(time.time() - self.started_at, 1),
                # the flat state keeps the reference's SHUTTING_DOWN
                # spelling; fleetState is ACTIVE, DRAINING or DRAINED
                "state": "SHUTTING_DOWN" if m.draining else "ACTIVE",
                "fleetState": m.drain_state,
                "unreplayedPages": m.unreplayed_pages(),
                "device": str(m.device),
                "memory": {"reservedBytes": pool.reserved_bytes,
                           "capacityBytes": pool.capacity,
                           "peakBytes": pool.peak_bytes,
                           "revokedBytes": pool.revoked_bytes},
                "memoryReservedBytes": pool.reserved_bytes,
                "memoryCapacityBytes": pool.capacity,
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
                    rows=tstats.get("outputRows", 0),
                    query_stats=tstats.get("queryStats")))
            return self._send_json(task.info())
        if len(parts) == 4 and parts[:2] == ["v1", "task"] and \
                parts[3] == "status":
            task = m.get(parts[2])
            if task is None:
                return self._send_json({"error": "no such task"}, 404)
            from .protocol import task_status_json
            doc = task_status_json(
                parts[2], task.state, f"http://{self.node_id}",
                failures=[task.error] if task.error else None)
            if "application/x-thrift" in self.headers.get("Accept", ""):
                # the reference's thrift transport of the status poll
                from ..serde.thrift import encode_task_status
                return self._send_bytes(
                    encode_task_status(doc, parts[2]),
                    {"Content-Type": "application/x-thrift"})
            return self._send_json(doc)
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
            except _MovedError as e:
                # drained away: the consumer resumes at the adopting peer
                # (WorkerClient.fetch_results follows this header)
                return self._send_bytes(b"", {
                    "X-Presto-Task-Instance-Id": task_id,
                    "X-Presto-Task-Moved": str(e),
                    "X-Presto-Page-Token": str(token),
                    "X-Presto-Page-Next-Token": str(token),
                    "X-Presto-Buffer-Complete": "false"})
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
        if not self._authorized():
            return
        parts = [p for p in self.path.split("/") if p]
        if parts == ["v1", "failpoint"]:
            doc, code = failpoints.admin_post(self._body())
            return self._send_json(doc, code)
        if parts == ["v1", "worker", "drain"]:
            body = self._body()
            timeout_ms = body.get("timeoutMs")
            return self._send_json(self.worker_server.begin_drain(
                migrate_to=body.get("migrateTo"),
                timeout_s=(float(timeout_ms) / 1000.0
                           if timeout_ms is not None else None)))
        if len(parts) == 4 and parts[:2] == ["v1", "task"] and \
                parts[3] == "migrate":
            body = self._body()
            try:
                return self._send_json(
                    self.manager.adopt_task(parts[2], body))
            except RuntimeError as e:  # this worker drains too
                return self._send_json({"error": str(e)}, 503)
        if len(parts) == 3 and parts[:2] == ["v1", "task"]:
            body = self._body()
            if "outputIds" in body or "extraCredentials" in body:
                body, err = _translate_presto_request(body)
                if err is not None:
                    return self._send_json(err, 400)
            try:
                info = self.manager.create_or_update(parts[2], body)
            except RuntimeError as e:  # draining
                return self._send_json({"error": str(e)}, 503)
            return self._send_json(info)
        return self._send_json({"error": f"unknown path {self.path}"}, 404)

    def do_PUT(self):  # noqa: N802  the graceful-shutdown request
        if not self._authorized():
            return
        parts = [p for p in self.path.split("/") if p]
        if parts == ["v1", "info", "state"]:
            body = json.loads(self.rfile.read(int(
                self.headers.get("Content-Length", "0"))) or b'""')
            if str(body).upper().replace('"', "") == "SHUTTING_DOWN":
                # GracefulShutdownHandler: refuse new tasks, finish the
                # running ones
                self.manager.drain()
                return self._send_json({"state": "SHUTTING_DOWN"})
            return self._send_json({"error": f"unknown state {body}"}, 400)
        return self._send_json({"error": f"unknown path {self.path}"}, 404)

    def do_DELETE(self):  # noqa: N802
        if not self._authorized():
            return
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
    every `announce_interval_s`. `shared_secret` requires the internal
    bearer on every route and carries it on the drain's migration hop;
    `tls=(cert, key)` serves https."""

    def __init__(self, port: int = 0, sf: float = 0.01, mesh=None,
                 device=None, node_id: Optional[str] = None,
                 discovery_url: Optional[str] = None,
                 announce_interval_s: float = 1.0,
                 shared_secret: Optional[str] = None,
                 task_concurrency: int = 4,
                 tls: Optional[tuple] = None):
        # task threads log under the propagated trace context
        from ..utils.log import ensure_log_context
        ensure_log_context()
        self.manager = TaskManager(sf=sf, mesh=mesh, device=device,
                                   task_concurrency=task_concurrency)
        self.node_id = node_id or f"tpu-worker-{uuid.uuid4().hex[:8]}"
        handler = type("BoundHandler", (_Handler,), {
            "manager": self.manager, "node_id": self.node_id,
            "started_at": time.time(),
            "authenticator": make_authenticator(shared_secret, self.node_id),
            "worker_server": self})
        self.httpd = ThreadingHTTPServer(("127.0.0.1", port), handler)
        scheme = "http"
        if tls is not None:
            from .tls import server_context
            self.httpd.socket = server_context(*tls).wrap_socket(
                self.httpd.socket, server_side=True)
            scheme = "https"
        self.port = self.httpd.server_address[1]
        self.url = f"{scheme}://127.0.0.1:{self.port}"
        # a new worker on this url supersedes a drained predecessor's
        # goodbye
        from .discovery import clear_unannounced
        clear_unannounced(self.url)
        self._shared_secret = shared_secret  # the migration hop's
        self._drain_lock = OrderedLock("worker.TpuWorkerServer._drain_lock")
        self._drain_thread: Optional[threading.Thread] = None
        self._drain_migrated = 0
        self._stop_drain = threading.Event()
        from .watchdog import StuckProgressWatchdog
        self._watchdog = StuckProgressWatchdog(
            self.manager._stuck_candidates, tier="worker")
        self._announcer = None
        if discovery_url:
            from .discovery import Announcer
            self._announcer = Announcer(discovery_url, self.node_id,
                                        self.url,
                                        interval_s=announce_interval_s,
                                        shared_secret=shared_secret)

    def start(self):
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()
        self._watchdog.start()
        if self._announcer:
            self._announcer.start()
        return self

    def stop(self, unannounce: bool = True):
        """Stop serving; `unannounce` False is a crash, not a goodbye:
        discovery notices only when the announcement ages out."""
        self._stop_drain.set()  # releases a waiting drain thread
        if self._announcer:
            self._announcer.stop(unannounce=unannounce)
        self._watchdog.stop()
        self.httpd.shutdown()
        self.httpd.server_close()

    # -- graceful drain (POST /v1/worker/drain) ---------------------------

    def begin_drain(self, migrate_to: Optional[str] = None,
                    timeout_s: Optional[float] = None) -> dict:
        """Start the drain (idempotent): refuse new tasks, announce
        DRAINING at once, then on a thread of its own wait for the
        running tasks, migrate the buffered pages to `migrate_to` (if
        given) and unannounce once no unreplayed page is left. Past the
        budget `timeout_s` (the drain_timeout_ms session property's
        default when None) it keeps waiting at a slower pace, and the
        pages stay served here until consumed."""
        with self._drain_lock:
            already = self._drain_thread is not None
            if not already:
                self.manager.drain()
                if self._announcer is not None:
                    self._announcer.set_state("DRAINING")
                self._drain_thread = threading.Thread(
                    target=self._drain, args=(migrate_to, timeout_s),
                    name=f"drain-{self.node_id}", daemon=True)
        if already:
            return self.drain_status()
        if self._announcer is not None:
            try:
                # placement reacts now, not at the next interval
                self._announcer.announce_once()
            except Exception as e:  # noqa: BLE001 - discovery may be
                # down; the drain goes on, counted
                from .metrics import record_suppressed
                record_suppressed("worker", "drain_announce", e)
        self._drain_thread.start()
        return self.drain_status()

    def _drain(self, migrate_to: Optional[str],
               timeout_s: Optional[float]) -> None:
        if timeout_s is None:
            from ..utils.config import SESSION_PROPERTIES
            timeout_s = float(SESSION_PROPERTIES.properties[
                "drain_timeout_ms"].default) / 1e3
        deadline = time.time() + max(float(timeout_s), 0.0)
        # 1. the running tasks finish (only new ones are refused)
        while time.time() < deadline and \
                self.manager.active_task_count() > 0:
            time.sleep(0.05)
        # 2. the buffered pages move to the peer
        moved = 0
        try:
            if failpoints.ARMED:
                # delay/hang: a drain stuck behind a slow peer; error: a
                # migration hop that dies (the pages stay served here)
                failpoints.hit("worker.drain_stall")
            if migrate_to:
                moved = self.manager.migrate_buffers(
                    migrate_to, secret=self._shared_secret)
        except Exception as e:  # noqa: BLE001 - a failed migration
            # degrades the drain to serving until consumed, never to a
            # lost page; counted, and on the flight recorder's timeline
            from .metrics import record_suppressed
            record_suppressed("worker", "drain_migrate", e)
            record_event("drain_migrate_failed", node=self.node_id,
                         error=f"{type(e).__name__}: {e}"[:200])
        with self._drain_lock:
            self._drain_migrated = moved
        # 3. unannounce only once no page is left; past the budget keep
        # waiting, slower, so a slow consumer cannot wedge the node
        exhausted = False
        while self.manager.unreplayed_pages() > 0 or \
                self.manager.active_task_count() > 0:
            if not exhausted and time.time() >= deadline:
                exhausted = True
            if self._stop_drain.wait(0.25 if exhausted else 0.05):
                return  # the server stops: the state stays as it is
        self.manager.mark_drained()
        if self._announcer is not None:
            self._announcer.stop(unannounce=True)
        # a cluster of explicit urls has no announcer: the goodbye
        # registry still drops this node
        from .discovery import note_unannounced
        note_unannounced(self.url)

    def drain_status(self) -> dict:
        """The drain's document (POST and GET /v1/worker/drain): its
        state and the page accounting (a DRAINED worker reports zero
        unreplayed pages)."""
        m = self.manager
        with self._drain_lock:
            migrated = self._drain_migrated
        with m._counters_lock:
            adopted = m.counters.get("tasks_adopted", 0)
        return {"nodeId": self.node_id, "state": m.drain_state,
                "activeTasks": m.active_task_count(),
                "unreplayedPages": m.unreplayed_pages(),
                "migratedPages": migrated, "adoptedTasks": adopted}
