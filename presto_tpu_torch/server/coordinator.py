"""Coordinator: schedule plan fragments across HTTP workers.

Counterpart of presto_tpu/server/coordinator.py
(SqlQueryScheduler.start:397/schedule:414, NodeScheduler's split
placement, HttpRemoteTaskWithEventLoop.sendUpdate:981). A plan is cut
at its REMOTE exchanges (plan/fragment.py::fragment_plan) and the
fragments run bottom-up over the workers of an explicit list or of
the discovery service:

  * a leaf fragment's table scans are range-split across its tasks
    (SOURCE_DISTRIBUTION), one range per task;
  * a HASH-partitioned fragment writes one output buffer per consumer
    task, and each consumer pulls its buffer from every producer;
  * a SINGLE or SORTED (merge) upstream feeds one consumer task,
    BROADCAST upstreams every consumer;
  * shapes a fan-out cannot run correctly degrade to one task;
  * writers scale with the estimated rows, a TableFinish runs once;
  * a failed task is aborted and resubmitted on another live worker,
    re-running dead upstream producers first; a straggler past the
    speculation threshold gets one speculative copy, first result
    wins.

`execute` returns the last fragment's rows as (values, nulls) per
column and the names. The coordinator is host-only: it runs no
kernel. Each query runs under one trace (the caller's `trace_ctx`, else
a fresh `query.<id>` one): a `coordinator.execute` span, one
`fragment.f<id>` span per fragment under it, and each task's body
carries its fragment's span as `traceparent`, so the workers' task
spans hang under it. At the end the coordinator pulls every produced
task's final status, stitches the spans the workers shipped into the
process tracer and folds their QueryStats into one by the merge law
(`last_query_stats`); `last_task_stats` keeps each task's own stats
document. The workers' live progress, riding every status poll, folds
into this process's progress registry under the query's trace id.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import failpoints
from ..connectors import catalog
from ..plan import fragment_plan, nodes as N
from ..serde import PageCodec
from ..utils.backoff import Backoff
from .client import WorkerClient
from .discovery import alive_nodes
from .flight_recorder import record_event
from .metrics import record_suppressed
from .tracing import TraceContext, emit_span, new_span_id, trace_context
from ..utils.locks import OrderedLock

__all__ = ["Coordinator", "speculation_totals", "reset_speculation_totals"]

# speculative attempts launched, won (the copy finished first) and
# lost (the original did), process-wide
_SPEC_LOCK = OrderedLock("coordinator._SPEC_LOCK")
_SPEC = {"launched": 0, "wins": 0, "losses": 0}

ENV_SPECULATION_MS = "PRESTO_TPU_SPECULATION_MS"


def speculation_totals() -> dict:
    with _SPEC_LOCK:
        return dict(_SPEC)


def reset_speculation_totals() -> None:
    with _SPEC_LOCK:
        _SPEC.update({"launched": 0, "wins": 0, "losses": 0})


def _count_spec(key: str) -> None:
    with _SPEC_LOCK:
        _SPEC[key] += 1


def _quiet_abort(url: str, tid: str, timeout: float) -> None:
    """Best-effort DELETE (the worker may be the dead one); the task's
    live progress entry here ends with it."""
    from ..exec.progress import finish_task
    try:
        WorkerClient(url, timeout).abort(tid)
    except Exception as e:  # noqa: BLE001 - cleanup never fails a query
        record_suppressed("coordinator", "task_cleanup", e)
    finish_task(tid, "ABORTED")


class Coordinator:
    def __init__(self, worker_urls: Optional[Sequence[str]] = None,
                 discovery_url: Optional[str] = None,
                 prober=None,
                 writer_min_rows_per_task: int = 1 << 20,
                 ttl_horizon_s: float = 60.0,
                 speculation_threshold_ms: Optional[float] = None):
        """`prober`: a discovery.HeartbeatProber; workers it marks
        failed take no tasks and no retries. `writer_min_rows_per_task`:
        a writer fragment gets ceil(estimated rows / this) tasks, capped
        by the cluster (scaled writers). `ttl_horizon_s`: a node whose
        announced ttlEpochSeconds falls within this many seconds takes
        no new task (it would take a running query down with it; 0 is
        off). `speculation_threshold_ms`: a
        task still running this long gets one speculative copy on
        another worker (None: the session property
        speculative_execution_threshold_ms, else the
        PRESTO_TPU_SPECULATION_MS environment variable; 0 is off)."""
        assert worker_urls or discovery_url
        self._urls = list(worker_urls) if worker_urls else None
        self.discovery_url = discovery_url
        self.prober = prober
        self.writer_min_rows_per_task = max(1, writer_min_rows_per_task)
        self.ttl_horizon_s = ttl_horizon_s
        self.speculation_threshold_ms = speculation_threshold_ms
        # each task's stats document, and their merged QueryStats, of
        # this thread's last execute()
        self._stats_tls = threading.local()

    @property
    def last_task_stats(self) -> Optional[List[dict]]:
        """[{fragment, task, url, stats}] of this thread's last
        execute(), the tasks whose results were used, in fragment
        order."""
        return getattr(self._stats_tls, "stats", None)

    @property
    def last_query_stats(self):
        """The QueryStats of this thread's last execute(): every
        produced task's folded by the merge law (None when no task
        shipped one)."""
        return getattr(self._stats_tls, "query_stats", None)

    def _speculation_ms(self, session=None) -> float:
        raw = None
        if session is not None:
            raw = session.get("speculative_execution_threshold_ms")
        if raw in (None, ""):
            raw = self.speculation_threshold_ms
        if raw in (None, ""):
            raw = os.environ.get(ENV_SPECULATION_MS, "0")
        try:
            return max(float(raw), 0.0)
        except (TypeError, ValueError):
            return 0.0

    def workers(self) -> List[str]:
        if self._urls:
            urls = self._urls
        else:
            nodes = alive_nodes(self.discovery_url)
            assert nodes, "no alive workers in discovery"
            # a DRAINING node stays announced while its pages are served
            # or migrated, but takes no new task; never filter down to
            # an empty cluster
            nodes = [n for n in nodes
                     if str(n.get("state", "ACTIVE")).upper()
                     != "DRAINING"] or nodes
            if self.ttl_horizon_s:
                # TTL-aware placement: no new task on a node that leaves
                # within the horizon; never filter down to nothing
                cutoff = time.time() + self.ttl_horizon_s
                nodes = [n for n in nodes
                         if n.get("ttlEpochSeconds") is None
                         or float(n["ttlEpochSeconds"]) > cutoff] or nodes
            urls = [n["uri"] for n in nodes]
        if self.prober is not None:
            healthy = set(self.prober.healthy())
            filtered = [u for u in urls if u.rstrip("/") in healthy]
            if filtered:  # never filter down to nothing
                urls = filtered
        return urls

    def _retry_urls(self, fallback: List[str]) -> List[str]:
        """The freshest healthy workers for a retry (`fallback` when
        discovery or the prober cannot answer)."""
        try:
            return self.workers() or list(fallback)
        except Exception:  # noqa: BLE001
            return list(fallback)

    def _submit(self, urls: List[str], preferred: int, task_id: str,
                body: dict, timeout: float) -> Tuple[str, str, int]:
        """Submit without waiting, failing over to the next worker on
        a submission error after a seeded backoff. Returns (url, task
        id, attempts)."""
        last_err = None
        backoff = Backoff(base_s=0.02, cap_s=0.5, seed=task_id)
        for attempt in range(len(urls)):
            if attempt:
                backoff.sleep()
            url = urls[(preferred + attempt) % len(urls)]
            tid = task_id if attempt == 0 else f"{task_id}.s{attempt}"
            try:
                if failpoints.ARMED:
                    failpoints.hit("task.submit")
                WorkerClient(url, timeout).submit_body(tid, body)
                return url, tid, attempt + 1
            except Exception as e:  # noqa: BLE001 - dead worker: next
                last_err = f"{type(e).__name__}: {e}"
        raise RuntimeError(
            f"task {task_id} could not be submitted anywhere: {last_err}")

    def _wait_speculative(self, urls: List[str], url: str, tid: str,
                          body: dict, timeout: float, submitted,
                          register, key, spec_ms: float):
        """Poll one task to a terminal state. With `spec_ms` > 0, once
        the original has run that long one copy goes to another worker
        under a `.spec` id; the first FINISHED attempt wins and every
        other is aborted, so exactly one attempt's buffers feed the
        consumers. Returns (info, url, task id) of the winner, or of the
        last attempt standing."""
        deadline = time.time() + timeout
        started = time.time()
        poll_to = min(timeout, 2.0) if spec_ms > 0 else timeout
        attempts = [(url, tid, WorkerClient(url, poll_to))]
        spec_tried = spec_ms <= 0 or len(urls) < 2
        launched_spec = False
        last = None
        poll_fails: Dict[str, int] = {}
        while time.time() < deadline:
            for u, t, client in list(attempts):
                try:
                    info = client.task_info(t)
                    client._note_progress(t, info)
                    poll_fails[t] = 0
                except Exception:  # noqa: BLE001 - attempt unreachable
                    if len(attempts) == 1:
                        raise  # the sole attempt: the retry ladder's case
                    # three misses in a row: that worker is gone
                    poll_fails[t] = poll_fails.get(t, 0) + 1
                    if poll_fails[t] >= 3:
                        attempts.remove((u, t, client))
                        _quiet_abort(u, t, poll_to)
                    continue
                state = info.get("state")
                if state == "FINISHED":
                    race = len(attempts) > 1
                    for lu, lt, _lc in attempts:
                        if lt != t:
                            _quiet_abort(lu, lt, poll_to)
                    if t != tid and race:
                        _count_spec("wins")
                        record_event("speculative_win", task=tid,
                                     attempt=t)
                    elif t == tid and race and launched_spec:
                        _count_spec("losses")
                        record_event("speculative_loss", task=tid)
                    return info, u, t
                if state in ("FAILED", "ABORTED"):
                    if len(attempts) == 1:
                        return info, u, t  # the retry ladder takes over
                    attempts.remove((u, t, client))
                    last = (info, u, t)
            if not attempts:
                return last if last is not None else (
                    {"state": "FAILED", "error": "no attempt survived"},
                    url, tid)
            if not spec_tried and \
                    (time.time() - started) * 1000.0 >= spec_ms:
                spec_tried = True  # one speculative copy per task
                cand = [c for c in self._retry_urls(urls)
                        if c.rstrip("/") != url.rstrip("/")]
                try:
                    if cand:
                        su, st, _ = self._submit(cand, 0, f"{tid}.spec",
                                                 body, timeout)
                        launched_spec = True
                        _count_spec("launched")
                        record_event("speculative_submit", task=tid,
                                     attempt=st, worker=su)
                        if register is not None:
                            register(st, key)
                        submitted.append((su, st))
                        attempts.append((su, st, WorkerClient(su, poll_to)))
                except Exception as e:  # noqa: BLE001 - nowhere to
                    # speculate: the original keeps running
                    record_suppressed("coordinator", "speculative_submit",
                                      e)
            time.sleep(0.02)
        raise TimeoutError(f"task {tid} still not terminal after "
                           f"{timeout}s")

    def _await_or_retry(self, urls: List[str], pending, body_of,
                        timeout: float, submitted, recover=None,
                        register=None, spec_ms: float = 0.0):
        """Wait for the submitted tasks (all run at once). A task that
        fails is aborted and resubmitted elsewhere, after its dead
        upstream producers re-run (`recover`): splits are
        deterministic, so any attempt can re-run. `pending`: (key, url,
        task id, preferred worker). Returns {key: (url, task id)}."""
        done = {}
        for key, url, tid, preferred in pending:
            retries_left = len(urls)
            last_err = None
            backoff = Backoff(base_s=0.05, cap_s=1.0, seed=tid)
            while True:
                try:
                    if failpoints.ARMED:
                        failpoints.hit("task.status")
                    info, url, tid = self._wait_speculative(
                        urls, url, tid, body_of(key), timeout,
                        submitted, register, key, spec_ms)
                    if info["state"] == "FINISHED":
                        done[key] = (url, tid)
                        break
                    last_err = info.get("error")
                except Exception as e:  # noqa: BLE001
                    last_err = f"{type(e).__name__}: {e}"
                _quiet_abort(url, tid, timeout)
                if retries_left <= 0:
                    raise RuntimeError(
                        f"task {tid} failed everywhere: {last_err}")
                retries_left -= 1
                body = body_of(key)
                if recover is not None:
                    recover(body)
                backoff.sleep()
                url, tid, _ = self._submit(
                    self._retry_urls(urls),
                    preferred + (len(urls) - retries_left),
                    f"{tid}.r", body, timeout)
                if register is not None:
                    register(tid, key)
                submitted.append((url, tid))
        return done

    def execute(self, root: N.PlanNode, sf: float = 0.01,
                timeout: float = 120.0, policy: str = "phased",
                session=None, trace_ctx: Optional[TraceContext] = None):
        """Run a (possibly multi-fragment) plan. Returns (cols, names):
        (values, nulls) per output column of the final tasks.

        `policy` (the ExecutionPolicy analog): "phased" runs stages
        bottom-up, waiting for each, and every task can be retried on
        another worker; "all_at_once" submits every stage's tasks at
        once under predicted task ids, consumers waiting for their
        upstreams inside the worker, and a failed task fails the
        query. `session` is sent with every task. `trace_ctx` joins
        the query to a caller's trace (the statement tier's query
        span)."""
        workers = self.workers()
        fragments = fragment_plan(root)
        qid = uuid.uuid4().hex[:8]
        trace_id = trace_ctx.trace_id if trace_ctx is not None \
            else f"query.{qid}"
        exec_ctx = TraceContext(trace_id, new_span_id())
        t_exec0 = time.time()
        produced: Dict[int, List[Tuple[str, str]]] = {}
        # every task this query submitted, failed attempts included:
        # all are aborted at the end
        submitted: List[Tuple[str, str]] = []
        self._stats_tls.stats = None
        self._stats_tls.query_stats = None
        try:
            # every request this thread makes carries the trace
            with trace_context(exec_ctx):
                return self._execute_fragments(
                    workers, fragments, produced, submitted, qid, sf,
                    timeout, policy, dict(session or {}),
                    self._speculation_ms(session), exec_ctx)
        finally:
            # stitch before the cleanup drops the workers' tasks, on a
            # failure too (the failed query is the one to trace)
            with trace_context(exec_ctx):
                docs = _task_stats(fragments, produced, min(timeout, 5.0))
            self._stats_tls.stats = docs
            self._stats_tls.query_stats = _merge_stitch(docs, trace_id)
            emit_span(trace_id, "coordinator.execute", t_exec0, time.time(),
                      {"fragments": len(fragments), "policy": policy,
                       "workers": len(workers)},
                      span_id=exec_ctx.span_id,
                      parent_id=trace_ctx.span_id if trace_ctx else None)
            # the buffers of a finished query are freed with its tasks
            for url, tid in submitted:
                _quiet_abort(url, tid, min(timeout, 5.0))

    def _execute_fragments(self, workers, fragments, produced, submitted,
                           qid, sf, timeout, policy, session, spec_ms,
                           exec_ctx: TraceContext):
        trace_id = exec_ctx.trace_id
        # one span per fragment (under coordinator.execute); its tasks
        # hang under it through the traceparent of their bodies
        frag_spans: Dict[int, Tuple[str, float]] = {}

        def close_fragment(fid: int, tasks: int) -> None:
            sid, t_f0 = frag_spans[fid]
            emit_span(trace_id, f"fragment.f{fid}", t_f0, time.time(),
                      {"tasks": tasks,
                       "partitioning": frag_by_id[fid].partitioning},
                      span_id=sid, parent_id=exec_ctx.span_id)

        frag_by_id = {f.id: f for f in fragments}
        parent_of: Dict[int, int] = {}
        for f in fragments:
            for src_id in f.remote_sources:
                parent_of[src_id] = f.id
        ntasks_of = {f.id: self._task_count(f, frag_by_id, len(workers), sf)
                     for f in fragments}

        # every task's (fragment, index) and body, so that a dead
        # FINISHED producer can re-run on demand
        bodies_by_frag: Dict[int, Dict[int, dict]] = {}
        origin: Dict[str, Tuple[int, int]] = {}

        def recover_upstreams(body: dict) -> None:
            """Re-run the upstream producers of `body` that are gone or
            failed (their own dead upstreams first) and rewire its
            remoteSources in place."""
            for entry in (body.get("remoteSources") or {}).values():
                for i, (src, tid) in enumerate(
                        zip(list(entry["sources"]), list(entry["taskIds"]))):
                    try:
                        state = WorkerClient(
                            src, min(timeout, 5.0)).task_info(tid)["state"]
                        if state in ("FINISHED", "PLANNED", "RUNNING"):
                            continue  # its pages are or will be there
                    except Exception:  # noqa: BLE001 - a dead worker:
                        pass  # re-run the producer below
                    if tid not in origin:
                        continue
                    fid, w = origin[tid]
                    ubody = bodies_by_frag[fid][w]
                    recover_upstreams(ubody)
                    rurls = [u for u in self._retry_urls(workers)
                             if u != src] or self._retry_urls(workers)
                    uurl, utid, _ = self._submit(rurls, w, f"{tid}.u",
                                                 ubody, timeout)
                    origin[utid] = (fid, w)
                    submitted.append((uurl, utid))
                    uinfo = WorkerClient(uurl, timeout).wait(utid, timeout)
                    if uinfo["state"] != "FINISHED":
                        raise RuntimeError(
                            f"re-run upstream {utid} at {uurl} is "
                            f"{uinfo['state']}: {uinfo.get('error')}")
                    entry["sources"][i] = uurl
                    entry["taskIds"][i] = utid
                    if w < len(produced.get(fid, ())):
                        produced[fid][w] = (uurl, utid)

        all_pending = []
        if policy == "all_at_once":
            # predicted placement: consumers name their upstream tasks
            # before those finish
            for frag in fragments:
                produced[frag.id] = [
                    (workers[w % len(workers)], f"{qid}.f{frag.id}.w{w}")
                    for w in range(ntasks_of[frag.id])]

        bodies: Dict[int, dict] = {}
        for frag in fragments:
            # placement follows the live workers per fragment; the task
            # COUNT was fixed above, and all_at_once keeps its
            # predicted placement
            placement = workers if policy == "all_at_once" \
                else self._retry_urls(workers)
            frag_plan = frag.root if isinstance(frag.root, N.OutputNode) \
                else N.OutputNode(frag.root, [
                    f"c{i}" for i in range(len(frag.root.output_types()))])
            remote_nodes = _collect(frag.root, N.RemoteSourceNode)
            scans = _collect(frag.root, N.TableScanNode)
            out_part = None
            if frag.partitioning == "HASH":
                # one output buffer per consumer task
                out_part = {"count": ntasks_of.get(parent_of.get(frag.id,
                                                                 -1), 1),
                            "channels": frag.partition_channels}
            ntasks = ntasks_of[frag.id]
            bodies = {}
            pending = []
            plan_json = N.to_json(frag_plan)
            frag_spans[frag.id] = (new_span_id(), time.time())
            traceparent = TraceContext(trace_id,
                                       frag_spans[frag.id][0]).header()
            for w in range(ntasks):
                body = {"plan": plan_json, "sf": sf, "session": session,
                        "traceparent": traceparent}
                if out_part:
                    body["outputPartitions"] = out_part
                if scans:
                    ranges = {}
                    for s in scans:
                        total = catalog(s.connector).table_row_count(
                            s.table, sf)
                        lo = total * w // ntasks
                        ranges[s.id] = [lo, total * (w + 1) // ntasks - lo]
                    body["scanRanges"] = ranges
                if remote_nodes:
                    body["remoteSources"] = {
                        rn.id: self._remote_entry(
                            rn, frag_by_id[rn.fragment_id],
                            produced[rn.fragment_id], w, ntasks, timeout)
                        for rn in remote_nodes}
                bodies[w] = body
                if policy == "all_at_once":
                    # exactly the predicted (url, id): consumers hold it
                    url, tid = produced[frag.id][w]
                    WorkerClient(url, timeout).submit_body(tid, body)
                    submitted.append((url, tid))
                    all_pending.append((url, tid))
                    continue
                url, tid, _ = self._submit(placement, w,
                                           f"{qid}.f{frag.id}.w{w}",
                                           body, timeout)
                origin[tid] = (frag.id, w)
                submitted.append((url, tid))
                pending.append((w, url, tid, w))
            bodies_by_frag[frag.id] = bodies
            if policy == "all_at_once":
                continue
            done = self._await_or_retry(
                placement, pending, lambda k, b=bodies: b[k], timeout,
                submitted, recover=recover_upstreams,
                register=lambda tid, k, f=frag.id: origin.__setitem__(
                    tid, (f, k)),
                spec_ms=spec_ms)
            produced[frag.id] = [done[w] for w in sorted(done)]
            close_fragment(frag.id, len(done))

        for url, tid in all_pending:
            info = WorkerClient(url, timeout).wait(tid, timeout)
            if info["state"] != "FINISHED":
                raise RuntimeError(
                    f"all_at_once task {tid} at {url} is "
                    f"{info['state']}: {info.get('error')}")
        if policy == "all_at_once":
            # the stages overlapped: their spans close together
            for frag in fragments:
                close_fragment(frag.id, len(produced[frag.id]))

        # the final tasks' buffers, one after another (a hash-
        # distributed root fragment returns disjoint slices)
        t_pull0 = time.time()
        last = fragments[-1]
        types = last.root.output_types()
        compression = session.get("exchange_compression", "none")
        codec = PageCodec(None if compression == "none" else compression)
        all_cols: List[List] = [[] for _ in types]
        for w, (url, tid) in enumerate(list(produced[last.id])):
            try:
                if failpoints.ARMED:
                    failpoints.hit("task.result")
                cols = WorkerClient(url, timeout).fetch_results(tid, types,
                                                                codec)
            except Exception:  # noqa: BLE001
                # the producer died between finishing and the pull:
                # re-run that final task on a live worker
                retry = self._retry_urls(workers)
                recover_upstreams(bodies[w])
                url, tid, _ = self._submit(retry, w + 1, f"{tid}.rf",
                                           bodies[w], timeout)
                submitted.append((url, tid))
                done = self._await_or_retry(
                    retry, [(w, url, tid, w + 1)], lambda k: bodies[k],
                    timeout, submitted, recover=recover_upstreams,
                    spec_ms=spec_ms)
                url, tid = done[w]
                produced[last.id][w] = (url, tid)
                cols = WorkerClient(url, timeout).fetch_results(tid, types,
                                                                codec)
            for c in range(len(types)):
                if len(cols[c][0]):
                    all_cols[c].append(cols[c])
        merged = []
        for c, ty in enumerate(types):
            if all_cols[c]:
                merged.append((np.concatenate([v for v, _ in all_cols[c]]),
                               np.concatenate([m for _, m in all_cols[c]])))
            else:
                merged.append((np.array([], dtype=object if ty.is_string
                                        else ty.to_dtype()),
                               np.array([], dtype=bool)))
        names = last.root.names if isinstance(last.root, N.OutputNode) \
            else [f"c{i}" for i in range(len(types))]
        emit_span(trace_id, "coordinator.fetch_results", t_pull0,
                  time.time(),
                  {"tasks": len(produced[last.id]),
                   "rows": len(merged[0][0]) if merged else 0},
                  parent_id=exec_ctx.span_id)
        return merged, names

    @staticmethod
    def _remote_entry(rn: N.RemoteSourceNode, up, ups, w: int,
                      ntasks: int, timeout: float) -> dict:
        """Consumer task w's pull of one RemoteSourceNode. Pulls are not
        destructive (ack false): a retried consumer re-reads, and the
        buffers go with their task."""
        entry = {"sources": [u for u, _ in ups],
                 "taskIds": [t for _, t in ups],
                 "types": [str(t) for t in rn.types],
                 "ack": False, "timeoutS": timeout}
        if up.partitioning == "SORTED":
            # the consumer k-way merges the sorted upstream streams
            entry["mergeKeys"] = [list(k) for k in up.sort_keys]
        if up.partitioning == "HASH":
            entry["bufferId"] = w
        elif up.partitioning in ("SINGLE", "SORTED") and ntasks > 1 \
                and w > 0:
            # a gathered upstream feeds exactly one of the consumers
            entry["sources"], entry["taskIds"] = [], []
        return entry

    def _task_count(self, frag, frag_by_id, nworkers: int, sf: float) -> int:
        """Tasks of one fragment. A fan-out that would be wrong
        degrades to one task: a commit point; a global aggregation; a
        scan fragment fed by a gathered upstream, or by a HASH one
        into a join; a grouped final aggregation, distinct or window
        over range-split scans; a join of two inline scans; a join fed
        by a gathered upstream. Otherwise one task per worker where
        the fragment scans or reads a HASH upstream; a writer scales
        with its estimated rows."""
        root = frag.root
        remote_nodes = _collect(root, N.RemoteSourceNode)
        scans = _collect(root, N.TableScanNode)
        hash_ups = [rn for rn in remote_nodes
                    if frag_by_id[rn.fragment_id].partitioning == "HASH"]
        single_ids = {rn.fragment_id for rn in remote_nodes
                      if frag_by_id[rn.fragment_id].partitioning
                      in ("SINGLE", "SORTED")}
        has_join = bool(_collect(root, (N.JoinNode, N.SemiJoinNode)))
        commit = bool(_collect(root, (N.TableFinishNode, N.DdlNode,
                                      N.TableRewriteNode)))
        if commit or (scans and single_ids) or _contains_global_agg(root) \
                or (scans and hash_ups and has_join) \
                or (scans and _contains_global_view(root)) \
                or (len(scans) > 1 and has_join) \
                or (has_join and single_ids
                    and _join_fed_by_single(root, single_ids)):
            n = 1
        else:
            n = nworkers if (scans or hash_ups) else 1
        if _collect(root, N.TableWriterNode) and not commit:
            from ..plan.stats import estimate_rows
            est = estimate_rows(root, sf)
            if est is not None:
                scale = -(-int(est) // self.writer_min_rows_per_task)
                n = max(1, min(n, scale))
        return n


def _task_stats(fragments, produced, timeout: float) -> List[dict]:
    """Each produced task's stats document and the spans it shipped,
    best effort. A worker pins the spans a beat after it flips the task
    terminal: one short re-poll closes that window."""
    out = []
    for frag in fragments:
        for url, tid in produced.get(frag.id, ()):
            client = WorkerClient(url, timeout)
            try:
                info = client.task_info(tid)
                if not info.get("spans") and \
                        info.get("state") in ("FINISHED", "FAILED"):
                    time.sleep(0.05)
                    info = client.task_info(tid)
            except Exception as e:  # noqa: BLE001 - a worker that is gone
                record_suppressed("coordinator", "stats_stitch", e)
                continue
            out.append({"fragment": frag.id, "task": tid, "url": url,
                        "stats": info.get("stats") or {},
                        "spans": info.get("spans") or []})
    return out


def _merge_stitch(docs: List[dict], trace_id: str):
    """The tasks' QueryStats folded into one (None when none shipped
    one), and their spans stitched into the process tracer under
    `trace_id` (add_spans drops spans it already has, so a worker that
    shares this process's tracer delivers safely twice)."""
    from ..exec.stats import QueryStats
    from .tracing import get_tracer
    merged = None
    tracer = get_tracer()
    for d in docs:
        qs_doc = d["stats"].get("queryStats")
        if qs_doc:
            qs = QueryStats.from_json(qs_doc)
            merged = qs if merged is None else merged.merge(qs)
        if tracer is not None and d["spans"]:
            tracer.add_spans(trace_id, d["spans"])
    return merged


def _collect(node: N.PlanNode, kinds) -> List[N.PlanNode]:
    out = [node] if isinstance(node, kinds) else []
    for s in node.sources:
        out.extend(_collect(s, kinds))
    return out


def _contains_global_agg(node: N.PlanNode) -> bool:
    """A keyless FINAL or SINGLE aggregation emits one row always:
    fanned-out tasks would each emit it."""
    return any(not a.group_channels and a.step in ("FINAL", "SINGLE")
               for a in _collect(node, N.AggregationNode))


def _contains_global_view(node: N.PlanNode) -> bool:
    """Operators that must see every row of a key or partition at once.
    A partial TopN, Limit or Sort is not one: its consumer reapplies
    it over the gathered stream."""
    if isinstance(node, N.AggregationNode) and node.group_channels \
            and node.step in ("SINGLE", "FINAL"):
        return True
    if isinstance(node, (N.DistinctNode, N.MarkDistinctNode,
                         N.WindowNode, N.RowNumberNode)):
        return True
    return any(_contains_global_view(s) for s in node.sources)


def _join_fed_by_single(node: N.PlanNode, single_ids) -> bool:
    """A join of this fragment fed, below it, by a gathered remote
    source."""
    if isinstance(node, (N.JoinNode, N.SemiJoinNode)) and any(
            rn.fragment_id in single_ids
            for rn in _collect(node, N.RemoteSourceNode)):
        return True
    return any(_join_fed_by_single(s, single_ids) for s in node.sources)
