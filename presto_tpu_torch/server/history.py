"""Query history archive + in-engine perf regression sentinel.

Counterpart of presto_tpu/server/history.py (same records, sentinel
and documents); the ring persists only under a directory the caller
names (``history_dir`` or ``PRESTO_TPU_HISTORY_DIR``).

The SENTINEL rides every append: each FINISHED query's metric vector
(wall / execute / staged bytes / peak memory) is compared against a
rolling per-fingerprint baseline (median + MAD noise bands,
``min_samples`` warmup -- exec/perfgate.py). On breach it

  * bumps ``presto_tpu_perf_regressions_total{metric}`` (both tiers'
    ``/v1/metrics`` via :func:`query_history_families`),
  * drops a ``perf_regression`` event on the flight-recorder timeline,
  * and triggers an auto flight dump keyed by the query id, its header
    cross-linking the trace id --

so a 2x latency or staged-bytes drift is caught in-engine at the
moment it happens, not in a notebook a week later. Failed queries are
archived but never folded into baselines (a crash is not a latency
sample) and never gated (they already dumped as ``failed``).

The archive is process-wide like the flight recorder next door; swap
it with :func:`set_history_archive` in tests.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional

from ..exec.perfgate import SENTINEL_SPECS, RollingBaseline
from ..utils.locks import OrderedLock

__all__ = ["QueryHistoryArchive", "get_history_archive",
           "set_history_archive", "history_totals",
           "perf_regression_totals", "merge_history_docs",
           "cluster_history_doc", "HISTORY_DIR_ENV"]

HISTORY_DIR_ENV = "PRESTO_TPU_HISTORY_DIR"

# one id per process (the cluster merge's dedup key, like the
# profiler's): two server shells over one process fold their shared
# archive exactly once
_PROCESS_ID = None


def _process_id() -> str:
    global _PROCESS_ID
    if _PROCESS_ID is None:
        import uuid
        _PROCESS_ID = uuid.uuid4().hex
    return _PROCESS_ID


# -- process-lifetime counters (survive archive swaps; /v1/metrics) -----

_COUNTERS_LOCK = OrderedLock("history._COUNTERS_LOCK")
_RECORDS_TOTAL = {"count": 0}
_REGRESSIONS_TOTAL: Dict[str, int] = {}  # metric -> breaches


def history_totals() -> Dict[str, int]:
    with _COUNTERS_LOCK:
        return {"records": _RECORDS_TOTAL["count"]}


def perf_regression_totals() -> Dict[str, int]:
    """{metric: lifetime breach count} -- the
    ``presto_tpu_perf_regressions_total`` source."""
    with _COUNTERS_LOCK:
        return dict(_REGRESSIONS_TOTAL)


def _count_record() -> None:
    with _COUNTERS_LOCK:
        _RECORDS_TOTAL["count"] += 1


def _count_regression(metric: str) -> None:
    with _COUNTERS_LOCK:
        _REGRESSIONS_TOTAL[metric] = _REGRESSIONS_TOTAL.get(metric, 0) + 1


def _kernel_mode_envs() -> Dict[str, str]:
    """The kernel-mode env knobs as armed for this process
    (exec/plan_cache.py::KERNEL_MODE_ENVS), so a record says which
    mode its numbers were measured under."""
    from ..exec.plan_cache import KERNEL_MODE_ENVS
    return {name: os.environ.get(name, default)
            for name, default in KERNEL_MODE_ENVS}


def _fingerprint_of(kernels: List[str], text: str,
                    kernel_mode: Dict[str, str],
                    session: Optional[dict] = None) -> str:
    """The baseline key: the executed plan fingerprints when the
    profiler attributed any (the plan identity, immune to whitespace /
    literal formatting), else the collapsed statement text -- both
    salted with the kernel-mode envs (a PRESTO_TPU_NARROW=0 A/B run
    baselines separately instead of alarming against the narrow form)
    AND the session's scale factor: the text fallback would otherwise
    merge sf=0.01 and sf=1.0 runs of the same SQL into one baseline
    and page on the ~100x wall of a legitimate workload change."""
    basis = ",".join(kernels) if kernels else \
        " ".join(text.lower().split())
    mode = "|".join(f"{k}={v}" for k, v in sorted(kernel_mode.items()))
    sf = str((session or {}).get("sf", ""))
    return hashlib.sha256(
        f"{basis}#{mode}#sf={sf}".encode()).hexdigest()[:16]


class QueryHistoryArchive:
    """Bounded completed-query archive + the regression sentinel.

    ``capacity`` bounds the in-memory record list (oldest out).
    Persistence (when a directory is configured): records append to
    ``history-<n>.jsonl``, rotating at ``max_file_records`` lines and
    deleting the oldest file beyond ``max_files`` -- a JSONL ring whose
    total footprint is capped at ``max_files * max_file_records``
    records regardless of uptime. ``load()`` replays the ring into the
    archive AND the baselines (without re-firing alarms), so the
    performance memory survives a restart.
    """


    def __init__(self, capacity: int = 512,
                 history_dir: Optional[str] = None,
                 max_file_records: int = 256, max_files: int = 8,
                 baseline: Optional[RollingBaseline] = None,
                 sentinel: bool = True):
        self.capacity = max(1, int(capacity))
        self.history_dir = history_dir if history_dir is not None \
            else (os.environ.get(HISTORY_DIR_ENV) or None)
        self.max_file_records = max(1, int(max_file_records))
        self.max_files = max(1, int(max_files))
        self.sentinel = bool(sentinel)
        self.baseline = baseline or RollingBaseline()
        self._records: List[dict] = []
        # batchFingerprint -> archived-record count, maintained on
        # append/evict so the batching executor's per-submission
        # hotness seed is O(1) instead of an O(n) scan under _lock
        self._batch_fp_counts: Dict[str, int] = {}
        self._file_index = 0
        self._file_lines = 0
        self._lock = OrderedLock("history.QueryHistoryArchive._lock")
        self._plock = OrderedLock("history.QueryHistoryArchive._plock")
        if self.history_dir:
            self.load()

    # -- record construction -------------------------------------------

    @staticmethod
    def record_of(query_id: str, state: str, user: str, text: str,
                  wall_ms: float, trace_id: str,
                  query_stats=None, session: Optional[dict] = None
                  ) -> dict:
        """Build one archive record from a terminal statement. Pure
        assembly over already-collected telemetry (QueryStats, the
        profiler's query->fingerprint attribution, the flight ring's
        failpoint events) -- never raises on partial inputs: a record
        with zeros beats no record."""
        qs = query_stats
        staging = qs.stages.get("staging") if qs is not None else None
        stats = {
            "wall_us": int(wall_ms * 1000),
            "compile_us": int(qs.compile_us) if qs is not None else 0,
            "execute_us": int(qs.stage_us("execute"))
            if qs is not None else 0,
            "staging_us": int(qs.stage_us("staging"))
            if qs is not None else 0,
            "staged_bytes": int(staging.bytes) if staging is not None
            else 0,
            "narrowed_bytes_saved": int(
                (qs.counters if qs is not None else {}).get(
                    "narrowed_bytes_saved", 0)),
            # runs that paid a compile stage: a miss of the compiled-
            # plan cache (exec/plan_cache.py) or a kernel build
            "retraces": int(qs.compile_us > 0) if qs is not None else 0,
            "spill_bytes": int(
                (qs.counters if qs is not None else {}).get(
                    "spill_bytes", 0)),
            "peak_memory_bytes": int(qs.peak_memory_bytes)
            if qs is not None else 0,
            "output_rows": int(qs.output_rows) if qs is not None else 0,
            "output_bytes": int(qs.output_bytes) if qs is not None else 0,
        }
        # estimate-accuracy aggregates (exec/accuracy.py): the numeric
        # worst q-error joins the sentinel's stats dict (so the perf
        # gate's max_q_error band fires on estimate DRIFT per
        # fingerprint before latency moves), and the per-node rows +
        # named verdict ride the record (the per-(fingerprint,
        # plan-node) feedback store)
        accuracy_rows: List[dict] = []
        misestimated = ""
        max_q = 0.0
        try:
            from ..exec.accuracy import (direction_of,
                                         misestimate_verdict, q_error)
            acc = qs.accuracy if qs is not None else {}
            for node in sorted(acc):
                r = acc[node]
                q = q_error(r.est, r.actual)
                row = r.to_json()
                row["qError"] = round(q, 4) if q is not None else None
                row["direction"] = direction_of(r.est, r.actual)
                accuracy_rows.append(row)
                if q is not None and q > max_q:
                    max_q = q
            v = misestimate_verdict(acc) if acc else None
            if v is not None and not v["withinBand"]:
                misestimated = v["node"]
        except Exception as e:  # noqa: BLE001 - a record without
            # accuracy attribution still archives; count the gap
            from .metrics import record_suppressed
            record_suppressed("history", "accuracy_snapshot", e)
        stats["max_q_error"] = round(max_q, 4)
        kernels: List[str] = []
        top: List[dict] = []
        try:
            from ..exec.profiler import (profile_for_query,
                                         query_fingerprints)
            kernels = query_fingerprints(query_id)
            rows = profile_for_query(query_id, top=3)
            total = sum(int(r.get("device_us", 0)) for r in rows) or 1
            top = [{"fingerprint": r["fingerprint"],
                    "device_us": int(r.get("device_us", 0)),
                    "share": round(int(r.get("device_us", 0)) / total, 4)}
                   for r in rows]
        except Exception as e:  # noqa: BLE001 - a record without kernel
            # attribution still archives; count the gap
            from .metrics import record_suppressed
            record_suppressed("history", "profiler_snapshot", e)
        failpoint_hits = 0
        try:
            from .flight_recorder import get_flight_recorder
            failpoint_hits = sum(
                1 for e in get_flight_recorder().events(kind="failpoint")
                if e.get("trace") == trace_id)
        except Exception as e:  # noqa: BLE001 - same contract as above
            from .metrics import record_suppressed
            record_suppressed("history", "failpoint_scan", e)
        kernel_mode = _kernel_mode_envs()
        return {
            "queryId": str(query_id),
            "state": str(state),
            "user": str(user),
            "query": str(text)[:200],
            "tsUs": int(time.time() * 1_000_000),
            "fingerprint": _fingerprint_of(kernels, text, kernel_mode,
                                           session=session),
            "kernels": kernels,
            "kernelModeEnvs": kernel_mode,
            "traceId": str(trace_id),
            "stats": stats,
            "failpointHits": failpoint_hits,
            "topKernels": top,
            "accuracy": accuracy_rows,
            "misestimatedNode": misestimated,
            "session": {k: str(v) for k, v in (session or {}).items()
                        if k in ("sf", "failpoints")},
            "regressions": [],
        }

    # -- append + sentinel ---------------------------------------------

    def add(self, record: dict) -> List[dict]:
        """Archive one completed-query record; run the sentinel on
        FINISHED queries. Returns the breach verdicts (already counted
        + flight-recorded + dumped). Never raises: this runs on the
        statement tier's terminal seam."""
        try:
            return self._add_inner(record)
        except Exception as e:  # noqa: BLE001 - history is telemetry;
            # losing a record must not fail the query's terminal path
            from .metrics import record_suppressed
            record_suppressed("history", "add", e)
            return []

    def _add_inner(self, record: dict) -> List[dict]:
        breaches: List[dict] = []
        with self._lock:
            if self.sentinel and record.get("state") == "FINISHED":
                breaches = self.baseline.observe(
                    record["fingerprint"], dict(record["stats"]))
                record["regressions"] = [b["metric"] for b in breaches]
        # alarms BEFORE the record becomes visible: anything polling
        # the archive (tests, dashboards) may rely on "record present
        # implies its regressions are already counted/dumped"
        if breaches:
            self._raise_alarms(record, breaches)
        with self._lock:
            self._records.append(record)
            self._count_batch_fp_locked(record, +1)
            self._evict_over_capacity_locked()
        self._persist(record)
        _count_record()
        return breaches

    def _raise_alarms(self, record: dict, breaches: List[dict]) -> None:
        """The breach surfaces: metric counter + flight event per
        breached metric, one auto flight dump per query (the dump's
        header cross-links the trace so the waterfall is one click
        away)."""
        from .flight_recorder import get_flight_recorder, record_event
        for b in breaches:
            _count_regression(b["metric"])
            record_event("perf_regression", query_id=record["queryId"],
                         metric=b["metric"], value=b["value"],
                         median=b["median"], band=b["band"],
                         fingerprint=record["fingerprint"],
                         trace=record["traceId"])
        try:
            get_flight_recorder().maybe_dump(
                record["queryId"], "perf_regression",
                extra={"traceId": record["traceId"],
                       "fingerprint": record["fingerprint"],
                       "regressions": ",".join(
                           b["metric"] for b in breaches),
                       "query": record["query"]})
        except Exception as e:  # noqa: BLE001 - the alarm already
            # counted; a dump miss is telemetry loss, not a failure
            from .metrics import record_suppressed
            record_suppressed("history", "regression_dump", e)

    # -- persistence: the JSONL ring -----------------------------------

    def _ring_files(self) -> List[str]:
        """Ring files oldest-first (index order; names are zero-padded
        so lexical == numeric)."""
        try:
            names = sorted(n for n in os.listdir(self.history_dir)
                           if n.startswith("history-")
                           and n.endswith(".jsonl"))
        except OSError:
            return []
        return [os.path.join(self.history_dir, n) for n in names]

    def _persist(self, record: dict) -> None:
        """Append one record line to the ring (under the persistence
        lock only -- archive readers never wait on disk). Rotation: a
        fresh file every max_file_records lines, oldest file deleted
        beyond max_files. Best-effort -- a full disk must not fail the
        query's terminal path (counted)."""
        if not self.history_dir:
            return
        try:
            with self._plock:
                os.makedirs(self.history_dir, exist_ok=True)
                if self._file_lines >= self.max_file_records:
                    self._file_index += 1
                    self._file_lines = 0
                path = os.path.join(
                    self.history_dir,
                    f"history-{self._file_index:08d}.jsonl")
                with open(path, "a") as f:
                    f.write(json.dumps(record, default=str) + "\n")
                self._file_lines += 1
            files = self._ring_files()
            for stale in files[: max(0, len(files) - self.max_files)]:
                try:
                    os.remove(stale)
                except OSError:
                    continue  # raced another evictor / already gone
        except Exception as e:  # noqa: BLE001 - persistence is
            # best-effort; the in-memory archive still has the record
            from .metrics import record_suppressed
            record_suppressed("history", "persist", e)

    def load(self) -> int:
        """Replay the ring into the archive + baselines (no alarms:
        these samples already fired theirs when live). Returns the
        record count loaded. Called from __init__ when a directory is
        configured; safe on an empty/absent one."""
        loaded: List[dict] = []
        files = self._ring_files()
        for path in files:
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            doc = json.loads(line)
                        except ValueError:
                            continue  # torn tail line of a crashed write
                        if isinstance(doc, dict) and "queryId" in doc:
                            loaded.append(doc)
            except OSError as e:
                from .metrics import record_suppressed
                record_suppressed("history", "load", e)
        loaded = loaded[-self.capacity:]
        with self._lock:
            for doc in loaded:
                self._records.append(doc)
                self._count_batch_fp_locked(doc, +1)
                if doc.get("state") == "FINISHED" and \
                        isinstance(doc.get("stats"), dict):
                    self.baseline.warm(str(doc.get("fingerprint", "")),
                                       {k: float(v) for k, v in
                                        doc["stats"].items()
                                        if isinstance(v, (int, float))})
            self._evict_over_capacity_locked()
        if files:
            with self._plock:
                # resume appends on the newest ring file
                last = os.path.basename(files[-1])
                try:
                    self._file_index = int(last[len("history-"):-6])
                except ValueError:
                    self._file_index = len(files)
                try:
                    with open(files[-1], "rb") as f:
                        data = f.read()
                    self._file_lines = data.count(b"\n")
                    if data and not data.endswith(b"\n"):
                        # torn tail of a crashed mid-write: terminate
                        # it so the next append starts a FRESH line
                        # instead of gluing onto (and losing) both
                        with open(files[-1], "ab") as f:
                            f.write(b"\n")
                        self._file_lines += 1
                except OSError:
                    self._file_lines = 0
        return len(loaded)

    # -- views ----------------------------------------------------------

    def records(self, fingerprint: Optional[str] = None,
                limit: Optional[int] = None) -> List[dict]:
        """Newest-first snapshot, optionally filtered by fingerprint."""
        with self._lock:
            snap = list(self._records)
        snap.reverse()
        if fingerprint:
            snap = [r for r in snap if r.get("fingerprint") == fingerprint]
        if limit is not None:
            snap = snap[: max(0, int(limit))]
        return snap

    def _count_batch_fp_locked(self, record: dict, delta: int) -> None:
        """Maintain the batchFingerprint counter (caller holds _lock)."""
        fp = record.get("batchFingerprint")
        if not fp:
            return
        n = self._batch_fp_counts.get(fp, 0) + delta
        if n > 0:
            self._batch_fp_counts[fp] = n
        else:
            self._batch_fp_counts.pop(fp, None)

    def _evict_over_capacity_locked(self) -> None:
        """Drop the oldest records past capacity (caller holds _lock),
        keeping the batchFingerprint counter exact."""
        over = len(self._records) - self.capacity
        if over > 0:
            for r in self._records[:over]:
                self._count_batch_fp_locked(r, -1)
            del self._records[:over]

    def batch_fingerprint_count(self, fingerprint: str) -> int:
        """How many archived records carry this batch-template
        fingerprint (exec/batching.py seeds its formation-window
        hotness from here, so a dashboard fingerprint is hot from the
        first poll after a restart -- the archive reloads from its
        JSONL ring). O(1): the counter is maintained on append/evict,
        this runs per batchable submission."""
        with self._lock:
            return self._batch_fp_counts.get(fingerprint, 0)

    def size(self) -> int:
        with self._lock:
            return len(self._records)

    def history_doc(self) -> dict:
        """This process's /v1/history slice."""
        return {"processId": _process_id(),
                "records": self.records()}


def merge_history_docs(docs: List[dict], capacity: int = 512
                       ) -> List[dict]:
    """Fold per-process /v1/history slices into one newest-first record
    list. Slices sharing a processId count once (two server shells over
    one process serve the same archive -- the in-process test
    topology), and records dedup by queryId (a query the coordinator
    archived is not re-counted from a worker that also saw it)."""
    seen_processes = set()
    seen_queries = set()
    out: List[dict] = []
    for doc in docs:
        pid = doc.get("processId") or f"anon-{id(doc):x}"
        if pid in seen_processes:
            continue
        seen_processes.add(pid)
        for r in doc.get("records") or ():
            if not isinstance(r, dict):
                continue
            qid = r.get("queryId")
            if qid in seen_queries:
                continue
            seen_queries.add(qid)
            out.append(r)
    out.sort(key=lambda r: (-int(r.get("tsUs", 0)),
                            str(r.get("queryId", ""))))
    return out[:capacity]


def cluster_history_doc(worker_urls=(), timeout: float = 3.0) -> dict:
    """The statement tier's cluster-merged GET /v1/history: this
    process's slice plus every reachable worker's, merged newest-first
    (the shared best-effort pull: client.pull_worker_docs)."""
    from .client import pull_worker_docs
    archive = get_history_archive()
    pulled, workers_seen = pull_worker_docs(
        worker_urls, timeout, lambda c: c.history(), "history")
    docs = [archive.history_doc(), *pulled]
    return {"processId": _process_id(), "cluster": True,
            "workersPulled": workers_seen,
            "records": merge_history_docs(docs, capacity=archive.capacity)}


_archive: Optional[QueryHistoryArchive] = None
_archive_lock = OrderedLock("history._archive_lock")


def get_history_archive() -> QueryHistoryArchive:
    """The process archive (created on first use -- always on, like
    the flight recorder)."""
    global _archive
    if _archive is None:
        with _archive_lock:
            if _archive is None:
                _archive = QueryHistoryArchive()
    return _archive


def set_history_archive(archive: Optional[QueryHistoryArchive]) -> None:
    """Swap the process archive (tests redirect the ring directory and
    shrink sentinel warmup); None resets to a fresh default on next
    use."""
    global _archive
    with _archive_lock:
        _archive = archive
