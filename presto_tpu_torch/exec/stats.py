"""RuntimeStats + structured query telemetry (OperatorStats/StageStats/
QueryStats).

Counterpart of presto_tpu/exec/stats.py: the same classes, merge law
and JSON shapes, so either package's coordinator folds the other's
task stats. Stats are kept at the host-visible boundaries: staging,
compile, execute, exchange pack/unpack, result fetch, rows/bytes.

  * ``RuntimeStats`` -- free-form named counters.
  * ``OperatorStats`` -- per plan node where host-visible (scans,
    exchanges, the output root).
  * ``StageStats`` -- one per stage boundary: ``staging``, ``compile``,
    ``execute``, ``exchange``, ``fetch``.
  * ``QueryStats`` -- the merge root shipped worker -> coordinator in
    the task status and surfaced on the client protocol's ``stats``.

The merge law (``QueryStats.merge``) is associative and commutative:
counters/sums add, ``max`` fields take max, stages/operators merge by
key.

The ``compile`` stage in the port is host work: the wall of lowering
the plan to closures (exec/planner.py::compile_plan) on each rung of
the ladder, plus the nvcc build of a CUDA kernel where a first launch
in the process builds it (the delta of ops/kernels.py's BUILD_SECONDS
around each dispatch). The runner reports both through
:meth:`StatsCollector.add_compile_seconds`.
There is no XLA ``cost_analysis``: the stage's ``flops`` and
``bytes_accessed`` keys stay (0.0) so that merges with the
reference's documents keep their shape.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

from .accuracy import NodeAccuracy, merge_record_maps, \
    record_map_from_json, record_map_to_json
from .datapath import HopStats, hop_map_from_json, hop_map_to_json, \
    merge_hop_maps
from .timeline import TimelineSlice

__all__ = ["RuntimeStats", "timed", "OperatorStats", "StageStats",
           "QueryStats", "StatsCollector", "current_collector",
           "collecting"]


@dataclasses.dataclass
class _Stat:
    count: int = 0
    total: float = 0.0
    max: float = 0.0

    def add(self, v: float):
        self.count += 1
        self.total += v
        self.max = max(self.max, v)


class RuntimeStats:
    def __init__(self):
        self._stats: Dict[str, _Stat] = {}
        self._lock = threading.Lock()

    def add(self, name: str, value: float):
        with self._lock:
            self._stats.setdefault(name, _Stat()).add(value)

    def merge(self, other: "RuntimeStats"):
        # lock both sides (ordered by id to avoid deadlock): _Stat.add is
        # multi-field, so reading `other` unlocked could tear mid-update
        first, second = sorted((self._lock, other._lock), key=id)
        with first, second:
            for k, s in other._stats.items():
                mine = self._stats.setdefault(k, _Stat())
                mine.count += s.count
                mine.total += s.total
                mine.max = max(mine.max, s.max)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"count": s.count, "total": round(s.total, 6),
                        "max": round(s.max, 6)}
                    for k, s in self._stats.items()}

    def timed(self, name: str):
        return timed(self, name)


class timed:
    def __init__(self, stats: RuntimeStats, name: str):
        self.stats = stats
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.stats.add(self.name, time.time() - self.t0)
        return False


# ---------------------------------------------------------------------------
# structured telemetry: OperatorStats / StageStats / QueryStats
# ---------------------------------------------------------------------------


def _us(seconds: float) -> int:
    return int(round(seconds * 1_000_000))


@dataclasses.dataclass
class OperatorStats:
    """Per-plan-node stats at the host-visible granularity (the
    OperatorStats analog; interior fused nodes carry rows only when the
    planner can derive them)."""
    node_id: str
    node_type: str = ""
    output_rows: int = 0
    output_bytes: int = 0
    wall_us: int = 0
    task_count: int = 1

    def merge(self, other: "OperatorStats") -> "OperatorStats":
        assert self.node_id == other.node_id, \
            f"merging operators {self.node_id} != {other.node_id}"
        return OperatorStats(
            node_id=self.node_id,
            node_type=self.node_type or other.node_type,
            output_rows=self.output_rows + other.output_rows,
            output_bytes=self.output_bytes + other.output_bytes,
            wall_us=self.wall_us + other.wall_us,
            task_count=self.task_count + other.task_count)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "OperatorStats":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in known})


@dataclasses.dataclass
class StageStats:
    """One host-visible stage boundary: staging, compile, execute,
    exchange pack/unpack, fetch. ``flops``/``bytes_accessed`` are the
    reference's XLA cost-analysis keys; the port has no source for them
    and leaves them 0.0."""
    name: str
    wall_us: int = 0
    compile_us: int = 0
    invocations: int = 0
    rows: int = 0
    bytes: int = 0
    flops: float = 0.0
    bytes_accessed: float = 0.0
    max_wall_us: int = 0

    def merge(self, other: "StageStats") -> "StageStats":
        assert self.name == other.name, \
            f"merging stages {self.name} != {other.name}"
        return StageStats(
            name=self.name,
            wall_us=self.wall_us + other.wall_us,
            compile_us=self.compile_us + other.compile_us,
            invocations=self.invocations + other.invocations,
            rows=self.rows + other.rows,
            bytes=self.bytes + other.bytes,
            flops=self.flops + other.flops,
            bytes_accessed=self.bytes_accessed + other.bytes_accessed,
            max_wall_us=max(self.max_wall_us, other.max_wall_us))

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "StageStats":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in known})


@dataclasses.dataclass
class QueryStats:
    """The merge root: per-task stats fold into per-query stats through
    ``merge()`` (associative + commutative), shipped worker ->
    coordinator through the task status path and surfaced on the client
    protocol's ``stats`` field."""
    wall_us: int = 0
    output_rows: int = 0
    output_bytes: int = 0
    peak_memory_bytes: int = 0
    task_count: int = 1
    stages: Dict[str, StageStats] = dataclasses.field(default_factory=dict)
    operators: Dict[str, OperatorStats] = \
        dataclasses.field(default_factory=dict)
    # free-form summed counters (exchange collective counts noted at
    # trace time, cache hits, ...); merged by addition
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    # per-hop data-path ledger (exec/datapath.py): bytes/wall per hop,
    # merged by HopStats' own sums-add/maxes-max law -- this is how a
    # worker's hop slice stitches to the coordinator's through the
    # existing task-status path
    datapath: Dict[str, HopStats] = dataclasses.field(default_factory=dict)
    # per-plan-node estimate-vs-actual ledger (exec/accuracy.py):
    # est/actual rows or bytes per node, merged by NodeAccuracy's own
    # estimates-max/rows-add/peaks-max law -- worker slices of one
    # query stitch to the coordinator's through the same path
    accuracy: Dict[str, NodeAccuracy] = \
        dataclasses.field(default_factory=dict)
    # per-query interval-ledger slice (exec/timeline.py): bounded
    # (lane, hop, split, t0, t1, bytes) records merged by the slice's
    # own union-and-truncate law; shipped cross-process as skew-free
    # ages, so a worker's slice stitches to the coordinator's without
    # clock-skew-negative intervals
    timeline: TimelineSlice = \
        dataclasses.field(default_factory=TimelineSlice)

    # -- convenience accessors (the EXPLAIN ANALYZE / CLI summary view) --

    def stage_us(self, name: str) -> int:
        s = self.stages.get(name)
        return s.wall_us if s else 0

    @property
    def compile_us(self) -> int:
        return sum(s.compile_us for s in self.stages.values())

    @property
    def execute_us(self) -> int:
        return self.stage_us("execute")

    def merge(self, other: "QueryStats") -> "QueryStats":
        stages = dict(self.stages)
        for k, s in other.stages.items():
            stages[k] = stages[k].merge(s) if k in stages else s
        operators = dict(self.operators)
        for k, o in other.operators.items():
            operators[k] = operators[k].merge(o) if k in operators else o
        counters = dict(self.counters)
        for k, v in other.counters.items():
            counters[k] = counters.get(k, 0) + v
        return QueryStats(
            wall_us=self.wall_us + other.wall_us,
            output_rows=self.output_rows + other.output_rows,
            output_bytes=self.output_bytes + other.output_bytes,
            peak_memory_bytes=max(self.peak_memory_bytes,
                                  other.peak_memory_bytes),
            task_count=self.task_count + other.task_count,
            stages=stages, operators=operators, counters=counters,
            datapath=merge_hop_maps(self.datapath, other.datapath),
            accuracy=merge_record_maps(self.accuracy, other.accuracy),
            timeline=self.timeline.merge(other.timeline))

    def to_json(self) -> dict:
        return {"wallUs": self.wall_us,
                "outputRows": self.output_rows,
                "outputBytes": self.output_bytes,
                "peakMemoryBytes": self.peak_memory_bytes,
                "taskCount": self.task_count,
                "stages": {k: s.to_json() for k, s in self.stages.items()},
                "operators": {k: o.to_json()
                              for k, o in self.operators.items()},
                "counters": dict(self.counters),
                "datapath": hop_map_to_json(self.datapath),
                "accuracy": record_map_to_json(self.accuracy),
                "timeline": self.timeline.to_json()}

    @classmethod
    def from_json(cls, doc: dict) -> "QueryStats":
        return cls(
            wall_us=int(doc.get("wallUs", 0)),
            output_rows=int(doc.get("outputRows", 0)),
            output_bytes=int(doc.get("outputBytes", 0)),
            peak_memory_bytes=int(doc.get("peakMemoryBytes", 0)),
            task_count=int(doc.get("taskCount", 1)),
            stages={k: StageStats.from_json(s)
                    for k, s in doc.get("stages", {}).items()},
            operators={k: OperatorStats.from_json(o)
                       for k, o in doc.get("operators", {}).items()},
            counters={k: int(v)
                      for k, v in doc.get("counters", {}).items()},
            datapath=hop_map_from_json(doc.get("datapath", {})),
            # old-doc tolerance: records shipped before this field
            # existed deserialize to the empty map (merge identity)
            accuracy=record_map_from_json(doc.get("accuracy", {})),
            # same tolerance: a missing timeline key is the empty
            # slice (merge identity), never an error
            timeline=TimelineSlice.from_json(doc.get("timeline", {})))

    def summary(self) -> str:
        """One-paragraph human summary (the CLI --stats shape)."""
        parts = [f"wall {self.wall_us / 1e6:.3f}s"]
        for name in ("staging", "compile", "execute", "exchange", "fetch"):
            us = self.stage_us(name)
            if us or name in self.stages:
                parts.append(f"{name} {us / 1e6:.3f}s")
        cu = self.compile_us
        if cu:
            parts.append(f"(compile {cu / 1e6:.3f}s)")
        parts.append(f"rows {self.output_rows}")
        parts.append(f"bytes {self.output_bytes}")
        if self.peak_memory_bytes:
            parts.append(f"peak mem {self.peak_memory_bytes >> 20}MB")
        if self.task_count > 1:
            parts.append(f"tasks {self.task_count}")
        return ", ".join(parts)


# ---------------------------------------------------------------------------
# ambient collector: stage spans + compile-time capture
# ---------------------------------------------------------------------------


class StatsCollector:
    """Per-query collection context. Stage timings are recorded as
    (start, end) spans so the tracer can render one span per stage;
    compile seconds (plan lowering, kernel builds) accumulate through
    add_compile_seconds and the runner attributes them to the
    ``compile`` stage."""

    def __init__(self, query_id: str = "query"):
        self.query_id = query_id
        self.stats = QueryStats()
        self.spans: List[tuple] = []  # (stage, start_s, end_s, attrs)
        self._compile_s = 0.0
        self._lock = threading.Lock()

    # -- stage spans ----------------------------------------------------

    def stage(self, name: str, **fields):
        return _StageTimer(self, name, fields)

    def record_stage(self, name: str, start_s: float, end_s: float,
                     **fields) -> None:
        wall = _us(end_s - start_s)
        with self._lock:
            st = self.stats.stages.get(name)
            if st is None:
                st = self.stats.stages[name] = StageStats(name)
            st.wall_us += wall
            st.max_wall_us = max(st.max_wall_us, wall)
            st.invocations += 1
            for k, v in fields.items():
                setattr(st, k, getattr(st, k) + v)
            self.spans.append((name, start_s, end_s, dict(fields)))

    def bump_stage(self, name: str, **fields) -> None:
        """Add to a stage's summed fields without opening a timing span
        (rows/bytes learned after the span closed)."""
        with self._lock:
            st = self.stats.stages.get(name)
            if st is None:
                st = self.stats.stages[name] = StageStats(name)
            for k, v in fields.items():
                setattr(st, k, getattr(st, k) + v)

    def add_compile_seconds(self, seconds: float) -> None:
        with self._lock:
            self._compile_s += seconds

    def take_compile_us(self) -> int:
        """Drain the accumulated compile time."""
        with self._lock:
            us = _us(self._compile_s)
            self._compile_s = 0.0
            return us

    def stage_span_start(self, name: str) -> Optional[float]:
        """Start time of the most recent recorded span for `name`
        (anchors the synthetic compile span inside the execute window
        it actually happened in)."""
        with self._lock:
            for sname, start_s, _end, _attrs in reversed(self.spans):
                if sname == name:
                    return start_s
        return None

    def operator(self, node_id: str, node_type: str = "", **fields) -> None:
        with self._lock:
            op = self.stats.operators.get(node_id)
            if op is None:
                op = self.stats.operators[node_id] = \
                    OperatorStats(node_id, node_type)
            elif node_type and not op.node_type:
                op.node_type = node_type
            for k, v in fields.items():
                setattr(op, k, getattr(op, k) + v)

    def note(self, name: str, delta: int = 1) -> None:
        """Bump a free-form summed counter (QueryStats.counters)."""
        with self._lock:
            self.stats.counters[name] = \
                self.stats.counters.get(name, 0) + delta

    def emit_spans(self, trace_id: Optional[str] = None,
                   parent_id: Optional[str] = None) -> None:
        """Ship collected stage spans through the tracing emission seam
        (one span per stage boundary, each a child of `parent_id` --
        the enclosing task/query span). emit_span delivers to the
        process tracer AND any thread-local SpanBuffer, and never
        raises (broken tracers are counted, not fatal)."""
        from ..server.tracing import emit_span
        tid = trace_id or self.query_id
        for name, start_s, end_s, attrs in self.spans:
            emit_span(tid, f"stage.{name}", start_s, end_s,
                      {k: v for k, v in attrs.items()},
                      parent_id=parent_id)


class _StageTimer:
    def __init__(self, collector: StatsCollector, name: str, fields: dict):
        self.c = collector
        self.name = name
        self.fields = fields

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.c.record_stage(self.name, self.t0, time.time(), **self.fields)
        return False


_tls = threading.local()


def current_collector() -> Optional[StatsCollector]:
    return getattr(_tls, "collector", None)


class collecting:
    """Install `collector` as the ambient collector for this thread."""

    def __init__(self, collector: StatsCollector):
        self.collector = collector

    def __enter__(self):
        self.prev = current_collector()
        _tls.collector = self.collector
        return self.collector

    def __exit__(self, *exc):
        _tls.collector = self.prev
        return False
