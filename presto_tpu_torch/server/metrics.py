"""Prometheus text-format metrics: the one emitter both tiers share.

Counterpart of presto_tpu/server/metrics.py: the same families,
names and exposition.

Reference surface: the native worker's PrometheusStatsReporter
(presto_cpp/main/PrometheusStatsReporter.cpp) and PrestoServer's
registerHttpEndpoints wiring a scrapeable endpoint; on the Java side
the JMX connector exports the same counters. Both the coordinator
(statement server) and the worker serve ``GET /v1/metrics`` rendering
through this module, so scrape format and naming conventions cannot
drift between tiers.

Format is the Prometheus exposition text format v0.0.4: per family a
``# HELP`` line, a ``# TYPE`` line (counter | gauge | histogram), then
one sample per label set. Histogram families render the cumulative
``_bucket{le=...}`` ladder (``+Inf`` == ``_count``) plus ``_sum`` /
``_count``; buckets carrying an exemplar append the OpenMetrics-style
``# {trace_id="..."} <value>`` suffix, which links a latency bucket
straight to ``GET /v1/trace/{traceId}``. Labels are rendered sorted
for deterministic scrapes.

Latency distributions live in a process-wide histogram registry
(:func:`observe_histogram`): the hot seams -- query end-to-end and
per-state wall (statement), dispatcher queue-wait, per-stage micros
(runner), exchange fetch (http_exchange), page serde (serde/pages),
task lifetime (worker) -- observe into named histograms with FIXED
log-spaced buckets, so per-process distributions merge associatively
and a scrape shape is stable from the first request on (declared
families render zeros before any observation).
"""

from __future__ import annotations

import bisect
import logging
import time as _time
from typing import Dict, List, Optional, Tuple, Union

from ..utils.locks import OrderedLock


__all__ = ["MetricFamily", "Histogram", "DEFAULT_BUCKETS",
           "SIZE_BUCKETS", "Q_ERROR_BUCKETS", "datapath_families",
           "accuracy_families",
           "observe_histogram", "get_histogram", "histogram_families",
           "reset_histograms",
           "render_prometheus", "parse_prometheus",
           "negotiate_exposition", "CONTENT_TYPE_OPENMETRICS",
           "narrowing_families", "uptime_family",
           "plan_cache_families", "batching_families",
           "record_suppressed", "suppressed_error_families",
           "suppressed_error_totals", "tracing_families",
           "flight_recorder_families", "timeline_families",
           "kernel_audit_families", "donation_families",
           "failpoint_families", "query_history_families",
           "live_introspection_families", "fleet_families",
           "lock_families", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# exemplars are legal only in the OpenMetrics exposition (the classic
# 0.0.4 text parser rejects a `# {...}` suffix after the value): the
# /v1/metrics handlers negotiate via the Accept header and render
# exemplars only under this content type
CONTENT_TYPE_OPENMETRICS = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"

_LabelSample = Tuple[Dict[str, str], Union[int, float]]

# The one bucket scheme every latency histogram shares (seconds,
# log-spaced 1-2.5-5 ladder from 100us to 100s). FIXED buckets are what
# make Histogram.merge associative+commutative across workers without
# negotiation -- the same property QueryStats.merge relies on.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0)

# The bytes-oriented ladder beside the time ladder: 1 KiB -> 4 GiB,
# log-spaced (powers of 4), so page/batch/payload SIZE distributions
# have somewhere to land -- a page-size histogram forced onto the
# seconds ladder would put every sample in +Inf. Fixed bounds keep
# Histogram.merge elementwise-add associative+commutative across
# workers, same law, same exemplar contract as the time ladder.
SIZE_BUCKETS: Tuple[float, ...] = tuple(
    float(1024 * 4 ** i) for i in range(12))  # 1KiB .. 4GiB

# The q-error ladder beside the two above: estimate accuracy is a
# RATIO >= 1.0 (exec/accuracy.py, max(est/act, act/est)), log-spaced in
# powers of 2 from "exact" to "off by ~1000x" -- a misestimate
# distribution forced onto the seconds ladder would crowd everything
# under 2.5. Fixed bounds keep Histogram.merge lawful across processes.
Q_ERROR_BUCKETS: Tuple[float, ...] = tuple(
    float(2 ** i) for i in range(11))  # 1x .. 1024x


class Histogram:
    """Mergeable latency distribution over fixed bucket bounds.

    The merge law mirrors ``QueryStats.merge``: counts/sum add
    elementwise, exemplars keep the larger observation -- associative,
    commutative, with the empty histogram as identity -- so per-worker
    histograms fold into a cluster view in any order. ``observe`` is
    thread-safe (one lock per histogram; request-handler, task and
    engine threads all observe concurrently).

    Exemplars: per bucket, the (trace_id, value, tsUs) of the
    MAX-latency observation that landed in that bucket (only kept when
    the observer supplied a trace id), so the worst sample of every
    latency band links to its distributed trace.
    """

    _GUARDED_BY = {"_lock": ("counts", "sum", "count", "exemplars")}

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        assert list(self.buckets) == sorted(set(self.buckets)), \
            "bucket bounds must be strictly ascending"
        # counts[i] = observations <= buckets[i]'s bound and > the
        # previous bound (per-bucket, NOT cumulative; render cumulates);
        # counts[-1] is the +Inf overflow bucket
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        # per-bucket (trace_id, value, ts_us) of the max observation
        self.exemplars: List[Optional[Tuple[str, float, int]]] = \
            [None] * (len(self.buckets) + 1)
        self._lock = OrderedLock("metrics.Histogram._lock")

    def observe(self, value: float,
                trace_id: Optional[str] = None) -> None:
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            if trace_id:
                ex = self.exemplars[i]
                if ex is None or v >= ex[1]:
                    self.exemplars[i] = (str(trace_id), v,
                                         int(_time.time() * 1e6))

    def merge(self, other: "Histogram") -> "Histogram":
        if self.buckets != other.buckets:
            raise ValueError("cannot merge histograms with different "
                             f"bucket schemes: {len(self.buckets)} vs "
                             f"{len(other.buckets)} bounds")
        out = Histogram(self.buckets)
        a, b = self.snapshot(), other.snapshot()
        with out._lock:  # fresh object, but the write barrier is uniform
            out.counts = [x + y for x, y in zip(a["counts"], b["counts"])]
            out.sum = a["sum"] + b["sum"]
            out.count = a["count"] + b["count"]
            out.exemplars = [
                _max_exemplar(x, y)
                for x, y in zip(a["exemplars"], b["exemplars"])]
        return out

    def snapshot(self) -> dict:
        """Consistent copy (render/merge never see a torn update)."""
        with self._lock:
            return {"buckets": self.buckets,
                    "counts": list(self.counts),
                    "sum": self.sum, "count": self.count,
                    "exemplars": list(self.exemplars)}

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (the scrape-side p50/
        p95/p99 arithmetic)."""
        return quantile_from_buckets(self.buckets,
                                     self.snapshot()["counts"], q)

    def to_json(self) -> dict:
        snap = self.snapshot()
        return {"buckets": list(snap["buckets"]),
                "counts": snap["counts"],
                "sum": snap["sum"], "count": snap["count"],
                "exemplars": [list(e) if e else None
                              for e in snap["exemplars"]]}

    @classmethod
    def from_json(cls, doc: dict) -> "Histogram":
        h = cls(tuple(doc["buckets"]))
        ex = doc.get("exemplars") or [None] * (len(h.buckets) + 1)
        with h._lock:  # fresh object, but the write barrier is uniform
            h.counts = [int(c) for c in doc["counts"]]
            h.sum = float(doc["sum"])
            h.count = int(doc["count"])
            h.exemplars = [tuple(e) if e else None for e in ex]
        return h


def _max_exemplar(a, b):
    """Larger observation wins; ties break by timestamp then trace id,
    so the merge stays commutative (order of folding cannot pick a
    different exemplar)."""
    if a is None:
        return b
    if b is None:
        return a
    return a if (a[1], a[2], a[0]) >= (b[1], b[2], b[0]) else b


def quantile_from_buckets(bounds, counts, q: float) -> float:
    """Estimate the q-quantile of a (non-cumulative) bucket-count
    vector by linear interpolation within the bucket containing rank
    q*count; the +Inf bucket reports the last finite bound."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = q * total
    acc = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if acc + c >= rank:
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            lo = bounds[i - 1] if 0 < i <= len(bounds) else 0.0
            frac = (rank - acc) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        acc += c
    return float(bounds[-1])


class MetricFamily:
    """One metric family: name, type, help, and samples (optionally
    labelled). Histogram families carry Histogram snapshots instead of
    scalar samples and render the full cumulative-bucket ladder."""

    def __init__(self, name: str, mtype: str, help_: str):
        assert mtype in ("counter", "gauge", "histogram"), mtype
        self.name = name
        self.mtype = mtype
        self.help = help_
        self.samples: List[_LabelSample] = []
        self.histograms: List[Tuple[Dict[str, str], dict]] = []

    def add(self, value: Union[int, float],
            labels: Optional[Dict[str, str]] = None) -> "MetricFamily":
        self.samples.append((dict(labels or {}), value))
        return self

    def add_histogram(self, hist: "Histogram",
                      labels: Optional[Dict[str, str]] = None
                      ) -> "MetricFamily":
        self.histograms.append((dict(labels or {}), hist.snapshot()))
        return self

    def _label_str(self, labels: Dict[str, str]) -> str:
        return ",".join(f'{k}="{_escape(v)}"'
                        for k, v in sorted(labels.items()))

    def render(self, exemplars: bool = True) -> List[str]:
        """`exemplars=False` renders strictly classic-0.0.4 text (the
        default /v1/metrics scrape); True appends the OpenMetrics
        exemplar suffix on histogram buckets that carry one."""
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.mtype}"]
        for labels, value in self.samples:
            if labels:
                lines.append(
                    f"{self.name}{{{self._label_str(labels)}}} "
                    f"{_num(value)}")
            else:
                lines.append(f"{self.name} {_num(value)}")
        for labels, snap in self.histograms:
            lines.extend(self._render_histogram(labels, snap,
                                                exemplars))
        return lines

    def _render_histogram(self, labels: Dict[str, str], snap: dict,
                          exemplars: bool) -> List[str]:
        lines: List[str] = []
        cum = 0
        for i, bound in enumerate(snap["buckets"]):
            cum += snap["counts"][i]
            lab = self._label_str({**labels, "le": _num(float(bound))})
            line = f"{self.name}_bucket{{{lab}}} {cum}"
            ex = snap["exemplars"][i]
            if exemplars and ex is not None:
                # OpenMetrics exemplar: the max-latency observation of
                # this bucket, linking to GET /v1/trace/{trace_id}
                line += (f' # {{trace_id="{_escape(ex[0])}"}} '
                         f"{_num(float(ex[1]))}")
            lines.append(line)
        cum += snap["counts"][-1]
        lab = self._label_str({**labels, "le": "+Inf"})
        line = f"{self.name}_bucket{{{lab}}} {cum}"
        ex = snap["exemplars"][-1]
        if exemplars and ex is not None:
            line += (f' # {{trace_id="{_escape(ex[0])}"}} '
                     f"{_num(float(ex[1]))}")
        lines.append(line)
        tail = f"{{{self._label_str(labels)}}}" if labels else ""
        lines.append(f"{self.name}_sum{tail} {_num(snap['sum'])}")
        lines.append(f"{self.name}_count{tail} {snap['count']}")
        return lines


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _num(v: Union[int, float]) -> str:
    if isinstance(v, bool):
        return str(int(v))
    if isinstance(v, int):
        return str(v)
    return repr(round(float(v), 6))


# -- process histogram registry -----------------------------------------
#
# Named latency histograms observed from the hot seams. Declared
# families render on EVERY scrape (zeros included) so both tiers'
# /v1/metrics carry a stable histogram shape from the first request on;
# undeclared names observed at runtime export too.

_HIST_LOCK = OrderedLock("metrics._HIST_LOCK")
_HISTOGRAMS: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Histogram] = {}

# name -> (help text, preset label sets rendered even before any
# observation). The label values are the closed vocabularies of each
# seam, so a dashboard's first scrape already shows every series.
_DECLARED_HISTOGRAMS: Dict[str, Tuple[str, Tuple[Dict[str, str], ...]]] = {
    "presto_tpu_query_latency_seconds": (
        "end-to-end statement latency (queued -> terminal)", ({},)),
    "presto_tpu_query_state_seconds": (
        "per-state statement wall time (QueryStateMachine transitions)",
        tuple({"state": s} for s in
              ("QUEUED", "PLANNING", "RUNNING", "FINISHING"))),
    "presto_tpu_dispatch_queue_wait_seconds": (
        "admission wait in the dispatcher's resource-group queue "
        "(cluster gate + local slot), labeled by resource group so "
        "per-latency-class p99s are attributable",
        tuple({"group": g} for g in
              ("global", "global.interactive", "global.dashboard",
               "global.batch"))),
    "presto_tpu_batch_occupancy_queries": (
        "queries served per batched dispatch (exec/batching.py "
        "formation outcomes; solo serial dispatches do not observe)",
        ({},)),
    "presto_tpu_stage_seconds": (
        "per-query host-visible stage wall (exec/stats.py stages)",
        tuple({"stage": s} for s in
              ("staging", "compile", "execute", "exchange", "fetch"))),
    "presto_tpu_exchange_fetch_seconds": (
        "cross-worker exchange pull+decode (http_exchange."
        "fetch_remote_batch)", ({},)),
    "presto_tpu_page_serde_seconds": (
        "SerializedPage codec work per page", tuple(
            {"op": s} for s in ("serialize", "deserialize"))),
    "presto_tpu_task_seconds": (
        "worker task lifetime (create -> terminal)", ({},)),
    # the data-path waterfall's per-hop payload-size distribution
    # (exec/datapath.py record_hop): SIZE_BUCKETS ladder, one series
    # per catalog hop. The label values are spelled literally (like
    # every closed vocabulary above); tests pin them to datapath.HOPS.
    "presto_tpu_datapath_bytes": (
        "per-hop data-path payload size (bytes ladder; "
        "exec/datapath.py hop catalog)",
        tuple({"hop": h} for h in
              ("connector_read", "decode", "narrow_cast", "device_put",
               "kernel", "exchange_serialize", "exchange_fetch",
               "client_drain"))),
    # the estimate-accuracy observatory's q-error distribution
    # (exec/accuracy.py finalize_query): Q_ERROR_BUCKETS ladder, one
    # series per unit of the closed catalog. Label values spelled
    # literally (like every closed vocabulary above); tests pin them
    # to accuracy.UNITS.
    "presto_tpu_q_error": (
        "per-plan-node estimate q-error max(est/act, act/est) "
        "(ratio ladder; exec/accuracy.py unit catalog)",
        tuple({"unit": u} for u in ("rows", "bytes"))),
}

# histogram families whose observations are NOT seconds use their own
# fixed ladder (one scheme per family name: merge stays lawful because
# every instance of a name shares the same bounds)
_BUCKET_SCHEMES: Dict[str, Tuple[float, ...]] = {
    "presto_tpu_datapath_bytes": SIZE_BUCKETS,
    "presto_tpu_q_error": Q_ERROR_BUCKETS,
}


def _hist_key(name: str, labels: Optional[Dict[str, str]]
              ) -> Tuple[str, Tuple[Tuple[str, str], ...]]:
    return (name, tuple(sorted((labels or {}).items())))


def get_histogram(name: str, labels: Optional[Dict[str, str]] = None
                  ) -> Histogram:
    """The named histogram (created on first use; fixed buckets per
    family name -- the time ladder unless _BUCKET_SCHEMES declares a
    size ladder -- so every instance merges with every other)."""
    key = _hist_key(name, labels)
    with _HIST_LOCK:
        h = _HISTOGRAMS.get(key)
        if h is None:
            h = _HISTOGRAMS[key] = Histogram(
                _BUCKET_SCHEMES.get(name, DEFAULT_BUCKETS))
        return h


def observe_histogram(name: str, value: float,
                      labels: Optional[Dict[str, str]] = None,
                      trace_id: Optional[str] = None) -> None:
    """Observe one latency sample into the process registry. Never
    raises: this sits on request/task hot paths."""
    try:
        get_histogram(name, labels).observe(value, trace_id=trace_id)
    except Exception as e:  # noqa: BLE001 - telemetry must never fail
        # the request that carried it; a broken registry is counted
        record_suppressed("metrics", "observe_histogram", e)


def histogram_families() -> List[MetricFamily]:
    """Every declared + observed histogram family (shared by both
    tiers' /v1/metrics, like the counter builders above)."""
    with _HIST_LOCK:
        live = dict(_HISTOGRAMS)
    fams: List[MetricFamily] = []
    names = list(_DECLARED_HISTOGRAMS) + sorted(
        {n for n, _ in live} - set(_DECLARED_HISTOGRAMS))
    for name in names:
        help_, presets = _DECLARED_HISTOGRAMS.get(
            name, ("runtime-observed latency histogram", ({},)))
        fam = MetricFamily(name, "histogram", help_)
        keys = {_hist_key(name, p)[1] for p in presets}
        keys |= {lk for n, lk in live if n == name}
        for lk in sorted(keys):
            labels = dict(lk)
            fam.add_histogram(
                live.get((name, lk)) or
                Histogram(_BUCKET_SCHEMES.get(name, DEFAULT_BUCKETS)),
                labels)
        fams.append(fam)
    return fams


def reset_histograms() -> None:
    """Drop every observed histogram (tests isolate scrape state)."""
    with _HIST_LOCK:
        _HISTOGRAMS.clear()


def plan_cache_families() -> List[MetricFamily]:
    """The compiled-plan cache's families (exec/plan_cache.py), which
    both tiers export from this one builder."""
    from ..exec.plan_cache import cache_stats
    st = cache_stats()
    return [
        MetricFamily("presto_tpu_plan_cache_entries", "gauge",
                     "compiled-plan cache entries").add(st["entries"]),
        MetricFamily("presto_tpu_plan_cache_hits_total", "counter",
                     "compiled-plan cache hits").add(st["hits"]),
        MetricFamily("presto_tpu_plan_cache_misses_total", "counter",
                     "compiled-plan cache misses").add(st["misses"]),
    ]


def batching_families() -> List[MetricFamily]:
    """Concurrent-query batching totals (exec/batching.py), exported by
    both tiers with a stable zero shape: batches against the queries
    they served, collapses by reason, and the occupancy of the last
    formed batch, which /v1/cluster mirrors."""
    from ..exec.batching import COLLAPSE_REASONS, batching_totals
    t = batching_totals()
    fam_c = MetricFamily("presto_tpu_batch_collapses_total", "counter",
                         "formed batches collapsed back to serial "
                         "dispatch, by reason")
    for r in COLLAPSE_REASONS:
        fam_c.add(t["collapses"].get(r, 0), {"reason": r})
    return [
        MetricFamily("presto_tpu_batch_dispatches_total", "counter",
                     "batched dispatches executed (one run of the "
                     "template per member, one flag read and one fetch "
                     "per batch)").add(t["batches"]),
        MetricFamily("presto_tpu_batched_queries_total", "counter",
                     "queries served by a batched dispatch").add(
                         t["batched_queries"]),
        MetricFamily("presto_tpu_batch_solo_dispatches_total", "counter",
                     "batch-of-1 dispatches on an already lowered "
                     "template (no co-batching, no fresh "
                     "lowering)").add(t.get("solo_dispatches", 0)),
        fam_c,
        MetricFamily("presto_tpu_batch_occupancy", "gauge",
                     "queries per dispatch of the last formed "
                     "batch").add(t["last_batch_size"]),
    ]


def datapath_families() -> List[MetricFamily]:
    """Data-path waterfall lifetime totals (exec/datapath.py), exported
    by BOTH tiers with a stable zero shape: per-hop bytes moved and
    wall burned -- the counters whose scrape-window ratio IS the hop's
    achieved B/s, beside the SIZE_BUCKETS distribution the histogram
    registry already renders."""
    from ..exec.datapath import HOPS, process_totals
    totals = process_totals()
    fam_b = MetricFamily(
        "presto_tpu_datapath_bytes_total", "counter",
        "bytes attributed per data-path hop "
        "(exec/datapath.py; see DESIGN.md 'Data-path attribution')")
    fam_s = MetricFamily(
        "presto_tpu_datapath_seconds_total", "counter",
        "wall attributed per data-path hop (bytes/seconds ratio over "
        "a scrape window = the hop's achieved throughput)")
    fam_i = MetricFamily(
        "presto_tpu_datapath_observations_total", "counter",
        "hop observations recorded (splits staged, pages coded, "
        "fetches, drains)")
    for hop in HOPS:
        h = totals[hop]
        fam_b.add(h.bytes, {"hop": hop})
        fam_s.add(round(h.wall_us / 1e6, 6), {"hop": hop})
        fam_i.add(h.invocations, {"hop": hop})
    return [fam_b, fam_s, fam_i]


def accuracy_families() -> List[MetricFamily]:
    """Estimate-accuracy lifetime totals (exec/accuracy.py), exported
    by BOTH tiers with a stable zero shape: complete records folded,
    misestimates beyond the band by direction, and the worst q-error
    seen -- beside the Q_ERROR_BUCKETS distribution the histogram
    registry already renders."""
    from ..exec.accuracy import UNITS, process_totals
    totals = process_totals()
    fam_r = MetricFamily(
        "presto_tpu_accuracy_records_total", "counter",
        "complete estimate-vs-actual records folded per unit "
        "(exec/accuracy.py; see DESIGN.md 'Estimate accuracy')")
    fam_m = MetricFamily(
        "presto_tpu_misestimates_total", "counter",
        "records whose q-error exceeded the band, by unit and "
        "direction (under = planner guessed low)")
    fam_w = MetricFamily(
        "presto_tpu_worst_q_error", "gauge",
        "lifetime worst q-error observed per unit (monotonic; 0 "
        "until the first complete record)")
    for unit in UNITS:
        t = totals[unit]
        fam_r.add(t["records"], {"unit": unit})
        for d in ("under", "over"):
            fam_m.add(t[d], {"unit": unit, "direction": d})
        fam_w.add(round(t["worstQError"], 4), {"unit": unit})
    return [fam_r, fam_m, fam_w]


def narrowing_families() -> List[MetricFamily]:
    """Narrow-width execution lifetime totals (plan/widths.py), exported
    by both tiers."""
    from ..plan.widths import narrowing_totals
    t = narrowing_totals()
    return [
        MetricFamily("presto_tpu_narrowed_bytes_saved_total", "counter",
                     "host->device staging bytes saved by narrow-width "
                     "execution").add(t["bytes_saved"]),
        MetricFamily("presto_tpu_narrowed_columns_total", "counter",
                     "scan columns staged at a narrowed physical "
                     "lane").add(t["columns"]),
    ]


# -- suppressed handler errors ------------------------------------------
#
# Server-tier contract: a
# request handler/background loop that intentionally survives an
# exception must still LEAVE A TRACE -- one debug log line plus a
# lifetime counter labelled by (component, site), exported on
# /v1/metrics by both tiers. "Swallowed but counted" is observable;
# "swallowed" is a silent outage.

_SUPPRESSED_LOCK = OrderedLock("metrics._SUPPRESSED_LOCK")
_SUPPRESSED: Dict[Tuple[str, str], int] = {}
_log = logging.getLogger("presto_tpu_torch.server")


def record_suppressed(component: str, site: str,
                      exc: Optional[BaseException] = None) -> None:
    """Count (and debug-log) an intentionally survived exception.
    Never raises: this runs inside except blocks on cleanup paths."""
    with _SUPPRESSED_LOCK:
        key = (component, site)
        _SUPPRESSED[key] = _SUPPRESSED.get(key, 0) + 1
    if exc is not None:
        try:
            _log.debug("suppressed error in %s.%s: %s: %s",
                       component, site, type(exc).__name__, exc)
        except Exception:  # tpulint: disable=S001 - logging teardown
            pass


def suppressed_error_totals() -> Dict[Tuple[str, str], int]:
    with _SUPPRESSED_LOCK:
        return dict(_SUPPRESSED)


def suppressed_error_families() -> List[MetricFamily]:
    """One counter family, (component, site)-labelled, shared by the
    coordinator and worker scrape endpoints."""
    fam = MetricFamily(
        "presto_tpu_suppressed_errors_total", "counter",
        "handler/background-loop exceptions intentionally survived "
        "(logged + counted)")
    totals = suppressed_error_totals()
    for (component, site), n in sorted(totals.items()):
        fam.add(n, {"component": component, "site": site})
    if not totals:  # families always carry >= 1 sample (scrape shape
        # is stable from the first request on)
        fam.add(0, {"component": "none", "site": "none"})
    return [fam]


def tracing_families() -> List[MetricFamily]:
    """Tracer health, exported by BOTH tiers: spans recorded, traces
    evicted at capacity, spans dropped by a broken tracer -- the
    counters that tell an operator whether the trace they are about to
    pull is complete."""
    from .tracing import tracing_totals
    t = tracing_totals()
    return [
        MetricFamily("presto_tpu_trace_spans_total", "counter",
                     "spans recorded by the process tracer").add(
                         t["spans"]),
        MetricFamily("presto_tpu_traces_evicted_total", "counter",
                     "traces evicted at tracer capacity "
                     "(least-recently-updated out)").add(t["evicted"]),
        MetricFamily("presto_tpu_trace_spans_dropped_total", "counter",
                     "spans lost to a tracer that raised "
                     "(see suppressed_errors{component=tracing})").add(
                         t["dropped"]),
    ]


def flight_recorder_families() -> List[MetricFamily]:
    """Flight-recorder health: events recorded, auto-dumps written
    (labelled by trigger reason: failed | slow | perf_regression), and
    dump files evicted by the on-disk retention cap."""
    from .flight_recorder import flight_recorder_totals
    t = flight_recorder_totals()
    fam_d = MetricFamily(
        "presto_tpu_flight_recorder_dumps_total", "counter",
        "automatic slow/failed/perf-regression JSONL dumps, by trigger "
        "reason")
    dumps = t["dumps"]
    for reason in sorted(set(dumps) | {"failed", "slow",
                                       "perf_regression", "stuck"}):
        fam_d.add(dumps.get(reason, 0), {"reason": reason})
    return [
        MetricFamily("presto_tpu_flight_recorder_events_total", "counter",
                     "structured events appended to the flight-recorder "
                     "ring").add(t["events"]),
        fam_d,
        MetricFamily("presto_tpu_flight_dumps_evicted_total", "counter",
                     "dump files deleted oldest-first by the "
                     "PRESTO_TPU_FLIGHT_MAX_DUMPS retention cap").add(
                         t.get("evicted", 0)),
    ]


def query_history_families() -> List[MetricFamily]:
    """Query-history archive + perf-sentinel families, exported by BOTH
    tiers: archive size, lifetime records archived, and regression
    breaches per gated metric. Every sentinel metric gets a sample
    (zeros included) so the scrape shape is stable from the first
    request on."""
    from ..exec.perfgate import SENTINEL_SPECS
    from .history import (get_history_archive, history_totals,
                          perf_regression_totals)
    regressions = perf_regression_totals()
    fam_r = MetricFamily(
        "presto_tpu_perf_regressions_total", "counter",
        "per-fingerprint baseline breaches caught by the in-engine "
        "perf sentinel, by metric (server/history.py + exec/perfgate.py)")
    metrics = {s.name for s in SENTINEL_SPECS} | set(regressions)
    for m in sorted(metrics):
        fam_r.add(regressions.get(m, 0), {"metric": m})
    return [
        MetricFamily("presto_tpu_query_history_entries", "gauge",
                     "completed-query records currently retained by "
                     "this process's history archive").add(
                         get_history_archive().size()),
        MetricFamily("presto_tpu_query_history_records_total", "counter",
                     "completed-query records archived since process "
                     "start").add(history_totals()["records"]),
        fam_r,
    ]


def kernel_audit_families() -> List[MetricFamily]:
    """Staging-time kernel-audit totals (audit/staged.py), exported by
    BOTH tiers: findings per IR pass plus kernels audited. Every
    registered pass code gets a sample (zeros included) so the scrape
    shape is stable from the first request on."""
    from ..audit.core import all_passes
    from ..audit.staged import kernel_audit_totals
    t = kernel_audit_totals()
    findings = t["findings"]
    fam = MetricFamily(
        "presto_tpu_kernel_audit_findings_total", "counter",
        "IR-audit findings surfaced to queries, by pass "
        "(kernaudit; see DESIGN.md 'Kernel IR auditing')")
    codes = {p.code for p in all_passes()} | set(findings)
    for code in sorted(codes):
        fam.add(findings.get(code, 0), {"pass": code})
    return [
        fam,
        MetricFamily("presto_tpu_kernel_audit_kernels_total", "counter",
                     "staged kernels traced and audited (memo hits "
                     "excluded)").add(t["kernels"]),
    ]


def donation_families() -> List[MetricFamily]:
    """Proven-safe buffer-donation totals (exec/donation.py), exported
    by BOTH tiers with a stable zero shape: donated dispatches, HBM
    bytes aliased in place of fresh output allocations, and donation
    -path errors that collapsed to the undonated dispatch."""
    from ..exec.donation import donation_totals
    t = donation_totals()
    return [
        MetricFamily("presto_tpu_donations_total", "counter",
                     "region dispatches that ran the donating form "
                     "(K006-proven donate_argnums wrapper)").add(
                         t["donations"]),
        MetricFamily("presto_tpu_donated_bytes_total", "counter",
                     "HBM bytes aliased input-to-output by proven-safe "
                     "buffer donation instead of freshly allocated "
                     "(see DESIGN.md 'Buffer donation')").add(
                         t["donated_bytes"]),
        MetricFamily("presto_tpu_donation_fallbacks_total", "counter",
                     "donation-path errors that fell back to the "
                     "normal undonated dispatch (fallback, never "
                     "failure)").add(t["fallbacks"]),
    ]


def timeline_families() -> List[MetricFamily]:
    """Execution-timeline totals (exec/timeline.py), exported by BOTH
    tiers with a stable zero shape: lifetime interval/drop/query
    counters plus the last completed query's occupancy headline
    (overlap fraction and device-idle wall) -- the gauges the async
    -pipeline work is measured against."""
    from ..exec.timeline import last_occupancy, timeline_totals
    t = timeline_totals()
    last = last_occupancy()
    return [
        MetricFamily("presto_tpu_timeline_intervals_total", "counter",
                     "execution-timeline intervals retained across "
                     "queries (exec/timeline.py; see DESIGN.md "
                     "'Execution timeline & occupancy')").add(
                         t["intervals"]),
        MetricFamily("presto_tpu_timeline_dropped_total", "counter",
                     "intervals dropped by the per-query cap or "
                     "totals-only degradation (never a query "
                     "failure)").add(t["dropped"]),
        MetricFamily("presto_tpu_timeline_queries_total", "counter",
                     "queries that contributed a timeline slice").add(
                         t["queries"]),
        MetricFamily("presto_tpu_overlap_fraction", "gauge",
                     "last query's host-staging/device-dispatch "
                     "overlap fraction (0 = strictly serial pipeline; "
                     "the async-ingest baseline)").add(
                         float(last.get("overlapFraction", 0.0))),
        MetricFamily("presto_tpu_device_idle_us", "gauge",
                     "last query's device-idle wall within the "
                     "timeline extent (the bubble the occupancy "
                     "verdict attributes per hop)").add(
                         int(last.get("deviceIdleUs", 0))),
    ]


def live_introspection_families(workers_alive: Optional[int] = None
                                ) -> List[MetricFamily]:
    """Live-cluster introspection gauges + the stuck-progress counter,
    exported by BOTH tiers: in-flight tasks known to this process's
    progress registry (exec/progress.py), the caller's view of alive
    workers (the worker passes 1 -- itself; the statement tier passes
    its cached /v1/status probe count), and lifetime stuck-progress
    watchdog firings (server/watchdog.py)."""
    from ..exec.progress import live_task_count
    from .watchdog import stuck_totals
    fams = [
        MetricFamily("presto_tpu_running_tasks", "gauge",
                     "in-flight query/task progress entries this "
                     "process is tracking").add(live_task_count()),
        MetricFamily("presto_tpu_stuck_queries_total", "counter",
                     "queries/tasks whose progress last-advance age "
                     "exceeded stuck_query_threshold_ms "
                     "(stuck-progress watchdog firings)").add(
                         stuck_totals()),
    ]
    if workers_alive is not None:
        fams.insert(1, MetricFamily(
            "presto_tpu_cluster_workers_alive", "gauge",
            "workers this node currently believes alive (the worker "
            "reports itself; the statement tier its last /v1/status "
            "probe)").add(int(workers_alive)))
    return fams


def fleet_families(workers_draining: Optional[int] = None
                   ) -> List[MetricFamily]:
    """Elastic-fleet accounting, exported by BOTH tiers with a stable
    zero shape: membership churn (workers joined/left through the
    discovery service), announcer re-registration retries, speculative
    re-execution outcomes (launched/wins/losses), coordinator
    failovers, and -- when the caller knows it -- the draining-worker
    gauge (the worker reports its own drain state; the statement tier
    its last /v1/cluster probe's DRAINING count)."""
    from .coordinator import speculation_totals
    from .discovery import announce_retry_totals, fleet_membership_totals
    from .resource_manager import failover_totals
    member = fleet_membership_totals()
    spec = speculation_totals()
    fams = [
        MetricFamily("presto_tpu_fleet_workers_joined_total", "counter",
                     "distinct worker announcements accepted by this "
                     "process's discovery service").add(member["joined"]),
        MetricFamily("presto_tpu_fleet_workers_left_total", "counter",
                     "worker unannouncements (graceful goodbyes) "
                     "accepted by this process's discovery "
                     "service").add(member["left"]),
        MetricFamily("presto_tpu_announce_retries_total", "counter",
                     "failed worker announcements retried on the "
                     "backoff schedule (utils/backoff.py)").add(
                         announce_retry_totals()),
        MetricFamily("presto_tpu_speculation_launched_total", "counter",
                     "speculative task attempts submitted for "
                     "stragglers").add(spec["launched"]),
        MetricFamily("presto_tpu_speculation_wins_total", "counter",
                     "speculative attempts that finished before their "
                     "straggling original").add(spec["wins"]),
        MetricFamily("presto_tpu_speculation_losses_total", "counter",
                     "speculative attempts beaten by their "
                     "original").add(spec["losses"]),
        MetricFamily("presto_tpu_coordinator_failovers_total", "counter",
                     "standby-coordinator takeovers after a primary "
                     "heartbeat lapse "
                     "(resource_manager.StandbyCoordinator)").add(
                         failover_totals()),
    ]
    if workers_draining is not None:
        fams.append(MetricFamily(
            "presto_tpu_fleet_workers_draining", "gauge",
            "workers currently in the DRAINING state (the worker "
            "reports itself; the statement tier its last probe)").add(
                int(workers_draining)))
    return fams


def failpoint_families() -> List[MetricFamily]:
    """Fault-injection accounting, exported by BOTH tiers: lifetime
    fired-fault counts per (site, action) plus the currently-armed
    gauge. The chaos harness's third invariant -- every injected fault
    accounted for -- audits against exactly these samples."""
    from ..failpoints import armed_count, failpoint_totals
    fam = MetricFamily(
        "presto_tpu_failpoint_hits_total", "counter",
        "fault injections fired, by (site, action) "
        "(failpoints subsystem; see DESIGN.md 'Fault injection')")
    totals = failpoint_totals()
    for (site, action), n in sorted(totals.items()):
        fam.add(n, {"site": site, "action": action})
    if not totals:  # stable scrape shape from the first request on
        fam.add(0, {"site": "none", "action": "none"})
    return [
        fam,
        MetricFamily("presto_tpu_failpoints_armed", "gauge",
                     "failpoint sites currently armed").add(
                         armed_count()),
    ]


def lock_families() -> List[MetricFamily]:
    """Lock-order witness accounting (utils/locks.py), exported by BOTH
    tiers: the process-lifetime inversion counter plus the armed gauge,
    so a scrape shows whether zero means "clean under watch" or
    "witness off"."""
    from ..utils import locks as _locks
    return [
        MetricFamily(
            "presto_tpu_lock_order_violations_total", "counter",
            "lock-order inversions detected at acquire time by the "
            "runtime witness (utils/locks.py; see DESIGN.md "
            "'Concurrency auditing')").add(
                _locks.witness_violations_total()),
        MetricFamily(
            "presto_tpu_lock_witness_armed", "gauge",
            "1 while the lock-order witness is armed").add(
                1 if _locks.ARMED else 0),
    ]


def uptime_family(started_at: float, role: str) -> MetricFamily:
    import time
    return MetricFamily("presto_tpu_uptime_seconds", "gauge",
                        f"{role} uptime").add(
                            round(time.time() - started_at, 1))


def render_prometheus(families: List[MetricFamily],
                      openmetrics: bool = False) -> bytes:
    """Default: classic text format 0.0.4, exemplar-free (valid for a
    stock Prometheus scraper). `openmetrics=True` (the handlers pass it
    when the Accept header asks for application/openmetrics-text)
    renders bucket exemplars and the terminating ``# EOF``."""
    lines: List[str] = []
    for f in families:
        lines.extend(f.render(exemplars=openmetrics))
    if openmetrics:
        lines.append("# EOF")
    return ("\n".join(lines) + "\n").encode()


def negotiate_exposition(accept_header: Optional[str]
                         ) -> Tuple[bool, str]:
    """(openmetrics?, content type) from a scrape's Accept header --
    the one negotiation both tiers' /v1/metrics handlers share."""
    if accept_header and "openmetrics" in accept_header:
        return True, CONTENT_TYPE_OPENMETRICS
    return False, CONTENT_TYPE


_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _histogram_base(name: str, typed: Dict[str, str]) -> Optional[str]:
    """The histogram family a ``_bucket``/``_sum``/``_count`` sample
    belongs to, when one is declared."""
    for suf in _HIST_SUFFIXES:
        if name.endswith(suf):
            base = name[: -len(suf)]
            if typed.get(base) == "histogram":
                return base
    return None


def parse_prometheus(text: str) -> Dict[str, Dict[str, float]]:
    """Exposition text -> {family: {sample_key: value}} where
    sample_key is '' for unlabelled samples or the rendered label set.
    Histogram sub-samples keep their full ``<base>_bucket``/``_sum``/
    ``_count`` names as the family key (their ``# TYPE`` line is the
    base name); OpenMetrics exemplar suffixes (`` # {...} v``) are
    stripped before value parsing. Used by the test suite; raises ValueError on lines that are neither
    comments nor samples (the 'valid Prometheus text' check)."""
    out: Dict[str, Dict[str, float]] = {}
    typed: Dict[str, str] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] == "TYPE":
                mtype = parts[3] if len(parts) > 3 else "untyped"
                if mtype not in ("counter", "gauge", "histogram",
                                 "summary", "untyped"):
                    raise ValueError(f"bad TYPE line: {raw!r}")
                typed[parts[2]] = mtype
            continue
        # exemplar suffix: everything from the last " # {" on is the
        # OpenMetrics exemplar annotation, not part of the sample
        ex_at = line.rfind(" # {")
        if ex_at != -1:
            line = line[:ex_at].rstrip()
        name, _, rest = line.partition("{")
        if rest:  # labelled sample
            labels, _, valpart = rest.rpartition("}")
            value = valpart.strip()
            key = "{" + labels + "}"
        else:
            fields = line.split()
            if len(fields) not in (2, 3):  # optional timestamp
                raise ValueError(f"bad sample line: {raw!r}")
            name, value = fields[0], fields[1]
            key = ""
        fam = name
        try:
            fval = float(value)
        except ValueError as e:
            raise ValueError(f"bad value in line: {raw!r}") from e
        if fam not in typed and _histogram_base(fam, typed) is None:
            raise ValueError(f"sample {fam!r} before its # TYPE line")
        out.setdefault(fam, {})[key] = fval
    return out
