"""Estimate-accuracy observatory: per-plan-node cardinality and
footprint q-error attribution with misestimate verdicts.

Counterpart of presto_tpu/exec/accuracy.py: the same records, merge
law, q-error and documents. The port records actual rows only where
the host already has them: staged scans (their host row counts),
the output root (the fetched rows); it reads no interior count from
the device.

Model -- three layers, one merge law (the datapath template):

  * ``NodeAccuracy`` -- one mergeable estimate-vs-actual record per
    plan node, in one of two units: ``rows`` (cardinality) or
    ``bytes`` (the kernel audit's K005 footprint estimate,
    audit/staged.py, vs the MemoryPool's measured peak). The
    merge law mirrors ``QueryStats.merge``: estimates max (each worker
    stamps the SAME per-fragment estimate, so max is idempotent),
    row actuals add (worker slices partition the stream), byte actuals
    max (peaks max, like ``peak_memory_bytes``), task counts add --
    associative, commutative, with the zero record as identity, so
    worker slices stitch through the existing task-status path
    (``QueryStats.accuracy`` carries these records worker ->
    coordinator, folded by ``QueryStats.merge``).
  * ambient per-query ledger (``AccuracyLedger`` + ``recording``):
    ``exec/runner.py`` installs one around each run_query; estimates
    are stamped onto the prepared plan at ``prepare_plan`` time
    (:func:`stamp_estimates`, so EXPLAIN and execution share one
    provenance) and every measured boundary (staged scans, the output
    root) calls :func:`record_node`. Records may arrive half-open;
    only COMPLETE records -- both sides present -- fold into process
    totals and the ``presto_tpu_q_error`` histogram, at finalize.
  * process-lifetime registry: the ``GET /v1/accuracy`` slice (worker
    serves it; the statement tier merges slices cluster-wide via
    server/client.pull_worker_docs, processId-deduped, stable zero
    shape), ``system.cardinality``, metrics.accuracy_families(),
    and flight-dump embeds.

The q-error is Moerkotte's metric: ``max(est/act, act/est)`` with both
sides clamped to >= 1 row/byte (a 0-vs-0 estimate is exact, not a
division error), always >= 1.0, direction "under" when the planner
guessed low -- the dangerous direction (undersized joins spill;
oversized reservations merely waste). :func:`misestimate_verdict` is a
pure function of (records, band): it names the worst offender per
query ("JoinNode J3 underestimated 47x") without reading clocks or
env, so identical inputs always name the same node.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import uuid
from typing import Dict, List, Optional

from ..utils.locks import OrderedLock


__all__ = ["UNITS", "NodeAccuracy", "AccuracyLedger", "recording",
           "record_node", "q_error", "direction_of",
           "merge_record_maps", "record_map_to_json",
           "record_map_from_json", "misestimate_verdict",
           "stamp_estimates", "est_rows_of", "finalize_query",
           "note_query", "accuracy_for_query", "query_max_q_error",
           "clear_accuracy", "process_totals", "accuracy_doc",
           "merge_accuracy_docs", "cluster_accuracy_doc", "snapshot",
           "accuracy_summary"]

# the unit catalog: ONE closed vocabulary every surface shares (metrics
# label presets, /v1/accuracy zero shape, system.cardinality rows, the
# EXPLAIN ANALYZE tail). `rows` is cardinality (plan/stats.estimate_rows
# vs measured output rows); `bytes` is footprint (a footprint
# estimated peak vs MemoryPool measured peak).
UNITS = ("rows", "bytes")

# one id per process: the cluster merge deduplicates slices by it, so
# two server shells over one process (the test topology) count once
_PROCESS_ID = uuid.uuid4().hex

# q-error at-or-below this is "within band" (Presto treats estimates
# within a small factor as trustworthy); above it the record counts as
# a misestimate on /v1/metrics and arms the verdict
_DEFAULT_BAND = 2.0

# sentinel distinguishing "attribute absent" from "estimate is None"
_MISSING = object()


@dataclasses.dataclass
class NodeAccuracy:
    """One plan node's estimate-vs-actual record. Merges with the
    usual law: estimates max (idempotent across workers stamping the
    same fragment), row actuals add, byte actuals max, tasks add --
    associative and commutative with the zero record as identity,
    like QueryStats. ``est``/``actual`` are None while that side is
    unknown (half-open records never produce a q-error)."""
    node: str
    node_type: str = ""
    unit: str = "rows"
    est: Optional[float] = None
    actual: Optional[float] = None
    tasks: int = 0

    def merge(self, other: "NodeAccuracy") -> "NodeAccuracy":
        assert self.node == other.node, \
            f"merging nodes {self.node} != {other.node}"
        unit = self.unit or other.unit
        return NodeAccuracy(
            node=self.node,
            node_type=self.node_type or other.node_type,
            unit=unit,
            est=_opt_max(self.est, other.est),
            actual=(_opt_sum(self.actual, other.actual)
                    if unit == "rows"
                    else _opt_max(self.actual, other.actual)),
            tasks=self.tasks + other.tasks)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "NodeAccuracy":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in known})


def _opt_max(a: Optional[float], b: Optional[float]) -> Optional[float]:
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


def _opt_sum(a: Optional[float], b: Optional[float]) -> Optional[float]:
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def q_error(est: Optional[float],
            actual: Optional[float]) -> Optional[float]:
    """Moerkotte's q-error: max(est/act, act/est), both sides clamped
    to >= 1 (zero estimated against zero actual is exact, not a
    division error). None while either side is unknown."""
    if est is None or actual is None:
        return None
    e = max(float(est), 1.0)
    a = max(float(actual), 1.0)
    return max(e / a, a / e)


def direction_of(est: Optional[float],
                 actual: Optional[float]) -> str:
    """"under" when the planner guessed low (the dangerous direction),
    "over" when high, "exact" otherwise (including unknown sides)."""
    if est is None or actual is None:
        return "exact"
    if float(est) < float(actual):
        return "under"
    if float(est) > float(actual):
        return "over"
    return "exact"


def merge_record_maps(a: Dict[str, NodeAccuracy],
                      b: Dict[str, NodeAccuracy]
                      ) -> Dict[str, NodeAccuracy]:
    """Fold two record maps by node key (NodeAccuracy.merge's law
    lifts to maps: still associative + commutative, empty map as
    identity)."""
    out = dict(a)
    for k, r in b.items():
        out[k] = out[k].merge(r) if k in out else r
    return out


def record_map_to_json(records: Dict[str, NodeAccuracy]
                       ) -> Dict[str, dict]:
    return {k: r.to_json() for k, r in records.items()}


def record_map_from_json(doc: Dict[str, dict]
                         ) -> Dict[str, NodeAccuracy]:
    out = {}
    for k, r in (doc or {}).items():
        out[k] = NodeAccuracy.from_json({"node": k, **r})
    return out


class AccuracyLedger:
    """Per-query estimate-vs-actual accumulator (the ambient
    collection target). Thread-safe: a worker thread and a
    future pipelined staging path record from worker threads while
    the driver thread records the root."""


    def __init__(self):
        self.records: Dict[str, NodeAccuracy] = {}
        self._lock = OrderedLock("accuracy.AccuracyLedger._lock")

    def record(self, node: str, node_type: str = "",
               unit: str = "rows", est: Optional[float] = None,
               actual: Optional[float] = None) -> None:
        """Fold one observation. Half-open calls are fine: a
        audit records the estimate side, finalize fills the actual.
        Within one ledger the law matches the cross-worker merge:
        estimates max, row actuals add (streaming chunks re-record
        the same node), byte actuals max."""
        with self._lock:
            r = self.records.get(node)
            if r is None:
                r = self.records[node] = NodeAccuracy(
                    node, node_type=node_type, unit=unit, tasks=1)
            if node_type and not r.node_type:
                r.node_type = node_type
            if est is not None:
                r.est = _opt_max(r.est, float(est))
            if actual is not None:
                r.actual = (_opt_sum(r.actual, float(actual))
                            if r.unit == "rows"
                            else _opt_max(r.actual, float(actual)))

    def snapshot_records(self) -> Dict[str, NodeAccuracy]:
        with self._lock:
            return {k: dataclasses.replace(r)
                    for k, r in self.records.items()}


# -- ambient (thread-local) attribution ---------------------------------

_tls = threading.local()


def _current_ledger() -> Optional[AccuracyLedger]:
    return getattr(_tls, "ledger", None)


class recording:
    """Install `ledger` as this thread's ambient accuracy target
    (exec/runner.py wraps each run_query; nested invocations shadow
    and restore, like stats.collecting and datapath.recording)."""

    def __init__(self, ledger: AccuracyLedger):
        self.ledger = ledger

    def __enter__(self):
        self.prev = _current_ledger()
        _tls.ledger = self.ledger
        return self.ledger

    def __exit__(self, *exc):
        _tls.ledger = self.prev
        return False


def record_node(node: str, node_type: str = "", unit: str = "rows",
                est: Optional[float] = None,
                actual: Optional[float] = None) -> None:
    """Fold one estimate-vs-actual observation into the ambient
    ledger (when one is installed). Never raises: this sits on the
    staging hot path. Process totals and histograms fold at
    :func:`finalize_query`, not here, so half-open records never
    pollute distributions."""
    try:
        ledger = _current_ledger()
        if ledger is not None:
            ledger.record(node, node_type=node_type, unit=unit,
                          est=est, actual=actual)
    except Exception as e:  # noqa: BLE001 - attribution must never
        # fail the query it observes; leave the counted trace
        try:
            from ..server.metrics import record_suppressed
            record_suppressed("accuracy", "record_node", e)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


# -- estimate stamping ---------------------------------------------------


def stamp_estimates(root, sf: float) -> None:
    """Stamp ``est_rows`` onto every node of a prepared plan (called
    at the end of prepare_plan, so EXPLAIN and execution read the SAME
    estimate -- one provenance). Nodes whose estimate is unknowable
    (stats-free connectors, remote sources) carry None."""
    from ..plan.stats import estimate_rows

    def walk(n) -> None:
        try:
            n.est_rows = estimate_rows(n, sf)
        except Exception:  # noqa: BLE001 - a connector without stats
            # must not fail planning; the node just has no estimate
            n.est_rows = None
        for s in getattr(n, "sources", None) or ():
            walk(s)

    walk(root)


def est_rows_of(node, sf: float) -> Optional[float]:
    """The node's stamped estimate, falling back to a fresh
    ``estimate_rows`` call for trees that lost their stamps (the plan
    cache canonicalizes to an unstamped tree; refine_capacities
    rebuilds nodes via dataclasses.replace). Either way the number is
    the same pure function of (node, sf) -- single provenance."""
    est = getattr(node, "est_rows", _MISSING)
    if est is not _MISSING:
        return est
    try:
        from ..plan.stats import estimate_rows
        return estimate_rows(node, sf)
    except Exception:  # noqa: BLE001
        return None


# -- process registry ----------------------------------------------------

# request handlers (/v1/accuracy, system tables), engine threads
# (finalize_query after each run) and the flight recorder all touch
# these
_LOCK = OrderedLock("accuracy._LOCK")
# query id -> node record map (the flight-dump cross-link AND the
# /v1/accuracy payload); bounded like datapath's query ledgers
_QUERY_RECORDS: "collections.OrderedDict[str, Dict[str, NodeAccuracy]]" \
    = collections.OrderedDict()
_QUERY_RECORDS_MAX = 256
# per-unit lifetime counters: the /v1/metrics families and the cheap
# /v1/cluster embed read these (stable zero shape from process start)
_TOTALS: Dict[str, dict] = {}


def _zero_totals() -> dict:
    return {"records": 0, "under": 0, "over": 0,
            "worstQError": 0.0, "worstNode": ""}


def note_query(query_id: str,
               records: Dict[str, NodeAccuracy]) -> None:
    """Retain one query's record map for flight-dump embeds and the
    /v1/accuracy payload (bounded); re-notes of the same query id
    merge (worker task slices stitch)."""
    if not records:
        return
    with _LOCK:
        have = _QUERY_RECORDS.get(query_id)
        if have is not None:
            _QUERY_RECORDS[query_id] = merge_record_maps(have, records)
            _QUERY_RECORDS.move_to_end(query_id)
        else:
            _QUERY_RECORDS[query_id] = dict(records)
            while len(_QUERY_RECORDS) > _QUERY_RECORDS_MAX:
                _QUERY_RECORDS.popitem(last=False)


def finalize_query(query_id: str,
                   records: Dict[str, NodeAccuracy],
                   band: float = _DEFAULT_BAND) -> None:
    """Fold one finished query's COMPLETE records (both sides known)
    into the process totals, the ``presto_tpu_q_error`` histogram,
    and the bounded per-query registry. Never raises -- the runner
    calls this on every exit path."""
    try:
        note_query(query_id, records)
        observed = []
        with _LOCK:
            for rec in records.values():
                q = q_error(rec.est, rec.actual)
                if q is None:
                    continue
                t = _TOTALS.get(rec.unit)
                if t is None:
                    t = _TOTALS[rec.unit] = _zero_totals()
                t["records"] += 1
                d = direction_of(rec.est, rec.actual)
                if q > band and d in ("under", "over"):
                    t[d] += 1
                if q > t["worstQError"]:
                    t["worstQError"] = q
                    t["worstNode"] = rec.node
                observed.append((rec.unit, q))
        from ..server.metrics import observe_histogram
        for unit, q in observed:
            observe_histogram("presto_tpu_q_error", float(q),
                              labels={"unit": unit})
    except Exception as e:  # noqa: BLE001 - accounting must never
        # fail the query it observes
        try:
            from ..server.metrics import record_suppressed
            record_suppressed("accuracy", "finalize_query", e)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def accuracy_for_query(query_id: str) -> Dict[str, dict]:
    """The record map a query id produced, as JSON rows (flight
    dumps)."""
    with _LOCK:
        records = _QUERY_RECORDS.get(query_id)
        return record_map_to_json(records) if records else {}


def query_max_q_error(query_id: str) -> Optional[float]:
    """The worst q-error a query's finalized records carry, or None
    while nothing complete was recorded (the ptop per-query column)."""
    with _LOCK:
        records = _QUERY_RECORDS.get(query_id)
        if not records:
            return None
        qs = [q for q in (q_error(r.est, r.actual)
                          for r in records.values())
              if q is not None]
    return max(qs) if qs else None


def clear_accuracy() -> None:
    """Drop the process registry + per-query maps (tests isolate
    state)."""
    with _LOCK:
        _QUERY_RECORDS.clear()
        _TOTALS.clear()


def process_totals() -> Dict[str, dict]:
    """Lifetime per-unit totals, every catalog unit present (zero
    shape is stable from process start)."""
    with _LOCK:
        live = {u: dict(t) for u, t in _TOTALS.items()}
    return {u: live.get(u, _zero_totals()) for u in UNITS}


# -- verdicts ------------------------------------------------------------


def _as_fields(node: str, r) -> dict:
    """NodeAccuracy or its JSON row -> plain fields (both shapes flow
    through the verdict: QueryStats carries objects, /v1/accuracy
    documents carry rows)."""
    if isinstance(r, NodeAccuracy):
        return {"node": r.node or node, "node_type": r.node_type,
                "unit": r.unit, "est": r.est, "actual": r.actual,
                "tasks": r.tasks}
    return {"node": r.get("node") or node,
            "node_type": r.get("node_type", ""),
            "unit": r.get("unit", "rows"),
            "est": r.get("est"), "actual": r.get("actual"),
            "tasks": int(r.get("tasks", 0))}


def misestimate_verdict(records,
                        band: float = _DEFAULT_BAND
                        ) -> Optional[dict]:
    """The named verdict: among COMPLETE records, the one with the
    largest q-error -- "JoinNode J3 underestimated 47x".
    ``withinBand`` is True when even the worst offender sits at or
    under ``band`` (the plan's estimates held; a clean replay stays
    silent). Pure function of its inputs -- no clocks, no env -- so
    identical records always name the same node. None when no record
    has both sides. Deterministic tiebreak: q-error desc, node key
    asc."""
    rows = []
    for node, r in dict(records).items():
        f = _as_fields(node, r)
        q = q_error(f["est"], f["actual"])
        if q is None:
            continue
        rows.append((q, f))
    if not rows:
        return None
    q, f = sorted(rows, key=lambda t: (-t[0], t[1]["node"]))[0]
    d = direction_of(f["est"], f["actual"])
    within = q <= band
    label = f["node_type"] or "node"
    if d == "under":
        msg = f"{label} {f['node']} underestimated {q:.1f}x"
    elif d == "over":
        msg = f"{label} {f['node']} overestimated {q:.1f}x"
    else:
        msg = f"{label} {f['node']} estimated exactly"
    return {"node": f["node"], "nodeType": f["node_type"],
            "unit": f["unit"],
            "est": float(f["est"]), "actual": float(f["actual"]),
            "qError": round(q, 4), "direction": d,
            "band": band, "withinBand": within, "message": msg}


# -- surfaces ------------------------------------------------------------


def _record_row(node: str, r: NodeAccuracy) -> dict:
    q = q_error(r.est, r.actual)
    return {**r.to_json(),
            "qError": round(q, 4) if q is not None else None,
            "direction": direction_of(r.est, r.actual)}


def _query_entry(records: Dict[str, NodeAccuracy]) -> dict:
    return {"nodes": {k: _record_row(k, records[k])
                      for k in sorted(records)},
            "verdict": misestimate_verdict(records)}


def accuracy_doc() -> dict:
    """This process's /v1/accuracy slice: per-unit lifetime totals
    (zeros included -- the shape is stable from the first request
    on), the retained per-query record maps with per-query verdicts,
    and the process-lifetime worst verdict across them."""
    with _LOCK:
        queries = {qid: {k: dataclasses.replace(r)
                         for k, r in recs.items()}
                   for qid, recs in _QUERY_RECORDS.items()}
    merged_all: Dict[str, NodeAccuracy] = {}
    for recs in queries.values():
        merged_all = merge_record_maps(merged_all, recs)
    return {"processId": _PROCESS_ID,
            "totals": process_totals(),
            "queries": {qid: _query_entry(recs)
                        for qid, recs in queries.items()},
            "verdict": misestimate_verdict(merged_all)}


def merge_accuracy_docs(docs: List[dict]) -> dict:
    """Fold per-process slices into one cluster view. Slices sharing
    a processId count once (two server shells over one process report
    the same registry); per-query node maps merge by NodeAccuracy's
    law (worker slices of the SAME query stitch -- the distributed
    path's whole point); totals merge by sum for counts, max for
    worst; every verdict is recomputed over the merged records --
    order-independent throughout."""
    seen = set()
    queries: Dict[str, Dict[str, NodeAccuracy]] = {}
    totals = {u: _zero_totals() for u in UNITS}
    for doc in docs:
        pid = doc.get("processId") or f"anon-{id(doc):x}"
        if pid in seen:
            continue
        seen.add(pid)
        for qid, entry in (doc.get("queries") or {}).items():
            recs = record_map_from_json(entry.get("nodes") or {})
            queries[qid] = merge_record_maps(
                queries.get(qid, {}), recs)
        for unit, t in (doc.get("totals") or {}).items():
            if unit not in totals:
                continue
            out = totals[unit]
            out["records"] += int(t.get("records", 0))
            out["under"] += int(t.get("under", 0))
            out["over"] += int(t.get("over", 0))
            if float(t.get("worstQError", 0.0)) > out["worstQError"]:
                out["worstQError"] = float(t.get("worstQError", 0.0))
                out["worstNode"] = t.get("worstNode", "")
    merged_all: Dict[str, NodeAccuracy] = {}
    for recs in queries.values():
        merged_all = merge_record_maps(merged_all, recs)
    return {"totals": totals,
            "queries": {qid: _query_entry(recs)
                        for qid, recs in queries.items()},
            "verdict": misestimate_verdict(merged_all)}


def cluster_accuracy_doc(worker_urls=(), timeout: float = 3.0) -> dict:
    """The coordinator-side merge: this process's slice plus every
    reachable worker's ``GET /v1/accuracy``, folded per query by the
    record merge law. Pulls ride the shared best-effort helper
    (server/client.pull_worker_docs) so bearer/TLS/trace headers --
    and the skip-and-count-dead-workers contract -- stay identical to
    the /v1/profile and /v1/datapath merges'."""
    from ..server.client import pull_worker_docs
    pulled, workers_seen = pull_worker_docs(
        worker_urls, timeout, lambda c: c.accuracy(), "accuracy")
    merged = merge_accuracy_docs([accuracy_doc(), *pulled])
    return {"processId": _PROCESS_ID, "cluster": True,
            "workersPulled": workers_seen, **merged}


def snapshot() -> List[dict]:
    """Per-node rows across the retained queries (the
    system.cardinality table): insertion order by query, node key
    order within one query."""
    with _LOCK:
        queries = {qid: {k: dataclasses.replace(r)
                         for k, r in recs.items()}
                   for qid, recs in _QUERY_RECORDS.items()}
    rows = []
    for qid, recs in queries.items():
        for k in sorted(recs):
            rows.append({"queryId": qid, **_record_row(k, recs[k])})
    return rows


def accuracy_summary() -> dict:
    """The cheap /v1/cluster embed: lifetime complete-record count
    and the worst q-error (with its node) across units -- no locks
    held beyond the totals snapshot, no per-node payload."""
    totals = process_totals()
    worst_unit = max(
        UNITS, key=lambda u: (totals[u]["worstQError"], u))
    worst = totals[worst_unit]
    return {"records": sum(t["records"] for t in totals.values()),
            "misestimates": sum(t["under"] + t["over"]
                                for t in totals.values()),
            "worstQError": round(worst["worstQError"], 2),
            "worstNode": worst["worstNode"]}
