"""Staging-time kernel auditing: the exec/runner.py <-> kernaudit seam.

Counterpart of presto_tpu/audit/staged.py. When the ``kernel_audit``
session property (env ``PRESTO_TPU_KERNEL_AUDIT``, in
exec/plan_cache.py's KERNEL_MODE_ENVS) is on, the runner calls
:func:`audit_staged_query` after staging and before dispatch, once for
a plan that runs as one region and once per region in the region
executor: the plan's lowered closure runs once more over the staged
batches under the recorder (audit/core.py::KernelTrace) and every
registered pass reads the trace. The result is memoized by (plan
fingerprint, mesh, kernel mode, K005 budget, the inputs' shapes and
dtypes, the donated inputs), and the memo is cleared with the
compiled-plan cache; a memo hit runs nothing.

The audited run is a real run whose result is discarded. It is kept
apart from the query's own books: it runs with no ambient stats
collector, and the process counters the closure's operators write
(ops/aggregation.py::HASH_STATS, parallel/exchange.py::RECEIVED) are
put back as they were. Its kernel launches count in
ops/kernels.py::LAUNCHES like any other launch. An error raised while
the closure runs (a CUDA error, a kernel's refusal) propagates and
fails the query, as the dispatch would; an error of the passes is
counted suppressed and the query goes on.

Findings are telemetry, never failures: they are counted into
QueryStats counters (``kernel_audit.K001`` ...), bumped on the
process-lifetime totals behind ``presto_tpu_kernel_audit_findings_
total{pass=...}`` on both tiers' ``/v1/metrics``, recorded as one
flight-recorder ``kernel_audit`` event, and the K005 peak estimate
feeds the memory pool's accounting. The gate that FAILS on findings is
``python -m presto_tpu_torch.audit`` over the TPC-H corpus.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Optional, Sequence

__all__ = ["kernel_audit_enabled", "audit_staged_query",
           "kernel_audit_totals", "clear_audit_memo", "trace_closure",
           "AUDIT_ENV"]

AUDIT_ENV = "PRESTO_TPU_KERNEL_AUDIT"

# -- process-lifetime totals (/v1/metrics, both tiers) -------------------

_TOTALS_LOCK = threading.Lock()
_FINDINGS_TOTAL: Dict[str, int] = {}   # pass code -> findings surfaced
_KERNELS_TOTAL = {"audited": 0}        # fresh traces (memo hits excluded)


def kernel_audit_totals() -> Dict[str, object]:
    with _TOTALS_LOCK:
        return {"findings": dict(_FINDINGS_TOTAL),
                "kernels": _KERNELS_TOTAL["audited"]}


# -- per-(plan, shapes, mode) memo: audit once per compiled closure ------

_MEMO: "collections.OrderedDict[tuple, dict]" = collections.OrderedDict()
_MEMO_MAX = 128
_MEMO_LOCK = threading.Lock()


def clear_audit_memo() -> None:
    """Drop memoized audit reports (exec/plan_cache.py::clear_plan_cache
    calls it, so the two lifecycles stay in step)."""
    with _MEMO_LOCK:
        _MEMO.clear()


def kernel_audit_enabled(session) -> bool:
    """Session property ``kernel_audit``; process default from
    ``PRESTO_TPU_KERNEL_AUDIT``."""
    import os
    env_on = os.environ.get(AUDIT_ENV, "0") not in ("0", "", "false")
    from ..utils.config import session_flag
    return session_flag(session, "kernel_audit", env_on)


def _budget(session) -> int:
    from ..utils.config import session_value
    try:
        return int(session_value(session, "kernel_audit_budget_bytes", 0)
                   or 0)
    except (TypeError, ValueError):
        return 0


def trace_closure(fn, batches: Sequence, label: str, *, mesh=None,
                  budget: int = 0, donate: Sequence[int] = ()):
    """Run a lowered closure once under the recorder, apart from the
    query's books (module docstring), and return its KernelTrace."""
    from ..exec.stats import collecting
    from ..ops import aggregation
    from ..parallel import exchange
    from .core import KernelTrace
    hash_stats = dict(aggregation.HASH_STATS)
    received = exchange.RECEIVED
    exchange.RECEIVED = None
    try:
        with collecting(None):
            return KernelTrace.trace(
                fn, batches, label, donate=donate,
                device=mesh.devices[0] if mesh is not None else None,
                exchange_devices=mesh.devices if mesh is not None else (),
                footprint_budget_bytes=budget)
    finally:
        aggregation.HASH_STATS.clear()
        aggregation.HASH_STATS.update(hash_stats)
        exchange.RECEIVED = received


def audit_staged_query(plan, batches, *, mesh=None, query_id: str = "query",
                       session=None, collector=None, stats=None,
                       memory_pool=None, plan_fp: str = "",
                       donate: Sequence[int] = ()) -> Optional[dict]:
    """Audit one staged closure (`plan`: a CompiledPlan). Returns the
    report ``{findings: {code: n}, suppressed, peak_bytes_estimate,
    memo_hit}``, or None when the passes failed (counted suppressed).
    `plan_fp` is the plan's fingerprint (the memo's key), `stats` the
    run's flat stats dict, `donate` the input positions the region
    executor will hand over."""
    key = _memo_key(batches, mesh, session, plan_fp, donate)
    with _MEMO_LOCK:
        hit = _MEMO.get(key)
        if hit is not None:
            _MEMO.move_to_end(key)
            report = dict(hit, memo_hit=True)
    if hit is None:
        kernel = trace_closure(plan.fn, batches, query_id, mesh=mesh,
                               budget=_budget(session), donate=donate)
        try:
            report = _report(kernel)
        except Exception as e:  # noqa: BLE001 - never fails the query
            from ..server.metrics import record_suppressed
            record_suppressed("kernel_audit", "staged_trace", e)
            return None
        with _TOTALS_LOCK:
            _KERNELS_TOTAL["audited"] += 1
        with _MEMO_LOCK:
            _MEMO[key] = report
            while len(_MEMO) > _MEMO_MAX:
                _MEMO.popitem(last=False)
    # surface the report on this query's telemetry even for memo hits:
    # QueryStats is per-query, the memo only skips the re-run
    by_code = report["findings"]
    total = sum(by_code.values())
    with _TOTALS_LOCK:
        for code, n in by_code.items():
            _FINDINGS_TOTAL[code] = _FINDINGS_TOTAL.get(code, 0) + n
    if collector is not None:
        collector.note("kernel_audit_kernels")
        for code, n in sorted(by_code.items()):
            collector.note(f"kernel_audit.{code}", n)
        if report["peak_bytes_estimate"]:
            # counters merge by SUMMATION across tasks: on the fragment
            # tier this is the sum of per-fragment estimates; the
            # per-device peak rides note_audit_estimate below into
            # QueryStats.peak_memory_bytes (which merges by max)
            collector.note("kernel_audit_peak_bytes_estimate",
                           report["peak_bytes_estimate"])
    if stats is not None and total:
        stats["kernel_audit_findings"] = \
            stats.get("kernel_audit_findings", 0) + total
    over_capacity = False
    if memory_pool is not None and report["peak_bytes_estimate"]:
        over_capacity = bool(memory_pool.note_audit_estimate(
            query_id, report["peak_bytes_estimate"]))
        if over_capacity and collector is not None:
            collector.note("kernel_audit_over_pool_capacity")
    from ..server.flight_recorder import record_event
    record_event("kernel_audit", query_id=query_id, findings=total,
                 passes=",".join(f"{c}:{n}"
                                 for c, n in sorted(by_code.items())),
                 peak_bytes=report["peak_bytes_estimate"],
                 over_pool_capacity=over_capacity or None,
                 memo_hit=report["memo_hit"])
    return report


def _memo_key(batches, mesh, session, plan_fp, donate) -> tuple:
    from ..exec.plan_cache import _kernel_mode, _mesh_key
    from .core import tensors_of
    # the inputs' full (shape, dtype) signature: a staging-time widening
    # changes lane dtypes without changing the plan fingerprint
    leaf_sig = tuple((tuple(t.shape), str(t.dtype))
                     for t in tensors_of(list(batches)))
    return (plan_fp, _mesh_key(mesh), _kernel_mode(), _budget(session),
            leaf_sig, tuple(sorted(donate)))


def _report(kernel) -> dict:
    from .core import run_audit
    result = run_audit([kernel])
    by_code: Dict[str, int] = {}
    for f in result.findings:
        by_code[f.code] = by_code.get(f.code, 0) + 1
    return {"findings": by_code, "suppressed": result.suppressed,
            "peak_bytes_estimate":
                int(kernel.notes.get("peak_bytes_estimate", 0)),
            "memo_hit": False}
