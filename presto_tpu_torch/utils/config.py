"""Session properties: the port's copy of the registry and readers of
presto_tpu/utils/config.py.

`SESSION_PROPERTIES` is the reference's registry of session properties
(SystemSessionProperties): name, kind, default and description, as
`system.session_properties` and SHOW SESSION list them. A session is a
plain dict (or any object with `.get`). Boolean properties are parsed
with the registry's coercion, not by truthiness, so the string "false"
turns a flag off; sizes ("12GB") with `parse_size`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

__all__ = ["session_flag", "session_value", "parse_size",
           "SESSION_PROPERTIES", "ConfigSpec", "Property"]


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes", "on")


def parse_size(v) -> int:
    """'512MB', '16GB' or a plain number of bytes -> bytes."""
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().upper()
    for suffix, mult in (("TB", 1 << 40), ("GB", 1 << 30), ("MB", 1 << 20),
                         ("KB", 1 << 10), ("B", 1)):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * mult)
    return int(s)


_KINDS: Dict[str, Callable[[Any], Any]] = {
    "bool": _parse_bool, "int": int, "float": float, "str": str,
    "size": parse_size,
}


@dataclasses.dataclass(frozen=True)
class Property:
    name: str
    kind: str
    default: Any
    description: str = ""


class ConfigSpec:
    """A registry of typed properties with defaults."""

    def __init__(self, name: str):
        self.name = name
        self.properties: Dict[str, Property] = {}

    def add(self, name: str, kind: str, default: Any, description: str = ""):
        if kind not in _KINDS:
            raise ValueError(f"unknown property kind {kind!r}")
        self.properties[name] = Property(name, kind, default, description)
        return self


# the reference's SystemSessionProperties registry, entry for entry


def session_flag(session, name: str, default: bool = True) -> bool:
    """A boolean session property: `default` where the session is None
    or does not set it; otherwise its value under the registry's bool
    coercion."""
    if session is None:
        return default
    try:
        v = session.get(name)
    except (KeyError, TypeError):
        return default
    if v is None:
        return default
    return v if isinstance(v, bool) else _parse_bool(v)


def session_value(session, name: str, default=None):
    """A session property as given, `default` where it is absent."""
    if session is None:
        return default
    try:
        v = session.get(name)
    except (KeyError, TypeError):
        return default
    return default if v is None else v


SESSION_PROPERTIES = (
    ConfigSpec("session")
    .add("tpu_execution_enabled", "bool", True,
         "offload plan fragments to the TPU engine (north-star gate; "
         "pattern: SystemSessionProperties.java:398 native_execution_enabled)")
    .add("query_max_memory", "size", "12GB", "per-query memory cap")
    .add("join_distribution_type", "str", "AUTOMATIC",
         "PARTITIONED | BROADCAST | AUTOMATIC "
         "(DetermineJoinDistributionType analog)")
    .add("join_reordering_strategy", "str", "AUTOMATIC",
         "NONE | AUTOMATIC: statistics-driven left-deep reorder of "
         "inner-join chains (ReorderJoins analog, plan/reorder.py)")
    .add("hash_partition_count", "int", 8,
         "workers per partitioned exchange (FIXED_HASH distribution width)")
    .add("task_concurrency", "int", 1,
         "local drivers per pipeline; on TPU, batches in flight per chip")
    .add("exchange_compression", "str", "none",
         "none | zstd | zlib for cross-slice SerializedPage exchanges")
    .add("stats_capacity_refinement", "bool", True,
         "let connector NDV statistics SHRINK group-table capacities "
         "(plan.stats.refine_capacities); disable when a hand-set "
         "max_groups must stay authoritative")
    .add("iterative_optimizer", "bool", True,
         "run the rule-based simplification + channel-pruning passes "
         "(plan.rules; IterativeOptimizer/PruneUnreferencedOutputs "
         "analog) before capacity refinement and distribution")
    .add("scan_predicate_pushdown", "bool", True,
         "push filter range conjuncts into pushdown-capable connectors "
         "(parquet row-group statistics pruning; plan/pushdown.py)")
    .add("dynamic_filtering", "bool", True,
         "run small dimension build sides first and prune fact scans "
         "by their join-key domains at staging time (exec/dynfilter.py)")
    .add("hbm_budget_bytes", "int", 0,
         "cap on per-query device state; aggregations whose planned "
         "group table exceeds it run grouped-execution spill to host "
         "DRAM (exec/spill.py; 0 = uncapped)")
    .add("fragment_result_cache", "bool", True,
         "replay identical leaf fragments' serialized pages from the "
         "worker's data-versioned cache (FileFragmentResultCacheManager "
         "analog); disable when benchmarking raw execution")
    .add("adaptive_capacity", "bool", True,
         "on bucket overflow, re-plan with geometrically larger "
         "capacities instead of failing (exec/runner.py rerun ladder + "
         "plan-fingerprint feedback)")
    .add("spill_path", "str", "",
         "directory for the DISK spill tier: spilled bucket outputs "
         "flush from host DRAM to .npz run files once they exceed "
         "spill_file_threshold_bytes (FileSingleStreamSpiller/"
         "TempStorage analog; empty = host-DRAM only)")
    .add("spill_file_threshold_bytes", "int", 256 << 20,
         "host-DRAM bytes a spill staging area may hold before "
         "flushing a run file to spill_path")
    .add("narrow_width_execution", "bool", True,
         "stage scan columns at the narrowest physical lane the "
         "connector's range statistics prove safe (plan/widths.py; "
         "dates as epoch-day int16/int32, range-proven int64 as "
         "int32/int16/int8) -- bit-exact, every compute site widens "
         "before arithmetic; env PRESTO_TPU_NARROW=0 disables globally "
         "including the bf16/fused kernel forms")
    .add("fusion", "bool", True,
         "pipeline-region fusion (exec/regions.py): stage each plan "
         "fragment's operator chain as ONE XLA program per pipeline "
         "region, with fusion-plan choice (what to fuse vs materialize) "
         "driven by K005 footprint estimates against "
         "kernel_audit_budget_bytes and the continuous profiler's "
         "per-fingerprint device time (regressing fused regions demote "
         "back to materialized boundaries). false = one program per "
         "operator, the A/B + bisection mode (env PRESTO_TPU_FUSION, "
         "registered in KERNEL_MODE_ENVS)")
    .add("buffer_donation", "bool", False,
         "donate dead region-boundary buffers to XLA on proven-safe "
         "dispatches (exec/donation.py): inputs the kernaudit K006 "
         "proof shows aliasable into an output AND whose last consumer "
         "is this dispatch are passed with donate_argnums, so XLA "
         "reuses their HBM for the region's output -- peak residency "
         "drops by the donated bytes (QueryStats.peak_memory_bytes, "
         "presto_tpu_donated_bytes_total). Only overflow-incapable "
         "regions donate (a rerun would re-read freed buffers); any "
         "donation-path error falls back to the undonated dispatch "
         "(env PRESTO_TPU_DONATION, registered in KERNEL_MODE_ENVS)")
    .add("query_cost_analysis", "bool", False,
         "annotate QueryStats' compile stage with XLA cost_analysis "
         "FLOPs / bytes-accessed (costs one extra program trace per "
         "distinct plan+shape, memoized; EXPLAIN ANALYZE, the CLI "
         "--stats flag and bench.py's telemetry smoke turn it on)")
    .add("kernel_audit", "bool", False,
         "run the kernaudit IR passes (presto_tpu/audit/) over the "
         "staged program at staging time: findings land in QueryStats "
         "counters + presto_tpu_kernel_audit_findings_total{pass} on "
         "/v1/metrics + a flight-recorder event (costs one extra trace "
         "per distinct plan+shape, memoized; env default "
         "PRESTO_TPU_KERNEL_AUDIT)")
    .add("kernel_audit_budget_bytes", "int", 0,
         "K005 intermediate-footprint budget for live-query audits: "
         "kernels whose estimated peak live bytes exceed it are "
         "findings (0 = report the estimate without gating)")
    .add("failpoints", "str", "",
         "fault-injection schedule applied for this query's execution "
         "scope and restored afterwards: 'site=action:trigger,...' "
         "(presto_tpu/failpoints grammar; same as the "
         "PRESTO_TPU_FAILPOINTS env var and POST /v1/failpoint). "
         "Empty = no injection; the subsystem is zero-cost disarmed")
    .add("stuck_query_threshold_ms", "float", 0.0,
         "stuck-progress watchdog threshold: a non-terminal query/task "
         "whose live-progress last-advance age (exec/progress.py) "
         "exceeds this fires presto_tpu_stuck_queries_total, a "
         "flight-recorder stuck_progress event and a reason=stuck "
         "flight dump -- orthogonal to slow_query_threshold_ms, which "
         "fires on TOTAL wall time (env fallback PRESTO_TPU_STUCK_MS; "
         "0 disables)")
    .add("slow_query_threshold_ms", "float", 0.0,
         "slow-query flight-dump threshold: a query whose TOTAL wall "
         "time exceeds this auto-dumps the flight-recorder ring once "
         "on completion (server/statement.py _slow_threshold_ms; env "
         "fallback PRESTO_TPU_SLOW_QUERY_MS; 0 disables) -- orthogonal "
         "to stuck_query_threshold_ms, which fires on live-progress "
         "stall age")
    .add("queue_timeout_s", "float", 60.0,
         "admission-queue patience (server/dispatcher.py submit): how "
         "long a statement waits in the resource-group queue before "
         "QUERY_QUEUE_FULL; the registry default is what statement "
         "submission uses when the session carries no override")
    .add("speculative_execution_threshold_ms", "float", 0.0,
         "straggler mitigation: a remote task whose live-progress "
         "last-advance age (exec/progress.py -- the stuck-watchdog's "
         "signal) exceeds this is speculatively re-submitted to "
         "another worker; first FINISHED attempt wins, the loser is "
         "aborted, and the winner alone feeds consumers (exactly-once "
         "by construction). Orthogonal to stuck_query_threshold_ms, "
         "which only OBSERVES the stall. Resolved by "
         "Coordinator.execute(session=...) -- embeddings that drive a "
         "Coordinator pass their session through; the constructor arg "
         "and the PRESTO_TPU_SPECULATION_MS env cover the rest "
         "(0 disables)")
    .add("drain_timeout_ms", "float", 30000.0,
         "graceful-drain budget (POST /v1/worker/drain): how long a "
         "DRAINING worker waits for running tasks to finish and its "
         "buffered result pages to migrate/be consumed before giving "
         "up on unannouncing; this spec's default is what "
         "begin_drain uses when the request body carries no "
         "timeoutMs (server/worker.py)")
    .add("query_batching", "bool", True,
         "concurrent-query batching (exec/batching.py): queries whose "
         "plans differ only in parameterizable literals share ONE "
         "vmapped dispatch -- grouped by (template plan fingerprint, "
         "kernel-mode envs), literals lifted into a parameter vector, "
         "results fanned back bit-identically to serial execution. "
         "false = the serial A/B control scripts/loadgen.py measures "
         "against (env PRESTO_TPU_BATCHING, registered in "
         "KERNEL_MODE_ENVS)")
    .add("batch_window_ms", "float", 5.0,
         "batch formation window: how long the FIRST arrival of a hot "
         "plan fingerprint waits for co-batchable followers before "
         "dispatching (cold fingerprints never wait; hotness is the "
         "fingerprint's recent frequency, seeded from the query-history "
         "archive)")
    .add("batch_max_size", "int", 64,
         "queries per batched dispatch cap; a forming batch seals "
         "early when it fills")
    .add("batch_hot_min", "int", 2,
         "submissions of a plan fingerprint (recent in-process + "
         "history-archive counts) before it is HOT enough to pay the "
         "formation window; <=1 = every batchable query windows")
    .add("latency_class", "str", "",
         "resource-group latency class for admission-to-SLO "
         "(interactive | dashboard | batch, or an explicit dotted "
         "group path) -- dispatchers built with "
         "Dispatcher.with_latency_classes route on it: interactive "
         "preempts scans at admission (higher priority + weight), "
         "per-class concurrency and queue-depth limits apply "
         "(empty = the dispatcher's default group)")
    .add("continuous_profiling", "bool", True,
         "accumulate per-kernel device-time profiles keyed by plan "
         "fingerprint (exec/profiler.py): calls, block_until_ready "
         "device wall, rows/bytes in-out, retraces; served at "
         "GET /v1/profile and SELECT * FROM system.kernels (env "
         "default PRESTO_TPU_PROFILE; on by default -- the overhead "
         "is one clock pair and a dict update per query)")
    .add("timeline", "bool", True,
         "record per-query execution-timeline intervals (exec/"
         "timeline.py): (lane, hop, split, t0, t1, bytes) spans at the "
         "datapath seams, powering occupancy/bubble verdicts, "
         "GET /v1/timeline, system.occupancy and the Chrome trace "
         "export (env default PRESTO_TPU_TIMELINE; on by default -- "
         "bounded to 4096 intervals per query, totals-only beyond)")
)
