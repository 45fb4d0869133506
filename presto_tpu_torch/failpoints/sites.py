"""The failpoint site catalog: every named injection point.

Counterpart of presto_tpu/failpoints/sites.py. Each row is a
``<layer>.<verb>`` name with its layer and what it injects; the admin
document of ``GET /v1/failpoint`` serves it. Every site is hooked
where its module is. The statement tier hooks
`statement.execute`, the dispatcher `dispatcher.admit`, the batching
executor `dispatcher.batch_collapse` (exec/batching.py), the runner
`fusion.demote` (exec/runner.py), buffer donation `donation.apply`
(exec/donation.py::prepare_donation), the worker's drain
`worker.drain_stall`, the announcer's goodbye
`discovery.unannounce_lost` and the resource manager's heartbeat
`coordinator.heartbeat_lapse`.
"""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["SITES", "sites_by_layer"]

# name -> (layer, description). Layers mirror the engine's seams; the
# chaos soak's coverage invariant counts DISTINCT LAYERS fired.
SITES: Dict[str, Tuple[str, str]] = {
    "exchange.fetch": (
        "exchange",
        "cross-worker page pull entry (http_exchange.fetch_remote_batch): "
        "a consumer task's view of a dead/slow upstream"),
    "exchange.serve": (
        "exchange",
        "worker result-buffer serve (GET /v1/task/.../results/...): "
        "drop_conn here exercises the client's stale-socket retry"),
    "serde.serialize": (
        "serde",
        "SerializedPage encode epilogue (serde/pages.serialize_page): "
        "corrupt_page flips payload bytes AFTER the checksum is stamped"),
    "serde.deserialize": (
        "serde",
        "SerializedPage decode entry (serde/pages.deserialize_page): "
        "corrupt_page feeds the checksum/bounds validation paths"),
    "task.submit": (
        "task",
        "coordinator task-submission hop (Coordinator._submit): "
        "errors exercise submission failover to the next worker"),
    "task.status": (
        "task",
        "coordinator task-status poll (Coordinator._await_or_retry): "
        "errors exercise abort + resubmit-elsewhere recovery"),
    "task.result": (
        "task",
        "coordinator final result pull (fetch_results): errors exercise "
        "the re-run-final-task recovery path"),
    "worker.run_task": (
        "task",
        "worker task execution entry (TaskManager._run_task, after the "
        "RUNNING transition): error = crash mid-task, hang/delay = "
        "wedged or slow worker"),
    "client.request": (
        "task",
        "WorkerClient HTTP request (one per hop): drop_conn exercises "
        "the stale-keep-alive retry with backoff"),
    "discovery.announce": (
        "discovery",
        "worker announcement PUT (Announcer.announce_once): a worker "
        "that cannot reach discovery"),
    "discovery.probe": (
        "discovery",
        "heartbeat probe (HeartbeatProber._probe): a probe failure "
        "feeds the decayed failure rate that gates scheduling"),
    "dispatcher.admit": (
        "dispatcher",
        "query admission entry (Dispatcher.submit, before the resource-"
        "group queue): delay = admission stall, error = failed dispatch"),
    "memory.reserve": (
        "memory",
        "HBM admission reservation (MemoryPool.reserve): the oom action "
        "surfaces as MemoryReservationError, the real refusal path"),
    "spill.write": (
        "spill",
        "spill run-file flush (exec/spill._HostRows._flush_run): a full "
        "or broken spill disk"),
    "spill.read": (
        "spill",
        "spill run-file re-read (exec/spill._HostRows.columns): a run "
        "file that vanished or rotted between write and read"),
    "statement.execute": (
        "statement",
        "statement-tier engine execution entry (StatementServer."
        "_run_engine): hang here pins the client's poll deadline"),
    "discovery.unannounce_lost": (
        "discovery",
        "graceful-goodbye DELETE (Announcer.stop unannounce): an error "
        "here loses the unannouncement, so the node lingers in "
        "discovery until its announcement ages out -- the silent-"
        "age-out path the elastic-fleet membership code must survive"),
    "worker.drain_stall": (
        "fleet",
        "graceful-drain migration step (TpuWorkerServer.begin_drain, "
        "after running tasks settle, before buffered pages migrate): "
        "delay/hang = a drain stuck behind a slow peer, error = a "
        "migration hop that dies mid-drain (pages stay local and are "
        "served until consumed -- drain degrades, never loses pages)"),
    "coordinator.heartbeat_lapse": (
        "fleet",
        "coordinator->resource-manager heartbeat send "
        "(ClusterStateSender.send_once): error = a lost heartbeat; "
        "enough consecutive losses age the primary out of the RM view "
        "and the standby's failover monitor takes over statement "
        "execution (server/resource_manager.StandbyCoordinator)"),
    "dispatcher.batch_collapse": (
        "dispatcher",
        "formed-batch dispatch gate (exec/batching.py, after the "
        "formation window seals, before the vmapped dispatch): an "
        "error action COLLAPSES the batch back to serial per-query "
        "dispatch mid-flight -- every member must still match its "
        "serial oracle, the fallback is counted "
        "presto_tpu_batch_collapses_total{reason=failpoint} and "
        "recorded as a batch_collapse flight event"),
    "fusion.demote": (
        "fusion",
        "pipeline-region fusion gate (exec/runner.py, before dispatch "
        "of a fused multi-op region): an error action forces the span "
        "to DEMOTE mid-query -- the query re-partitions and runs with "
        "materialized boundaries, and the demotion sticks for later "
        "submissions (exec/regions.FusionMemory)"),
    "donation.apply": (
        "fusion",
        "buffer-donation prepare step (exec/donation.prepare_donation, "
        "before any buffer is consumed): an error action collapses the "
        "region to the normal undonated dispatch -- results must still "
        "match the donation-off oracle, the fallback is counted "
        "presto_tpu_donation_fallbacks_total and recorded as a "
        "donation_fallback flight event"),
    "timeline.record": (
        "timeline",
        "execution-timeline interval append (exec/timeline."
        "record_interval, before the ledger fold): an error action "
        "degrades the query's ledger STICKY to counted totals -- "
        "intervals drop (counted in `dropped`), the query succeeds with "
        "matching rows, the degradation is counted in the process "
        "registry and recorded as a timeline_degraded flight event"),
}


def sites_by_layer() -> Dict[str, list]:
    """{layer: [site, ...]} over the committed catalog (schedule
    generators pick per-layer; deterministic order)."""
    out: Dict[str, list] = {}
    for name in sorted(SITES):
        out.setdefault(SITES[name][0], []).append(name)
    return out
