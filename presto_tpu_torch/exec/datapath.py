"""Data-path waterfall: per-hop byte/throughput attribution with
roofline bottleneck verdicts.

Counterpart of presto_tpu/exec/datapath.py: the same hop catalog
(`HOPS`), `HopStats` merge law, ambient per-query `DatapathLedger`,
process registry, ceilings probe, bottleneck verdict and /v1/datapath
document shapes, so a slice from either package merges into the
other's cluster view.

Model -- three layers, one merge law:

  * ``HopStats`` -- one mergeable record per hop (bytes, wall micros,
    invocations, max wall): sums add, maxes max, the zero record the
    identity, so worker slices stitch through the task-status path
    (``QueryStats.datapath``).
  * the ambient per-query ledger (``DatapathLedger`` + ``recording``):
    exec/runner.py installs one around each run_query; every
    instrumented seam calls :func:`record_hop`, which folds into the
    ambient ledger, the process-lifetime registry, the
    ``presto_tpu_datapath_bytes`` size histogram and the timeline
    (exec/timeline.py).
  * the process-lifetime registry: ``GET /v1/datapath`` (workers serve
    it, the statement tier merges slices cluster-wide) and
    ``system.datapath``.

Hops in the port:

  connector_read      host column materialization (generator or file)
  decode              file row groups and SerializedPage payloads
                      decoded into engine arrays
  narrow_cast         the staging-time range re-proof of narrow lanes
  device_put          host -> device staging (batch_from_numpy); on
                      CUDA the copy from pageable memory returns when
                      it has landed, so the host wall is the transfer
  kernel              the dispatch span of the plan on the device:
                      the stream time between a CUDA event pair around
                      each dispatch of the ladder, read after the run's
                      final fetch (no added sync). The span also holds
                      the stream waiting while the host enqueues the
                      plan's launches, so it bounds the device's busy
                      time from above; on the CPU the host wall of the
                      dispatch
  exchange_serialize  SerializedPage production
  exchange_fetch      cross-worker page pull + decode + restage
  client_drain        statement-protocol result polling (HTTP bytes)

Ceilings probe: one-shot microbenchmarks of host memcpy, a host ->
device copy from pageable memory (the copy staging makes) timed to its
completion by CUDA events (a CPU tensor copy where there is no CUDA
device), page serde and loopback HTTP, cached per process; a probe
that fails leaves its ceiling out. The verdict (:func:`bottleneck_verdict`) is a pure
function of (hop records, ceilings, band).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import uuid
from typing import Dict, List, Optional

from ..utils.locks import OrderedLock


__all__ = ["HOPS", "CEILING_KEYS", "HOP_CEILING", "HopStats",
           "DatapathLedger", "recording", "record_hop", "timed_hop",
           "now_us",
           "device_hop", "hop_device_us", "resolve_device_hops",
           "merge_hop_maps", "hop_map_to_json", "hop_map_from_json",
           "probe_ceilings", "ceilings_cached", "achieved_b_per_s",
           "bottleneck_verdict", "datapath_doc", "merge_datapath_docs",
           "cluster_datapath_doc", "process_totals", "snapshot",
           "staging_summary", "note_query", "datapath_for_query",
           "clear_datapath"]

# the hop catalog: ONE closed vocabulary every surface shares (metrics
# label presets, /v1/datapath zero shape, system.datapath rows, the
# EXPLAIN ANALYZE tail). Order is data-path order; renderers keep it.
HOPS = ("connector_read", "decode", "narrow_cast", "device_put",
        "kernel", "exchange_serialize", "exchange_fetch", "client_drain")

# which measured ceiling bounds each hop (the roofline each utilization
# ratio is computed against). `kernel` uses the device_put bandwidth as
# its proxy, as in the reference: the ledger has no finer roofline for
# a whole plan's execution.
CEILING_KEYS = ("host_memcpy", "device_put", "page_serde",
                "loopback_http")
HOP_CEILING = {
    "connector_read": "host_memcpy",
    "decode": "host_memcpy",
    "narrow_cast": "host_memcpy",
    "device_put": "device_put",
    "kernel": "device_put",
    "exchange_serialize": "page_serde",
    "exchange_fetch": "loopback_http",
    "client_drain": "loopback_http",
}

# one id per process: the cluster merge deduplicates slices by it, so
# two server shells over one process (the test topology) count once
_PROCESS_ID = uuid.uuid4().hex

# utilization below this fraction of the hop's ceiling marks the hop
# as under-performing (verdict-eligible); callers can widen/narrow
_DEFAULT_BAND = 0.5


def now_us() -> int:
    """The per-process monotonic microsecond clock -- the ONE clock
    the hop walls and the timeline interval ledger (exec/timeline.py)
    share, so a hop's wall_us sum and its intervals' duration sum
    reconcile by construction (pinned within 1% on q1). Monotonic:
    never steps backward under NTP slew, so intervals cannot go
    negative on the recording process."""
    return int(time.monotonic() * 1e6)


@dataclasses.dataclass
class HopStats:
    """One hop's accumulated bytes/wall. Merges with the usual law:
    sums add, maxes max -- associative and commutative with the zero
    record as identity, like QueryStats."""
    hop: str
    bytes: int = 0
    wall_us: int = 0
    invocations: int = 0
    max_wall_us: int = 0

    def merge(self, other: "HopStats") -> "HopStats":
        assert self.hop == other.hop, \
            f"merging hops {self.hop} != {other.hop}"
        return HopStats(
            hop=self.hop,
            bytes=self.bytes + other.bytes,
            wall_us=self.wall_us + other.wall_us,
            invocations=self.invocations + other.invocations,
            max_wall_us=max(self.max_wall_us, other.max_wall_us))

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, doc: dict) -> "HopStats":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in known})


def achieved_b_per_s(nbytes: int, wall_us: int) -> float:
    """Achieved throughput of one hop record (0.0 when no wall was
    measured -- an unachieved rate, not infinity)."""
    return float(nbytes) / (wall_us / 1e6) if wall_us else 0.0


def merge_hop_maps(a: Dict[str, HopStats],
                   b: Dict[str, HopStats]) -> Dict[str, HopStats]:
    """Fold two hop maps by key (HopStats.merge's law lifts to maps:
    still associative + commutative, empty map as identity)."""
    out = dict(a)
    for k, h in b.items():
        out[k] = out[k].merge(h) if k in out else h
    return out


def hop_map_to_json(hops: Dict[str, HopStats]) -> Dict[str, dict]:
    return {k: h.to_json() for k, h in hops.items()}


def hop_map_from_json(doc: Dict[str, dict]) -> Dict[str, HopStats]:
    out = {}
    for k, h in (doc or {}).items():
        hs = HopStats.from_json({"hop": k, **h})
        out[k] = hs
    return out


class DatapathLedger:
    """Per-query hop accumulator (the ambient collection target).
    Thread-safe: a future pipelined staging path records from host
    prefetch threads while the dispatch thread records the kernel."""

    _GUARDED_BY = {"_lock": ("hops",)}

    def __init__(self):
        self.hops: Dict[str, HopStats] = {}
        # device hops timed by CUDA events, waiting for the run's final
        # fetch to resolve them: (hop, bytes, start event, end event,
        # split id, compile seconds paid inside the pair)
        self.pending: List[tuple] = []
        self._lock = OrderedLock("datapath.DatapathLedger._lock")

    def record(self, hop: str, nbytes: int, wall_us: int) -> None:
        with self._lock:
            h = self.hops.get(hop)
            if h is None:
                h = self.hops[hop] = HopStats(hop)
            h.bytes += int(nbytes)
            h.wall_us += int(wall_us)
            h.invocations += 1
            h.max_wall_us = max(h.max_wall_us, int(wall_us))

    def snapshot_hops(self) -> Dict[str, HopStats]:
        with self._lock:
            return {k: dataclasses.replace(h)
                    for k, h in self.hops.items()}


# -- ambient (thread-local) attribution ---------------------------------

_tls = threading.local()


def _current_ledger() -> Optional[DatapathLedger]:
    return getattr(_tls, "ledger", None)


class recording:
    """Install `ledger` as this thread's ambient datapath target
    (exec/runner.py wraps each run_query; nested invocations shadow
    and restore, like stats.collecting)."""

    def __init__(self, ledger: DatapathLedger):
        self.ledger = ledger

    def __enter__(self):
        self.prev = _current_ledger()
        _tls.ledger = self.ledger
        return self.ledger

    def __exit__(self, *exc):
        _tls.ledger = self.prev
        return False


# -- process registry ----------------------------------------------------

_GUARDED_BY = {"_LOCK": ("_PROCESS", "_QUERY_LEDGERS", "_CEILINGS",
                         "_PROBING")}

# request handlers (/v1/datapath, system tables), engine threads
# (record_hop on the staging/serde hot paths) and the flight recorder
# all touch these
_LOCK = OrderedLock("datapath._LOCK")
_PROCESS: Dict[str, HopStats] = {}
# query id -> hop map (the flight-dump cross-link); bounded like the
# profiler's query->fingerprint table
_QUERY_LEDGERS: "collections.OrderedDict[str, Dict[str, HopStats]]" = \
    collections.OrderedDict()
_QUERY_LEDGERS_MAX = 256
_CEILINGS: Optional[Dict[str, float]] = None
# True while some thread runs the microbenchmarks: concurrent first
# callers must WAIT for that result, not probe simultaneously --
# mutually-contending probes each measure ~half the real bandwidth
# and would cache skewed ceilings process-wide
_PROBING = False
_PROBE_DONE = threading.Event()


def record_hop(hop: str, nbytes: int, seconds: float,
               end_us: Optional[int] = None,
               split_id: int = -1) -> None:
    """Fold one hop observation into the ambient ledger (when one is
    installed), the process-lifetime registry, the per-hop size
    histogram, and the timeline interval ledger (exec/timeline.py --
    the interval's duration IS this record's wall_us, so hop sums and
    interval durations reconcile exactly). ``end_us`` is the window's
    end on the :func:`now_us` clock; callers recording right after
    the window (the coarse paths) may omit it. Never raises: this
    sits on the staging/serde hot paths. Suppressed while the
    ceilings probe runs (the probe calls the very seams it
    measures)."""
    if getattr(_tls, "suppress", False):
        return
    try:
        wall_us = int(round(seconds * 1e6))
        ledger = _current_ledger()
        if ledger is not None:
            ledger.record(hop, nbytes, wall_us)
        with _LOCK:
            h = _PROCESS.get(hop)
            if h is None:
                h = _PROCESS[hop] = HopStats(hop)
            h.bytes += int(nbytes)
            h.wall_us += wall_us
            h.invocations += 1
            h.max_wall_us = max(h.max_wall_us, wall_us)
        t1 = now_us() if end_us is None else int(end_us)
        from .timeline import record_interval
        record_interval(hop, int(nbytes), t1 - wall_us, t1,
                        split_id=split_id)
        from ..server.metrics import observe_histogram
        observe_histogram("presto_tpu_datapath_bytes", float(nbytes),
                          labels={"hop": hop})
    except Exception as e:  # noqa: BLE001 - attribution must never
        # fail the byte stream it observes; leave the counted trace
        try:
            from ..server.metrics import record_suppressed
            record_suppressed("datapath", "record_hop", e)
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


class timed_hop:
    """``with timed_hop("connector_read") as t: ...; t.bytes = n`` --
    records the hop on exit with the measured wall, on the monotonic
    :func:`now_us` clock the interval ledger shares."""

    def __init__(self, hop: str, nbytes: int = 0, split_id: int = -1):
        self.hop = hop
        self.bytes = nbytes
        self.split_id = split_id

    def __enter__(self):
        self.t0_us = now_us()
        return self

    def __exit__(self, *exc):
        end = now_us()
        record_hop(self.hop, self.bytes, (end - self.t0_us) / 1e6,
                   end_us=end, split_id=self.split_id)
        return False


class device_hop:
    """Time one dispatch's span on the device without waiting for it.
    On a CUDA device a pair of timing events is recorded on the current
    stream around the block and queued on the ambient ledger, for
    :func:`resolve_device_hops` to read after the run's final fetch
    has drained the stream: no host sync is added. The span between
    the events is stream time, not busy time: it includes the stream
    idling while the host enqueues the block's launches. On any other device
    (the CPU, where work is synchronous) the block's host wall is
    recorded at once. ``compile_s`` is set by the caller to the host
    compile seconds paid inside the block (a first launch that builds
    its kernel), which the profiler leaves out of device time."""

    def __init__(self, hop: str, nbytes: int = 0, device=None):
        self.hop = hop
        self.bytes = int(nbytes)
        self.cuda = device is not None and \
            getattr(device, "type", str(device).split(":")[0]) == "cuda"
        self.compile_s = 0.0
        self.split_id = -1
        self.dur_us = 0  # the host wall, off CUDA

    def __enter__(self):
        if self.cuda:
            import torch
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        else:
            self.t0_us = now_us()
        return self

    def __exit__(self, *exc):
        if not self.cuda:
            end = now_us()
            self.dur_us = end - self.t0_us
            record_hop(self.hop, self.bytes, self.dur_us / 1e6,
                       end_us=end, split_id=self.split_id)
            return False
        import torch
        e1 = self.e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        ledger = _current_ledger()
        if ledger is not None:
            with ledger._lock:
                ledger.pending.append((self.hop, self.bytes, self.e0, e1,
                                       self.split_id, self.compile_s))
        return False


def hop_device_us(hop: "device_hop") -> int:
    """One device hop's span in microseconds: the host wall off CUDA,
    else its event pair's elapsed time (read only once the stream has
    drained, as resolve_device_hops does)."""
    if not hop.cuda:
        return hop.dur_us
    return max(int(round(hop.e0.elapsed_time(hop.e1) * 1000)), 0)


def resolve_device_hops(ledger: Optional[DatapathLedger]) -> dict:
    """Rebase the ledger's pending CUDA event pairs onto the
    :func:`now_us` clock and record them as hops (and so as device-lane
    intervals). Call only where the stream is already drained (after
    the run's fetch has copied its rows to the host): one anchor event
    is recorded there, its completion polled (cudaEventQuery, not a
    synchronization), and its host time taken as the midpoint of the
    poll window; `anchorSkewUs` is half that window, the bound on how
    far the rebased times can sit from the host clock. Returns
    {"deviceUs": the summed dispatch spans (stream time, host enqueue
    waits included), "compileUs": compile paid inside
    the pairs, "anchorSkewUs": ..., "hops": count}."""
    out = {"deviceUs": 0, "compileUs": 0, "anchorSkewUs": 0, "hops": 0}
    if ledger is None:
        return out
    with ledger._lock:
        pending, ledger.pending = ledger.pending, []
    if not pending:
        return out
    import torch
    anchor = torch.cuda.Event(enable_timing=True)
    before = now_us()
    anchor.record()
    while not anchor.query():
        pass
    after = now_us()
    anchor_us = (before + after) // 2
    out["anchorSkewUs"] = (after - before + 1) // 2
    for hop, nbytes, e0, e1, split_id, compile_s in pending:
        t1 = anchor_us - int(round(e1.elapsed_time(anchor) * 1000))
        dur_us = max(int(round(e0.elapsed_time(e1) * 1000)), 0)
        record_hop(hop, nbytes, dur_us / 1e6, end_us=t1,
                   split_id=split_id)
        out["deviceUs"] += dur_us
        out["compileUs"] += int(round(compile_s * 1e6))
        out["hops"] += 1
    return out


def note_query(query_id: str, hops: Dict[str, HopStats]) -> None:
    """Retain one query's hop map for flight-dump embeds (bounded)."""
    if not hops:
        return
    with _LOCK:
        have = _QUERY_LEDGERS.get(query_id)
        if have is not None:
            _QUERY_LEDGERS[query_id] = merge_hop_maps(have, hops)
            _QUERY_LEDGERS.move_to_end(query_id)
        else:
            _QUERY_LEDGERS[query_id] = dict(hops)
            while len(_QUERY_LEDGERS) > _QUERY_LEDGERS_MAX:
                _QUERY_LEDGERS.popitem(last=False)


def datapath_for_query(query_id: str) -> Dict[str, dict]:
    """The hop map a query id recorded, as JSON rows (flight dumps)."""
    with _LOCK:
        hops = _QUERY_LEDGERS.get(query_id)
        return hop_map_to_json(hops) if hops else {}


def clear_datapath() -> None:
    """Drop the process registry + per-query maps (tests isolate
    state); the cached ceilings survive -- they describe hardware,
    not workload."""
    with _LOCK:
        _PROCESS.clear()
        _QUERY_LEDGERS.clear()


def process_totals() -> Dict[str, HopStats]:
    """Lifetime per-hop totals, every catalog hop present (zero shape
    is stable from process start)."""
    with _LOCK:
        live = {k: dataclasses.replace(h) for k, h in _PROCESS.items()}
    return {hop: live.get(hop, HopStats(hop)) for hop in HOPS}


# -- ceilings probe ------------------------------------------------------


def ceilings_cached() -> Optional[Dict[str, float]]:
    """The cached probe result, or None when nobody probed yet (cheap
    surfaces like /v1/cluster must not pay the probe per frame)."""
    with _LOCK:
        return dict(_CEILINGS) if _CEILINGS is not None else None


def probe_ceilings(refresh: bool = False) -> Dict[str, float]:
    """Measured per-ceiling bytes/s (host memcpy, device_put, page
    serde, loopback HTTP). One-shot: the first call pays the seeded
    microbenchmarks (~0.2s) and the result is cached process-wide;
    ``refresh=True`` re-measures. The MEASUREMENT reads its own clock;
    everything downstream (utilization, verdicts) is a pure function
    of the returned dict. Exactly one thread measures at a time:
    concurrent first callers wait on the prober's result instead of
    running contending microbenchmarks that would each see ~half the
    real bandwidth."""
    global _CEILINGS, _PROBING
    while True:
        with _LOCK:
            if _CEILINGS is not None and not refresh:
                return dict(_CEILINGS)
            if not _PROBING:
                _PROBING = True
                _PROBE_DONE.clear()
                break
        # another thread is measuring: wait for its result, then
        # re-check (bounded, so a died prober cannot park callers;
        # no lock is held across this wait)
        _PROBE_DONE.wait(timeout=30.0)
        refresh = False  # a fresh concurrent measurement satisfies us
    try:
        measured = _measure_ceilings()  # outside the lock: it blocks
        with _LOCK:
            _CEILINGS = measured
    finally:
        with _LOCK:
            _PROBING = False
        _PROBE_DONE.set()
    return dict(measured)


def _measure_ceilings() -> Dict[str, float]:
    """Run the four microbenchmarks with record_hop suppressed (the
    serde/transfer probes exercise the very seams the ledger
    instruments). A probe that fails is counted (record_suppressed)
    and its ceiling left out, so that no utilization or verdict is
    computed from it (a hop without a ceiling reads utilization 0, as
    the kernel-free hops do) -- a broken probe must not take
    /v1/datapath down with it, nor stand in with a made-up rate."""
    _tls.suppress = True
    try:
        out: Dict[str, float] = {}
        for key, fn in (("host_memcpy", _probe_host_memcpy),
                        ("device_put", _probe_device_put),
                        ("page_serde", _probe_page_serde),
                        ("loopback_http", _probe_loopback_http)):
            try:
                out[key] = max(float(fn()), 1.0)
            except Exception as e:  # noqa: BLE001 - a probe that cannot
                # run leaves its ceiling out, counted
                try:
                    from ..server.metrics import record_suppressed
                    record_suppressed("datapath", f"probe_{key}", e)
                except Exception:  # noqa: BLE001
                    pass
        return out
    finally:
        _tls.suppress = False


def _probe_host_memcpy(size: int = 8 << 20, reps: int = 4) -> float:
    import numpy as np
    rng = np.random.default_rng(0)
    buf = rng.integers(0, 255, size=size, dtype=np.uint8)
    t0 = time.perf_counter()
    for _ in range(reps):
        buf = buf.copy()
    dt = time.perf_counter() - t0
    return reps * size / max(dt, 1e-9)


def _probe_device_put(size: int = 8 << 20, reps: int = 2) -> float:
    """Host -> device copies of `size` bytes from pageable memory, the
    copy run_query's staging makes (block._put outside pinned_staging),
    timed from the first copy's start to the last one's completion by
    CUDA events (the probe runs outside any query, so its own wait
    costs no query a sync); a CPU tensor copy where there is no CUDA
    device."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    host = torch.from_numpy(rng.integers(0, 255, size=size,
                                         dtype=np.uint8))
    if not torch.cuda.is_available():
        host.clone()  # warm the path
        t0 = time.perf_counter()
        for _ in range(reps):
            host.clone()
        dt = time.perf_counter() - t0
        return reps * size / max(dt, 1e-9)
    host.to("cuda")  # warm the path
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        host.to("cuda")
    end.record()
    end.synchronize()
    dt = start.elapsed_time(end) / 1e3
    return reps * size / max(dt, 1e-9)


def _probe_page_serde(rows: int = 1 << 18, reps: int = 3) -> float:
    import numpy as np

    from .. import types as T
    from ..serde.pages import deserialize_page, serialize_page
    rng = np.random.default_rng(0)
    vals = rng.integers(-(10 ** 9), 10 ** 9, size=rows, dtype=np.int64)
    nulls = np.zeros(rows, dtype=bool)
    cols = [(T.BIGINT, vals, nulls)]
    raw = vals.nbytes
    t0 = time.perf_counter()
    for _ in range(reps):
        page = serialize_page(cols)
        deserialize_page(page, [T.BIGINT])
    dt = time.perf_counter() - t0
    return reps * 2 * raw / max(dt, 1e-9)


def _probe_loopback_http(size: int = 4 << 20, reps: int = 2) -> float:
    import http.server
    import threading as _threading
    import urllib.request

    import numpy as np
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 255, size=size, dtype=np.uint8).tobytes()

    class _H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802
            self.send_response(200)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, fmt, *args):  # quiet
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _H)
    thread = _threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}/probe"
        with urllib.request.urlopen(url, timeout=10) as r:  # warm
            r.read()
        t0 = time.perf_counter()
        for _ in range(reps):
            with urllib.request.urlopen(url, timeout=10) as r:
                r.read()
        dt = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)
    return reps * size / max(dt, 1e-9)


# -- verdicts ------------------------------------------------------------


def _as_fields(h) -> dict:
    """HopStats or its JSON row -> {bytes, wall_us} (both shapes flow
    through the verdict: QueryStats carries objects, /v1/datapath
    documents carry rows)."""
    if isinstance(h, HopStats):
        return {"bytes": h.bytes, "wall_us": h.wall_us}
    return {"bytes": int(h.get("bytes", 0)),
            "wall_us": int(h.get("wall_us", 0))}


def bottleneck_verdict(hops, ceilings: Dict[str, float],
                       band: float = _DEFAULT_BAND) -> Optional[dict]:
    """The named verdict: among hops with recorded wall, the one with
    the largest wall share whose utilization (achieved/ceiling) sits
    below ``band``; when every hop runs at-or-above band, the largest
    wall share wins with ``belowBand: false`` (the data path is at the
    hardware, and the verdict says which hop dominates anyway). Pure
    function of its inputs -- no clocks, no env -- so identical
    (ledger, ceilings) always name the same hop. None when no hop
    recorded any wall."""
    rows = []
    total_wall = 0
    for hop, h in hops.items():
        f = _as_fields(h)
        if f["wall_us"] <= 0:
            continue
        total_wall += f["wall_us"]
        ceiling = float(ceilings.get(HOP_CEILING.get(hop, ""), 0.0))
        achieved = achieved_b_per_s(f["bytes"], f["wall_us"])
        util = achieved / ceiling if ceiling > 0 else 0.0
        rows.append((hop, f["wall_us"], achieved, ceiling, util))
    if not rows or total_wall <= 0:
        return None
    below = [r for r in rows if r[4] < band]
    pool = below or rows
    # deterministic pick: wall desc, hop name as the tiebreak
    hop, wall, achieved, ceiling, util = \
        sorted(pool, key=lambda r: (-r[1], r[0]))[0]
    return {"hop": hop,
            "wallShare": round(wall / total_wall, 4),
            "utilization": round(util, 4),
            "achievedBPerS": round(achieved, 1),
            "ceilingBPerS": round(ceiling, 1),
            "band": band,
            "belowBand": bool(below)}


# -- surfaces ------------------------------------------------------------


def _hop_row(h: HopStats, ceilings: Dict[str, float]) -> dict:
    achieved = achieved_b_per_s(h.bytes, h.wall_us)
    ceiling = float(ceilings.get(HOP_CEILING.get(h.hop, ""), 0.0))
    return {**h.to_json(),
            "achievedBPerS": round(achieved, 1),
            "ceilingBPerS": round(ceiling, 1),
            "utilization": round(achieved / ceiling, 4)
            if ceiling > 0 else 0.0}


def datapath_doc() -> dict:
    """This process's /v1/datapath slice: every catalog hop (zeros
    included -- the shape is stable from the first request on), the
    measured ceilings, and the process-lifetime bottleneck verdict."""
    ceilings = probe_ceilings()
    totals = process_totals()
    return {"processId": _PROCESS_ID,
            "hops": {hop: _hop_row(h, ceilings)
                     for hop, h in totals.items()},
            "ceilings": {k: round(v, 1) for k, v in ceilings.items()},
            "verdict": bottleneck_verdict(totals, ceilings)}


def merge_datapath_docs(docs: List[dict]) -> dict:
    """Fold per-process slices into one cluster view. Slices sharing a
    processId count once (two server shells over one process report
    the same registry); hop records merge by HopStats' law; ceilings
    merge by max (the fleet's best measured rate is the closest
    estimate of the true hardware ceiling); the verdict is recomputed
    over the merged hops -- order-independent throughout."""
    seen = set()
    hops: Dict[str, HopStats] = {}
    ceilings: Dict[str, float] = {}
    for doc in docs:
        pid = doc.get("processId") or f"anon-{id(doc):x}"
        if pid in seen:
            continue
        seen.add(pid)
        hops = merge_hop_maps(hops, hop_map_from_json(doc.get("hops")))
        for k, v in (doc.get("ceilings") or {}).items():
            ceilings[k] = max(ceilings.get(k, 0.0), float(v))
    full = {hop: hops.get(hop, HopStats(hop)) for hop in HOPS}
    return {"hops": {hop: _hop_row(h, ceilings)
                     for hop, h in full.items()},
            "ceilings": {k: round(v, 1) for k, v in ceilings.items()},
            "verdict": bottleneck_verdict(full, ceilings)}


def cluster_datapath_doc(worker_urls=(), timeout: float = 3.0) -> dict:
    """The coordinator-side merge: this process's slice plus every
    reachable worker's ``GET /v1/datapath``, folded by hop. Pulls ride
    the shared best-effort helper (server/client.pull_worker_docs) so
    bearer/TLS/trace headers -- and the skip-and-count-dead-workers
    contract -- stay identical to the /v1/profile merge's."""
    from ..server.client import pull_worker_docs
    pulled, workers_seen = pull_worker_docs(
        worker_urls, timeout, lambda c: c.datapath(), "datapath")
    merged = merge_datapath_docs([datapath_doc(), *pulled])
    return {"processId": _PROCESS_ID, "cluster": True,
            "workersPulled": workers_seen, **merged}


def snapshot() -> List[dict]:
    """Per-hop rows in data-path order (the system.datapath table),
    every catalog hop present."""
    ceilings = probe_ceilings()
    totals = process_totals()
    return [_hop_row(totals[hop], ceilings) for hop in HOPS]


def staging_summary() -> dict:
    """The cheap /v1/cluster embed: THIS process's lifetime staging
    rate (device_put hop achieved GB/s -- the whole story on the
    embedded statement tier, where queries stage in-process; a
    separate-process fleet's per-worker rates live on the
    cluster-merged /v1/datapath) plus the bottleneck hop name WHEN
    ceilings were already probed -- a cluster frame never pays the
    probe itself."""
    totals = process_totals()
    put = totals["device_put"]
    doc = {"stagingGbPerS": round(
        achieved_b_per_s(put.bytes, put.wall_us) / 1e9, 3)}
    ceilings = ceilings_cached()
    if ceilings:
        verdict = bottleneck_verdict(totals, ceilings)
        doc["bottleneck"] = verdict["hop"] if verdict else ""
    return doc
