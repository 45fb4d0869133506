"""perfgate: the performance-regression comparator of the in-engine
sentinel (server/history.py).

Counterpart of presto_tpu/exec/perfgate.py (pure), copied: its
comparator, the live sentinel's `SENTINEL_SPECS` and the offline gate's
`BENCH_SPECS`, which gate a benchmark's artifacts.

The math -- deliberately robust and deliberately boring:

  * baseline center = **median** of the retained samples (a single
    outlier run cannot move it);
  * noise width = **MAD** (median absolute deviation) scaled by 1.4826
    (the consistency constant that makes MAD estimate sigma under
    normal noise);
  * a sample BREACHES when it lands beyond
    ``median +/- max(mad_k * 1.4826 * MAD, rel_threshold * median,
    abs_floor)`` on the metric's worse side. The three-way max means a
    noisy metric widens its own band (MAD term), a quiet metric still
    tolerates proportional drift (rel term), and micro-benchmark jitter
    below the absolute floor never pages anyone.

Everything here is a pure function of its inputs: no clocks, no env
reads, no randomness, so identical samples always give identical
verdicts.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = ["MetricSpec", "SENTINEL_SPECS", "BENCH_SPECS", "median",
           "mad", "noise_band", "compare", "compare_metrics",
           "RollingBaseline"]


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """How one metric is gated.

    ``higher_is_worse``: wall times and staged bytes regress upward;
    throughput (rows/s) regresses downward. ``rel_threshold`` is the
    proportional drift always tolerated (0.5 = +50%); ``abs_floor`` is
    the absolute delta below which a breach is never declared (keeps
    sub-noise metrics from gating); ``mad_k`` scales the measured noise
    band."""
    name: str
    higher_is_worse: bool = True
    rel_threshold: float = 0.5
    abs_floor: float = 0.0
    mad_k: float = 5.0


# What the LIVE sentinel gates per completed query (server/history.py
# feeds these from the QueryStats rollup). Compile time is deliberately
# absent: a first run legitimately pays seconds a repeat does not,
# and wall (which contains it) already gates end-to-end latency.
SENTINEL_SPECS: Sequence[MetricSpec] = (
    MetricSpec("wall_us", rel_threshold=0.75, abs_floor=100_000.0),
    MetricSpec("execute_us", rel_threshold=1.0, abs_floor=100_000.0),
    MetricSpec("staged_bytes", rel_threshold=0.25, abs_floor=1_000_000.0),
    MetricSpec("peak_memory_bytes", rel_threshold=0.5,
               abs_floor=16_000_000.0),
    # estimate-accuracy drift (exec/accuracy.py worst q-error per
    # query): a fingerprint whose estimates DEGRADE across runs --
    # stale connector stats, a data-dependent filter shifting -- fires
    # here before the misestimate is big enough to move latency. The
    # abs_floor is in q-error units: drift inside [1x, 3x] never gates
    # (the planner's UNKNOWN_FILTER_COEFFICIENT guesses live there).
    MetricSpec("max_q_error", rel_threshold=1.0, abs_floor=3.0),
)

# What an offline gate checks per benchmark artifact against a committed
# baseline. Noisy metrics widen their own band through the MAD term;
# staged_mb gates tight (0.1 rel): staged bytes are deterministic per
# (query, kernel mode), so any growth is a real re-widening.
BENCH_SPECS: Sequence[MetricSpec] = (
    MetricSpec("rows_per_sec", higher_is_worse=False,
               rel_threshold=0.6, abs_floor=0.0),
    MetricSpec("query_wall_s", rel_threshold=0.6, abs_floor=0.5),
    MetricSpec("staged_mb", rel_threshold=0.10, abs_floor=8.0,
               mad_k=3.0),
    # concurrent-query throughput: queries/sec regresses down, tail
    # latency up
    MetricSpec("qps", higher_is_worse=False,
               rel_threshold=0.6, abs_floor=0.0),
    MetricSpec("p99_ms", rel_threshold=0.75, abs_floor=25.0),
    # the staging rate of the datapath ledger regresses down
    MetricSpec("staging_gb_per_s", higher_is_worse=False,
               rel_threshold=0.5, abs_floor=0.0),
    # per-query pool peak: deterministic per (query, mode), tight band
    MetricSpec("peak_memory_mb", rel_threshold=0.10, abs_floor=4.0,
               mad_k=3.0),
    # host-staging/device overlap fraction (exec/timeline.py): regresses
    # down; the floor keeps scheduler jitter around zero from tripping it
    MetricSpec("overlap_fraction", higher_is_worse=False,
               rel_threshold=0.5, abs_floor=0.05),
)

# MAD -> sigma consistency constant for normally distributed noise
_MAD_SIGMA = 1.4826


def median(xs: Sequence[float]) -> float:
    """Plain median (no numpy: the comparator must import in stripped
    tooling environments, and n is tiny)."""
    s = sorted(float(x) for x in xs)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def mad(xs: Sequence[float], center: Optional[float] = None) -> float:
    """Median absolute deviation around `center` (default: median)."""
    if not xs:
        return 0.0
    c = median(xs) if center is None else float(center)
    return median([abs(float(x) - c) for x in xs])


def noise_band(samples: Sequence[float], spec: MetricSpec) -> float:
    """Half-width of the acceptance band around the baseline median:
    the widest of measured noise (k * 1.4826 * MAD), proportional
    drift tolerance, and the absolute floor."""
    med = median(samples)
    return max(spec.mad_k * _MAD_SIGMA * mad(samples, med),
               spec.rel_threshold * abs(med),
               spec.abs_floor)


def compare(value: float, samples: Sequence[float],
            spec: MetricSpec) -> Optional[dict]:
    """One sample vs a baseline sample set -> a breach verdict dict, or
    None when the sample sits inside the band (or regressed in the
    GOOD direction -- getting faster never pages). The verdict carries
    everything a report needs: the median it compared against, the band
    it escaped, and the ratio a human reads first."""
    if not samples:
        return None
    med = median(samples)
    band = noise_band(samples, spec)
    v = float(value)
    delta = (v - med) if spec.higher_is_worse else (med - v)
    if delta <= band:
        return None
    return {"metric": spec.name,
            "value": round(v, 6),
            "median": round(med, 6),
            "band": round(band, 6),
            "samples": len(samples),
            "ratio": round(v / med, 4) if med else 0.0,
            "direction": "above" if spec.higher_is_worse else "below"}


def compare_metrics(current: Dict[str, float],
                    baseline: Dict[str, Sequence[float]],
                    specs: Iterable[MetricSpec]) -> List[dict]:
    """Gate a metric vector against per-metric baseline sample sets.
    Metrics absent from either side are skipped (a new metric starts
    collecting, it does not fail the gate)."""
    out: List[dict] = []
    for spec in specs:
        if spec.name not in current:
            continue
        samples = baseline.get(spec.name) or ()
        verdict = compare(current[spec.name], samples, spec)
        if verdict is not None:
            out.append(verdict)
    return out


class RollingBaseline:
    """Per-key rolling baseline: the live sentinel's performance memory.

    Each key (a plan-cache fingerprint on the statement tier) retains
    the last ``window`` observations of each gated metric. ``observe``
    compares FIRST, then folds the sample in -- so a regressed run is
    judged against the history it is about to join, and a sustained
    regression re-baselines itself over the next ``window`` runs
    instead of alarming forever (drift acceptance, the same policy a
    ratcheted lint baseline encodes). Below ``min_samples`` the key is
    warming up and never breaches.

    Bounded two ways: ``window`` samples per (key, metric) and
    ``max_keys`` keys LRU'd on last observation, so an ad-hoc-query
    workload cannot grow it without bound. Not thread-safe by itself --
    the archive that owns it serializes access under its own lock.
    """

    def __init__(self, window: int = 32, min_samples: int = 5,
                 max_keys: int = 256,
                 specs: Sequence[MetricSpec] = SENTINEL_SPECS):
        assert window >= 1 and min_samples >= 1
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.max_keys = int(max_keys)
        self.specs = tuple(specs)
        self._keys: "OrderedDict[str, Dict[str, deque]]" = OrderedDict()

    def observe(self, key: str, metrics: Dict[str, float],
                gate: bool = True) -> List[dict]:
        """Compare `metrics` against the key's baseline (when `gate`),
        then absorb them. Returns the breach verdicts (empty while
        warming up, in-band, or with gating off)."""
        per = self._keys.get(key)
        if per is None:
            per = self._keys[key] = {}
            while len(self._keys) > self.max_keys:
                self._keys.popitem(last=False)
        else:
            self._keys.move_to_end(key)
        breaches: List[dict] = []
        for spec in self.specs:
            if spec.name not in metrics:
                continue
            samples = per.get(spec.name)
            if samples is None:
                samples = per[spec.name] = deque(maxlen=self.window)
            if gate and len(samples) >= self.min_samples:
                verdict = compare(metrics[spec.name], list(samples), spec)
                if verdict is not None:
                    breaches.append(verdict)
            samples.append(float(metrics[spec.name]))
        return breaches

    def samples_of(self, key: str) -> Dict[str, List[float]]:
        """Retained samples per metric (introspection / tests)."""
        per = self._keys.get(key) or {}
        return {m: list(s) for m, s in per.items()}

    def key_count(self) -> int:
        return len(self._keys)

    def warm(self, key: str, metrics: Dict[str, float]) -> None:
        """Absorb a sample WITHOUT comparing (archive reload at server
        start: history replayed from the JSONL ring must not re-fire
        the alarms it already fired when live)."""
        self.observe(key, metrics, gate=False)
