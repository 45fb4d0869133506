"""Bounded exponential backoff with seeded jitter.

Counterpart of presto_tpu/utils/backoff.py: the retry loops of the
worker tier (coordinator resubmission, the client's stale-socket
retry, the announcer's re-registration) wait min(cap, base *
factor**k) with +/-`jitter` fractional noise drawn from a SEEDED PRNG,
so that a failpoint-driven test replays the same delays.
"""

from __future__ import annotations

import random
import time
from typing import List

__all__ = ["Backoff"]


class Backoff:
    """Deterministic-when-seeded exponential backoff.

    ``delay(k) = min(cap, base * factor**k) * (1 + jitter*u_k)`` with
    ``u_k`` uniform in [-1, 1] from ``random.Random(seed)`` -- the k-th
    delay of two instances with the same parameters is identical.
    """

    def __init__(self, base_s: float = 0.05, cap_s: float = 2.0,
                 factor: float = 2.0, jitter: float = 0.5,
                 seed=None):
        assert 0.0 <= jitter < 1.0, jitter
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.factor = float(factor)
        self.jitter = float(jitter)
        self.attempt = 0
        self._rng = random.Random(seed)

    def next_delay(self) -> float:
        """The next delay in seconds (advances the attempt counter)."""
        raw = min(self.cap_s, self.base_s * self.factor ** self.attempt)
        self.attempt += 1
        u = 2.0 * self._rng.random() - 1.0
        return max(0.0, raw * (1.0 + self.jitter * u))

    def sleep(self) -> float:
        """Sleep the next delay; returns the seconds slept."""
        d = self.next_delay()
        if d > 0:
            time.sleep(d)
        return d

    def preview(self, n: int) -> List[float]:
        """The next `n` delays WITHOUT consuming this instance's state
        (a fresh PRNG replays the sequence -- determinism pin)."""
        clone = Backoff(self.base_s, self.cap_s, self.factor,
                        self.jitter)
        clone._rng = random.Random()
        clone._rng.setstate(self._rng.getstate())
        clone.attempt = self.attempt
        return [clone.next_delay() for _ in range(n)]
