"""Memory accounting: the MemoryPool and memory-context analog.

Counterpart of presto_tpu/exec/memory.py. On the card the managed
resource is device memory; PyTorch's caching allocator owns the
allocations, and this layer does admission accounting: the runner
reserves a query's planned scan footprint against a pool before it
stages anything, so a query that cannot fit is refused before the
device runs out. Holders of revocable reservations (spillable state)
register a callback that moves their state to host memory; a
reservation beyond capacity revokes the largest holdings first, then
waits for other queries (when `admission_timeout_s` is set), then
raises MemoryReservationError.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

import torch

from .. import failpoints
from ..block import Batch

__all__ = ["MemoryPool", "MemoryContext", "MemoryReservationError",
           "batch_bytes"]


class MemoryReservationError(RuntimeError):
    pass


def _tensors(obj):
    """Every tensor of a block or batch, children included."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def batch_bytes(batch: Batch) -> int:
    """Device footprint of a Batch: the bytes of every tensor it holds
    (values, null masks, lengths, char matrices, Int128 lanes,
    dictionary indices, nested children and the active mask)."""
    return sum(t.numel() * t.element_size() for t in _tensors(batch))


class MemoryPool:
    """Per-device reservation pool with revocation and peaks."""

    def __init__(self, capacity_bytes: int, name: str = "general",
                 admission_timeout_s: float = 0.0):
        """`admission_timeout_s` > 0 makes a contended reserve() wait for
        other queries to release, up to the timeout, before it fails; a
        request larger than the whole pool fails at once."""
        self.name = name
        self.capacity = capacity_bytes
        self.admission_timeout_s = admission_timeout_s
        self._reserved: Dict[str, int] = {}
        # revocable registrations: id -> (query_id, bytes, callback)
        self._revocables: Dict[int, tuple] = {}
        self._next_rid = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self.revoked_bytes = 0
        self.peak_bytes = 0
        self._query_peak: Dict[str, int] = {}

    @property
    def reserved_bytes(self) -> int:
        with self._lock:
            return sum(self._reserved.values())

    @property
    def free_bytes(self) -> int:
        return self.capacity - self.reserved_bytes

    def register_revocable(self, query_id: str, bytes_: int, revoke_cb
                           ) -> int:
        """Reserve `bytes_` as revocable state; `revoke_cb()` moves the
        state off the device. Returns an id for unregister_revocable."""
        self.reserve(query_id, bytes_)
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            self._revocables[rid] = (query_id, bytes_, revoke_cb)
        return rid

    def unregister_revocable(self, rid: int):
        with self._lock:
            entry = self._revocables.pop(rid, None)
        if entry is not None:
            self.free(entry[0], entry[1])

    def _revoke(self, needed: int) -> int:
        """Revoke registrations, largest first, until `needed` bytes are
        freed or none remain; called without the lock (callbacks move
        device state). A registration is freed whole, even when its
        callback raises."""
        freed_total = 0
        while freed_total < needed:
            with self._lock:
                if not self._revocables:
                    break
                rid, (qid, bytes_, cb) = max(
                    self._revocables.items(), key=lambda kv: kv[1][1])
                del self._revocables[rid]
            try:
                cb()
            finally:
                self.free(qid, bytes_)
                with self._lock:
                    self.revoked_bytes += bytes_
                freed_total += bytes_
        return freed_total

    def reserve(self, query_id: str, bytes_: int):
        """Reserve, revoking spillable state first when the pool is
        full; when the pool is only contended (the request alone fits)
        and admission_timeout_s is set, wait for releases; then raise.
        An injected `oom` at the memory.reserve failpoint raises this
        pool's own refusal."""
        if failpoints.ARMED:
            try:
                failpoints.hit("memory.reserve")
            except failpoints.InjectedOOM as e:
                raise MemoryReservationError(str(e)) from None
        deadline = time.time() + self.admission_timeout_s
        revoke_tried = False
        while True:
            with self._cv:
                total = sum(self._reserved.values()) + bytes_
                if total <= self.capacity:
                    mine = self._reserved.get(query_id, 0) + bytes_
                    self._reserved[query_id] = mine
                    self.peak_bytes = max(self.peak_bytes, total)
                    self._query_peak[query_id] = max(
                        self._query_peak.get(query_id, 0), mine)
                    return
                shortfall = total - self.capacity
                can_revoke = bool(self._revocables) and not revoke_tried
            if can_revoke:
                revoke_tried = self._revoke(shortfall) <= 0
                continue
            remaining = deadline - time.time()
            if bytes_ <= self.capacity and remaining > 0:
                with self._cv:
                    self._cv.wait(min(0.05, remaining))
                revoke_tried = False  # new revocables may have come
                continue
            raise MemoryReservationError(
                f"pool {self.name}: reserve {bytes_} for {query_id} "
                f"exceeds capacity {self.capacity} "
                f"(reserved {self.reserved_bytes})")

    def try_reserve(self, query_id: str, bytes_: int) -> bool:
        try:
            self.reserve(query_id, bytes_)
            return True
        except MemoryReservationError:
            return False

    def free(self, query_id: str, bytes_: Optional[int] = None):
        with self._cv:
            cur = self._reserved.get(query_id, 0)
            if bytes_ is None or bytes_ >= cur:
                self._reserved.pop(query_id, None)
            else:
                self._reserved[query_id] = cur - bytes_
            self._cv.notify_all()

    def query_bytes(self, query_id: str) -> int:
        with self._lock:
            return self._reserved.get(query_id, 0)

    def query_peak_bytes(self, query_id: str, pop: bool = False) -> int:
        """A query's largest reservation; `pop` also forgets it."""
        with self._lock:
            if pop:
                return self._query_peak.pop(query_id, 0)
            return self._query_peak.get(query_id, 0)


@dataclasses.dataclass
class MemoryContext:
    """An operator's share of a query's reservation."""
    pool: MemoryPool
    query_id: str
    tag: str = "user"  # user | system | revocable
    local_bytes: int = 0

    def set_bytes(self, bytes_: int):
        delta = bytes_ - self.local_bytes
        if delta > 0:
            self.pool.reserve(self.query_id, delta)
        elif delta < 0:
            self.pool.free(self.query_id, -delta)
        self.local_bytes = bytes_

    def close(self):
        self.set_bytes(0)
