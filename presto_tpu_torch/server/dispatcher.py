"""Dispatcher: query admission through resource groups, then execution.

Counterpart of presto_tpu/server/dispatcher.py (DispatchManager's
createQuery, InternalResourceGroupManager's hierarchical admission,
QueuedStatementResource's queue-then-run flow). Named resource groups
carry a hard concurrency limit, a queue cap and an optional memory
cap; a selector picks a group from the session; a query blocks in its
group's queue until a slot frees, runs through its executor, and fires
QueryCreated and QueryCompleted (server/events.py).

With `resource_manager_url` and `cluster_limits` ({group path:
cluster-wide concurrency}), admission also waits while the other
coordinators' running queries, as the resource manager aggregates them
(server/resource_manager.py), fill a cluster limit of the group or of
any ancestor; when the resource manager cannot be reached, admission
is local only (the reference's degraded mode), counted. Each
admission's wait feeds the `presto_tpu_dispatch_queue_wait_seconds`
histogram of /v1/metrics, labelled by its resource group.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from .. import failpoints
from ..utils.config import parse_size
from .events import event_listeners
from ..utils.locks import OrderedLock

__all__ = ["ResourceGroup", "Dispatcher", "QueryRejected",
           "LATENCY_CLASSES", "latency_class_groups",
           "latency_class_selector"]


class QueryRejected(RuntimeError):
    """Admission refused: a full queue, a queue wait past its timeout,
    a memory ask over a cap, or no matching group."""


@dataclasses.dataclass
class ResourceGroup:
    """A node of a resource-group tree (InternalResourceGroup). A query
    admitted into a leaf holds one concurrency slot and its memory in
    the leaf and every ancestor, so a parent's limits cap its subtree.
    Among waiters that fit, the highest `priority` goes first, then
    the leaf with the lowest running/weight ratio (WEIGHTED_FAIR), then
    the earliest ticket.

    One condition per tree (the root's) guards every group's counters.
    Every departure from the queue, admitted or timed out, and every
    release wakes all waiters (notify_all): a waiter that timed out may
    have taken a single notify without taking the slot, and a
    differently shaped waiter may fit now."""

    # tpulint C001: admission state is written through WHATEVER
    # receiver walks the tree (g/root/leaf) while holding the ONE
    # per-tree condition -- _cv is a shared lock, any receiver counts
    _GUARDED_BY = {"_cv": ("_running", "_queued", "_mem_used",
                           "_ticket", "_waiters")}
    _GUARDED_BY_SHARED = ("_cv",)

    name: str
    hard_concurrency_limit: int = 4
    max_queued: int = 16
    soft_memory_limit_bytes: Optional[int] = None
    scheduling_weight: int = 1
    priority: int = 0

    def __post_init__(self):
        self._running = 0
        self._queued = 0
        self._mem_used = 0
        self.parent: Optional["ResourceGroup"] = None
        self.children: Dict[str, "ResourceGroup"] = {}
        self._cv = threading.Condition(OrderedLock("dispatcher.ResourceGroup._cv"))
        self._waiters: List[tuple] = []  # (ticket, leaf, mem), at the root
        self._ticket = 0

    # -- the tree ----------------------------------------------------------

    def add_child(self, child: "ResourceGroup") -> "ResourceGroup":
        child.parent = self
        root = self._root()
        for g in child._subtree():
            g._cv = root._cv
        self.children[child.name] = child
        return child

    def _root(self) -> "ResourceGroup":
        g = self
        while g.parent is not None:
            g = g.parent
        return g

    def _subtree(self):
        yield self
        for c in self.children.values():
            yield from c._subtree()

    def _chain(self):
        g = self
        while g is not None:
            yield g
            g = g.parent

    def find(self, dotted: str) -> Optional["ResourceGroup"]:
        """The group at "etl.nightly", relative to this one."""
        g = self
        for part in dotted.split("."):
            if part == g.name and g is self:
                continue
            g = g.children.get(part)
            if g is None:
                return None
        return g

    def stats(self) -> Dict[str, int]:
        with self._cv:
            out = {"running": self._running, "queued": self._queued,
                   "hardConcurrencyLimit": self.hard_concurrency_limit,
                   "maxQueued": self.max_queued,
                   "schedulingWeight": self.scheduling_weight,
                   "priority": self.priority,
                   "memoryUsedBytes": self._mem_used}
            if self.soft_memory_limit_bytes is not None:
                out["softMemoryLimitBytes"] = self.soft_memory_limit_bytes
            return out

    # -- admission ---------------------------------------------------------

    def _capacity_now(self, mem: int) -> bool:
        for g in self._chain():
            if g._running >= g.hard_concurrency_limit:
                return False
            if g.soft_memory_limit_bytes is not None and \
                    g._mem_used + mem > g.soft_memory_limit_bytes:
                return False
        return True

    def _my_turn(self, root: "ResourceGroup", ticket: int, mem: int) -> bool:
        """Whether the waiter `ticket` fits now and is the best waiter
        that fits (priority, then running/weight, then ticket)."""
        if not self._capacity_now(mem):
            return False
        best = None
        for tkt, leaf, wmem in root._waiters:
            if not leaf._capacity_now(wmem):
                continue
            key = (-leaf.priority,
                   leaf._running / max(leaf.scheduling_weight, 1), tkt)
            if best is None or key < best:
                best = key
        return best is not None and best[2] == ticket

    def acquire(self, timeout: Optional[float] = None, mem: int = 0):
        """Wait for a slot (and `mem` bytes) in this group and all its
        ancestors; QueryRejected if a queue is full, `mem` can never
        fit, or `timeout` s pass first."""
        root = self._root()
        with self._cv:
            for g in self._chain():
                if g.soft_memory_limit_bytes is not None and \
                        mem > g.soft_memory_limit_bytes:
                    raise QueryRejected(
                        f"query memory {mem} exceeds group "
                        f"{g.name!r} limit {g.soft_memory_limit_bytes}")
                if g._queued >= g.max_queued:
                    raise QueryRejected(
                        f"resource group {g.name!r} queue is full "
                        f"({g.max_queued})")
            for g in self._chain():
                g._queued += 1
            root._ticket += 1
            me = (root._ticket, self, mem)
            root._waiters.append(me)
            deadline = None if timeout is None else time.time() + timeout
            try:
                while not self._my_turn(root, me[0], mem):
                    remaining = None if deadline is None \
                        else deadline - time.time()
                    if remaining is not None and remaining <= 0:
                        raise QueryRejected(
                            f"query queued in {self.name!r} longer than "
                            f"{timeout}s")
                    self._cv.wait(remaining)
            finally:
                root._waiters.remove(me)
                for g in self._chain():
                    g._queued -= 1
                self._cv.notify_all()
            for g in self._chain():
                g._running += 1
                g._mem_used += mem

    def release(self, mem: int = 0):
        with self._cv:
            for g in self._chain():
                g._running -= 1
                g._mem_used -= mem
            self._cv.notify_all()


# interactive lookups go before dashboard refreshes before batch scans
LATENCY_CLASSES = ("interactive", "dashboard", "batch")


def latency_class_groups(root_concurrency: int = 64,
                         root_queued: int = 1024) -> ResourceGroup:
    """The latency-class tree: a `global` root bounding all admission,
    with interactive, dashboard and batch leaves whose priority and
    weight order admission, and whose own limits keep one class from
    filling the others' queues."""
    root = ResourceGroup("global", hard_concurrency_limit=root_concurrency,
                         max_queued=root_queued)
    root.add_child(ResourceGroup(
        "interactive", hard_concurrency_limit=root_concurrency,
        max_queued=root_queued, scheduling_weight=8, priority=2))
    root.add_child(ResourceGroup(
        "dashboard", hard_concurrency_limit=max(root_concurrency // 2, 1),
        max_queued=max(root_queued // 2, 1), scheduling_weight=4,
        priority=1))
    root.add_child(ResourceGroup(
        "batch", hard_concurrency_limit=max(root_concurrency // 16, 1),
        max_queued=max(root_queued // 16, 1), scheduling_weight=1,
        priority=0))
    return root


def latency_class_selector(session: Dict) -> str:
    """The session's `latency_class`: a class name maps under the
    global tree, a dotted path passes through, none is the root."""
    lc = str((session or {}).get("latency_class", "") or "")
    if lc in LATENCY_CLASSES:
        return f"global.{lc}"
    return lc or "global"


class Dispatcher:
    """Select a group, admit, execute, fire the lifecycle events.
    `executor(query_id)` does the work; the dispatcher owns admission
    and events only."""

    def __init__(self, groups: Optional[List[ResourceGroup]] = None,
                 selector: Optional[Callable[[Dict], str]] = None,
                 resource_manager_url: Optional[str] = None,
                 coordinator_id: Optional[str] = None,
                 cluster_limits: Optional[Dict[str, int]] = None):
        self.resource_manager_url = resource_manager_url
        self.coordinator_id = coordinator_id or f"coord-{id(self):x}"
        self.cluster_limits = dict(cluster_limits or {})
        # each group of each tree under its dotted path, and its name
        self.groups: Dict[str, ResourceGroup] = {}
        for root in (groups or [ResourceGroup("global")]):
            self._register(root, root.name)
        self._selector = selector or (lambda session: "global")

    @classmethod
    def with_latency_classes(cls, root_concurrency: int = 64,
                             root_queued: int = 1024,
                             **kwargs) -> "Dispatcher":
        """A dispatcher over the latency-class tree, routed by the
        `latency_class` session property."""
        return cls(groups=[latency_class_groups(root_concurrency,
                                                root_queued)],
                   selector=latency_class_selector, **kwargs)

    def _register(self, g: ResourceGroup, path: str):
        self.groups[path] = g
        self.groups.setdefault(g.name, g)
        for c in g.children.values():
            self._register(c, f"{path}.{c.name}")

    def select_group(self, session: Optional[Dict] = None) -> str:
        """The group path the selector routes this session to."""
        return self._selector(session or {})

    def _await_cluster_slot(self, group_name: str,
                            deadline: Optional[float]) -> None:
        """The cluster-wide gate: wait (polling the resource manager)
        while the other coordinators' running queries leave no room
        under a cluster limit of the selected group or of any ancestor
        path; QueryRejected at `deadline`. An unreachable resource
        manager opens the gate (local admission only)."""
        if self.resource_manager_url is None:
            return
        parts = group_name.split(".")
        gates = []
        for i in range(len(parts)):
            prefix = ".".join(parts[:i + 1])
            limit = self.cluster_limits.get(prefix)
            if limit is not None and prefix in self.groups:
                gates.append((prefix, limit, self.groups[prefix]))
        if not gates:
            return
        from .resource_manager import remote_group_load
        while True:
            try:
                blocked = None
                for prefix, limit, g in gates:
                    remote = remote_group_load(self.resource_manager_url,
                                               prefix, self.coordinator_id)
                    if remote + g.stats()["running"] >= limit:
                        blocked = (prefix, limit)
                        break
            except Exception as e:  # noqa: BLE001 - the resource manager
                # is down: local admission only, counted
                from .metrics import record_suppressed
                record_suppressed("dispatcher", "cluster_gate", e)
                return
            if blocked is None:
                return
            if deadline is not None and time.time() >= deadline:
                raise QueryRejected(
                    f"cluster limit {blocked[1]} for group "
                    f"{blocked[0]!r} held by other coordinators")
            time.sleep(0.05)

    def group_stats(self) -> Dict[str, Dict[str, int]]:
        return {name: g.stats() for name, g in self.groups.items()
                if "." in name or not g.parent}

    def submit(self, executor: Callable[[str], object],
               session: Optional[Dict] = None, query_text: str = "",
               queue_timeout: Optional[float] = None,
               query_id: Optional[str] = None):
        """Admit and run one query; QueryRejected when its group cannot
        take it. The caller may give the query id (the statement server
        makes ids at POST time, before admission)."""
        session = session or {}
        group_name = self._selector(session)
        group = self.groups.get(group_name)
        if group is None:
            raise QueryRejected(f"no resource group {group_name!r}")
        query_id = query_id or f"q-{uuid.uuid4().hex[:12]}"
        events = event_listeners()
        events.query_created(query_id, query_text, session.get("user", ""))
        if failpoints.ARMED:
            # delay: a stalled dispatch ahead of the queue; error: a
            # failed admission, before any slot is held
            failpoints.hit("dispatcher.admit")
        mem = parse_size(session["query_max_memory"]) \
            if "query_max_memory" in session else 0
        # one deadline covers the cluster gate and the local queue
        deadline = None if queue_timeout is None \
            else time.time() + queue_timeout
        t_queue0 = time.time()
        try:
            self._await_cluster_slot(group_name, deadline)
            group.acquire(None if deadline is None
                          else max(deadline - time.time(), 0.001), mem=mem)
        finally:
            # the admission wait, refused waits included, per group
            from .metrics import observe_histogram
            observe_histogram("presto_tpu_dispatch_queue_wait_seconds",
                              time.time() - t_queue0,
                              labels={"group": group_name})
        t0 = time.time()
        try:
            result = executor(query_id)
        except Exception as e:
            events.query_completed(query_id, "FAILED",
                                   wall_s=time.time() - t0, error=str(e))
            raise
        finally:
            group.release(mem=mem)
        events.query_completed(query_id, "FINISHED",
                               rows=getattr(result, "row_count", 0),
                               wall_s=time.time() - t0)
        return result
