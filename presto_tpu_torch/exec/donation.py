"""Buffer donation as release-on-handoff, for region dispatches.

Counterpart of presto_tpu/exec/donation.py. The reference donates a
dead region input to XLA (`donate_argnums`), which may alias its HBM
into the region's output. Eager PyTorch has no such thing; what it has
is reference counting and a caching allocator that reuses a freed
block for the next allocation on the same stream. So the port's
donation hands a dead intermediate's LAST reference to the region that
consumes it: the region executor (exec/runner.py::_execute_regions)
drops its own references (the `outputs` entry and the region's input
slot), puts the batch in a one-shot `Handoff`, and the region's
remote-source leaf takes it out (exec/planner.py). The columns the
region does not pass through are then freed as soon as their last
reader in the region returns, and the allocator reuses their blocks
for the region's later allocations; without donation they live until
the region has returned.

The reference's conditions hold unchanged:

  * **engine deadness** -- only region-boundary intermediates whose
    LAST consumer is the dispatching region, read once there, are
    candidates. Scan leaves are never donated: the host tier may still
    hold them (staging, fragment caches, test harnesses).
  * **overflow-incapable regions only** -- the rerun ladder re-reads
    the SAME input batches after a capacity overflow, and a handed-off
    batch is gone; a region of filter/project/output/limit chains
    cannot overflow.
  * **fallback, never failure** -- any error before the handoff
    (including the ``donation.apply`` failpoint in `prepare_donation`,
    reached before any reference is dropped) collapses to the normal
    undonated dispatch, counted in ``presto_tpu_donation_fallbacks_
    total``.

``PRESTO_TPU_DONATION`` is registered in exec/plan_cache.py's
KERNEL_MODE_ENVS. The kernel audit's K006 (audit/passes/donation.py)
reads, on a copy, which of a donated input's storages outlive the
region.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence, Tuple

from .. import failpoints
from ..plan import nodes as N
from ..utils.locks import OrderedLock

__all__ = ["DONATION_ENV", "donation_enabled", "overflow_incapable",
           "Handoff", "prepare_donation", "PreparedDonation",
           "donation_totals", "note_donation", "note_fallback",
           "clear_donation_state"]

DONATION_ENV = "PRESTO_TPU_DONATION"

_LEAF_TYPES = (N.TableScanNode, N.ValuesNode, N.RemoteSourceNode)

# operators that can NEVER set an overflow flag: pure mask/compute
# chains with no capacity-bounded state (joins, group tables, unnest
# and exchanges are the overflow producers). Conservative by
# construction: an absent node type means "no donation".
_OVERFLOW_FREE = (N.FilterNode, N.ProjectNode, N.OutputNode,
                  N.LimitNode)


def donation_enabled(session) -> bool:
    """Session property ``buffer_donation``; process default from
    PRESTO_TPU_DONATION (default OFF)."""
    import os
    env_on = os.environ.get("PRESTO_TPU_DONATION", "0") \
        not in ("0", "", "false")
    from ..utils.config import session_flag
    return session_flag(session, "buffer_donation", env_on)


def overflow_incapable(root: N.PlanNode) -> bool:
    """True when every operator in the region subtree is on the
    overflow-free whitelist (leaves excepted)."""
    if isinstance(root, _LEAF_TYPES):
        return True
    if not isinstance(root, _OVERFLOW_FREE):
        return False
    return all(overflow_incapable(s) for s in root.sources)


class Handoff:
    """A batch's last reference, handed to the closure that consumes it:
    `take()` returns it once and forgets it."""

    __slots__ = ("_batch", "device")

    def __init__(self, batch):
        self._batch = batch
        self.device = batch.active.device

    def take(self):
        b = self._batch
        if b is None:
            raise RuntimeError("a handed-off batch was read twice; a "
                               "donated input must have one reader")
        self._batch = None
        return b


# -- process totals (/v1/metrics presto_tpu_donation* families) ---------

# tpulint C001: dispatch threads bump, scrape threads read
_TOTALS_GUARDED_BY = {"_TOTALS_LOCK": ("_TOTALS",)}

_TOTALS_LOCK = OrderedLock("donation._TOTALS_LOCK")
_TOTALS = {"donations": 0, "donated_bytes": 0, "fallbacks": 0}


def note_donation(nbytes: int, leaves: int = 0) -> None:
    with _TOTALS_LOCK:
        _TOTALS["donations"] += 1
        _TOTALS["donated_bytes"] += int(nbytes)


def note_fallback() -> None:
    with _TOTALS_LOCK:
        _TOTALS["fallbacks"] += 1


def donation_totals() -> Dict[str, int]:
    with _TOTALS_LOCK:
        return dict(_TOTALS)


# -- the static half of the proof, memoized per region fingerprint ------

_MEMO_GUARDED_BY = {"_MEMO_LOCK": ("_MEMO",)}

_MEMO_LOCK = OrderedLock("donation._MEMO_LOCK")
_MEMO: "collections.OrderedDict[str, bool]" = collections.OrderedDict()
_MEMO_CAP = 256


def clear_donation_state() -> None:
    """Tests: drop the memo and zero the process totals."""
    with _MEMO_LOCK:
        _MEMO.clear()
    with _TOTALS_LOCK:
        for k in _TOTALS:
            _TOTALS[k] = 0


def _proven(rfp: str, root: N.PlanNode) -> bool:
    """overflow_incapable(root), once per region fingerprint."""
    with _MEMO_LOCK:
        hit = _MEMO.get(rfp)
        if hit is not None:
            _MEMO.move_to_end(rfp)
            return hit
    proven = overflow_incapable(root)
    with _MEMO_LOCK:
        _MEMO[rfp] = proven
        while len(_MEMO) > _MEMO_CAP:
            _MEMO.popitem(last=False)
    return proven


class PreparedDonation:
    """Which of a region's inputs it is handed (positions in its input
    list) and their bytes."""

    __slots__ = ("donate_idx", "donated_bytes")

    def __init__(self, donate_idx: Tuple[int, ...], donated_bytes: int):
        self.donate_idx = donate_idx
        self.donated_bytes = int(donated_bytes)

    def handoff(self, batches: Sequence) -> list:
        """The region's input list with each donated batch in a
        `Handoff`. The caller must drop every other reference it holds
        to those batches before the dispatch."""
        out = list(batches)
        for i in self.donate_idx:
            out[i] = Handoff(out[i])
        return out


def prepare_donation(rfp: str, root: N.PlanNode, batches: Sequence,
                     dead_idx: Sequence[int]) -> Optional[PreparedDonation]:
    """The handoff plan for one region dispatch (`root`, fingerprint
    `rfp`): the dead inputs (`dead_idx`, positions in the region's input
    list, the executor's half of the proof) and their bytes; None when
    there are none or the root can overflow. Errors (including the
    ``donation.apply`` failpoint) propagate before any reference is
    dropped -- the caller falls back to the undonated dispatch."""
    dead = tuple(sorted(set(int(i) for i in dead_idx)))
    if not dead or not _proven(rfp, root):
        return None
    if failpoints.ARMED:
        failpoints.hit("donation.apply")
    from .memory import batch_bytes
    return PreparedDonation(dead, sum(batch_bytes(batches[i])
                                      for i in dead))
