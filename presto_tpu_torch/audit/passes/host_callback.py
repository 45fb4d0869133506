"""K002: host round-trips inside a lowered closure.

Counterpart of presto_tpu/audit/passes/host_callback.py. The reference
flags callback and device_put eqns in a staged program; the port's
closure runs op by op on the host, and what stalls it is a read of a
device value on the host, which waits for the stream to drain:

  * ``aten._local_scalar_dense`` -- `.item()`, `bool()`, `int()`,
    `float()` of a tensor, on any device;
  * a copy from a CUDA tensor to the CPU (`.cpu()`, `.tolist()`,
    `.numpy()` after a move);
  * on CUDA, an op whose output size depends on the data and so syncs
    to size it (`SIZE_SYNC_OPS`: nonzero, masked_select, unique,
    boolean indexing, repeat_interleave without output_size).

On the CPU `.cpu()`, `.tolist()` and `.numpy()` reach no dispatcher
and the size-dependent ops do not sync, so the pass sees fewer sites
there than on the card.

The sanctioned sync sites are whitelisted by function, with reasons.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..core import COPY_OPS, AuditPass, KernelTrace, register

__all__ = ["HostCallbackPass", "SIZE_SYNC_OPS", "SYNC_OK_SITES"]

SIZE_SYNC_OPS = frozenset([
    "aten.nonzero", "aten.argwhere", "aten.masked_select", "aten._unique2",
    "aten.unique_dim", "aten.unique_consecutive", "aten._unique",
])

# file -> {enclosing function: reason}
SYNC_OK_SITES: Dict[str, Dict[str, str]] = {
    "presto_tpu_torch/ops/aggregation.py": {
        "_group_ids_hash":
            "the hash-slot group-by reads its exit flag every 4 probe "
            "rounds, one host read a check (HASH_STATS counts them)",
    },
    "presto_tpu_torch/exec/runner.py": {
        "_dispatch_ladder":
            "the ladder's overflow flags: one read a dispatch, the only "
            "way to learn a capacity overflowed",
        "_batch_to_result": "the fetch of the result rows",
    },
    "presto_tpu_torch/exec/batching.py": {
        "_dispatch":
            "the batched dispatch's overflow flags and counts, one read "
            "a batch, and its fetch",
    },
    "presto_tpu_torch/block.py": {
        "to_numpy": "the fetch of the result rows",
    },
}


def _bool_index(rec) -> bool:
    return rec.base in ("aten.index", "aten.index_put_", "aten.index_put") \
        and any(m.dtype in (torch.bool, torch.uint8)
                for m in rec.inputs[1:])


def _size_sync(rec) -> bool:
    if rec.base in SIZE_SYNC_OPS or _bool_index(rec):
        return True
    return rec.base == "aten.repeat_interleave" and \
        rec.kwargs.get("output_size") is None and len(rec.inputs) == 1


def _what(rec) -> str:
    if rec.base == "aten._local_scalar_dense":
        return ("a host read of a device scalar (`.item()`, `bool()`, "
                "`int()` or `float()` of a tensor) waits for the stream "
                "to drain")
    if rec.base in COPY_OPS:
        return "a copy to host memory waits for the stream to drain"
    return ("its output size depends on the data, so the host waits "
            "for the device to size it")


def is_host_round_trip(rec) -> bool:
    if rec.base == "aten._local_scalar_dense":
        return True
    if not rec.inputs:
        return False
    src_dev = rec.inputs[-1].device if rec.base in COPY_OPS and \
        rec.base != "aten._to_copy" else rec.inputs[0].device
    if rec.base in COPY_OPS and rec.outputs:
        return src_dev.type == "cuda" and rec.outputs[0].device.type == "cpu"
    return rec.inputs[0].device.type == "cuda" and _size_sync(rec)


@register
class HostCallbackPass(AuditPass):
    code = "K002"
    name = "host-round-trip"
    description = ("host reads of device values inside a lowered closure: "
                   ".item()/bool()/int(), copies to the CPU, and CUDA ops "
                   "whose output size needs a sync")

    def run(self, kernel: KernelTrace) -> List:
        findings = []
        for rec in kernel.records:
            if not is_host_round_trip(rec):
                continue
            allowed = SYNC_OK_SITES.get(rec.src)
            if allowed and any(s in allowed for s in rec.stack):
                continue
            findings.append(kernel.finding(
                "K002", rec, f"`{rec.op}` inside a lowered closure -- "
                             f"{_what(rec)}"))
        return findings
