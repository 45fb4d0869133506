"""K004: copies between devices outside the exchange boundary.

Counterpart of presto_tpu/audit/passes/collectives.py. The reference's
workers talk through collectives, which only the exchange layer may
lower; the port's mesh is one controller over a tuple of devices
(parallel/mesh.py), and rows move between workers as copies between
devices. Such a copy is sanctioned only between the kernel's declared
devices (`KernelTrace.exchange_devices`, the mesh's) and only from the
exchange layer (`EXCHANGE_BOUNDARY`: parallel/exchange.py, stages.py
and mesh.py, exec/planner.py, exec/runner.py::shard_batch). In a
single-device run any copy between devices is a finding. A copy
between the card and the host is K002's (a host round trip), not this
pass's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..core import COPY_OPS, AuditPass, KernelTrace, register

__all__ = ["CollectiveAuditPass", "EXCHANGE_BOUNDARY"]

# file -> functions sanctioned to move rows between devices (None: all)
EXCHANGE_BOUNDARY: Dict[str, Optional[frozenset]] = {
    "presto_tpu_torch/parallel/exchange.py": None,
    "presto_tpu_torch/parallel/stages.py": None,
    "presto_tpu_torch/parallel/mesh.py": None,
    "presto_tpu_torch/exec/planner.py": None,
    "presto_tpu_torch/exec/runner.py": frozenset(["shard_batch"]),
}


def _devices(rec):
    if rec.base == "aten._to_copy":
        return rec.inputs[0].device, rec.outputs[0].device
    # copy_(dst, src): the last tensor input is the source
    return rec.inputs[-1].device, rec.inputs[0].device


def _sanctioned(rec) -> bool:
    if rec.src not in EXCHANGE_BOUNDARY:
        return False
    fns = EXCHANGE_BOUNDARY[rec.src]
    return fns is None or any(s in fns for s in rec.stack)


@register
class CollectiveAuditPass(AuditPass):
    code = "K004"
    name = "collective-audit"
    description = ("copies between devices checked against the kernel's "
                   "mesh: undeclared devices, and copies outside the "
                   "exchange boundary, are findings")

    def run(self, kernel: KernelTrace) -> List:
        findings = []
        host = kernel.device is not None and kernel.device.type != "cpu"
        spec = kernel.exchange_devices
        for rec in kernel.records:
            if rec.base not in COPY_OPS or not rec.inputs or \
                    not rec.outputs:
                continue
            src, dst = _devices(rec)
            if src == dst:
                continue
            if host and "cpu" in (src.type, dst.type):
                continue  # the host: K002's round trip
            if not spec:
                findings.append(kernel.finding(
                    "K004", rec,
                    f"`{rec.op}` moves a tensor from {src} to {dst} in a "
                    f"single-device kernel (no exchange spec) -- this "
                    f"closure must not move rows between devices"))
                continue
            bad = sorted({str(d) for d in (src, dst)} - spec)
            if bad:
                findings.append(kernel.finding(
                    "K004", rec,
                    f"`{rec.op}` to or from undeclared device(s) {bad} -- "
                    f"the kernel's mesh is {sorted(spec)}"))
                continue
            if not _sanctioned(rec):
                findings.append(kernel.finding(
                    "K004", rec,
                    f"`{rec.op}` from {src} to {dst} outside the exchange "
                    f"boundary (parallel/exchange.py, parallel/stages.py, "
                    f"plan lowering) -- exchanges are the only sanctioned "
                    f"moves between workers"))
        return findings
