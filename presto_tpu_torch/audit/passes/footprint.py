"""K005: the closure's peak live bytes against a budget.

Counterpart of presto_tpu/audit/passes/footprint.py. The reference
walks the jaxpr in program order with a last-use liveness map; the
port measures the same quantity on the run itself: the staged inputs
are live from the start, a storage on the trace's device is added when
an op first outputs it and subtracted when its last tensor dies (a
`weakref.finalize` per tensor, KernelTrace._track), and the peak of
that sum is `notes["peak_bytes_estimate"]`. Transient workspace inside
an op is not seen, so the caching allocator's peak over the same run
is at least the estimate (chip_smoke.py::phase_audit holds that).

Traces whose estimate exceeds the budget (`KernelTrace.footprint_
budget_bytes`; 0 = report only) are findings, anchored at the op whose
output first took the live bytes over the budget.
"""

from __future__ import annotations

from typing import List

from ..core import AuditPass, KernelTrace, register

__all__ = ["FootprintPass"]


@register
class FootprintPass(AuditPass):
    code = "K005"
    name = "intermediate-footprint"
    description = ("peak live bytes of the closure's storages on its "
                   "device, gated against a configurable budget and fed "
                   "to the memory pool's accounting")

    def run(self, kernel: KernelTrace) -> List:
        est = int(kernel.peak_bytes)
        kernel.notes["peak_bytes_estimate"] = est
        budget = kernel.footprint_budget_bytes
        if not budget or est <= budget:
            return []
        msg = (f"estimated peak live bytes {est} exceed the footprint "
               f"budget {budget} -- shrink capacities, stream the scan "
               f"(split_rows), or raise kernel_audit_budget_bytes if the "
               f"footprint is intended")
        if kernel.over_at >= 0:
            return [kernel.finding("K005", kernel.records[kernel.over_at],
                                   msg)]
        return [kernel.code_finding("K005", getattr(kernel.fn, "__code__",
                                                    None), msg)]
