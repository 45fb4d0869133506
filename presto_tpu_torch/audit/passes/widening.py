"""K003: widening chains -- an up-cast whose every consumer down-casts.

Counterpart of presto_tpu/audit/passes/widening.py. A cast to a wider
dtype (`aten._to_copy` to more bytes an element) whose consumers are
all casts back down to the source width or narrower moved every
element through wide lanes for nothing. Consumers are tracked by
tensor identity through weak references while the closure runs
(KernelTrace.upcasts); an up-cast the closure returns, or that nothing
consumed, is not a chain.
"""

from __future__ import annotations

from typing import List

from ..core import AuditPass, KernelTrace, register

__all__ = ["WideningChainPass"]


def _name(dt) -> str:
    return str(dt).replace("torch.", "")


@register
class WideningChainPass(AuditPass):
    code = "K003"
    name = "widening-chain"
    description = ("up-casts whose only consumers immediately down-cast "
                   "(wide round-trips for bits the closure discards)")

    def run(self, kernel: KernelTrace) -> List:
        findings = []
        recs = kernel.records
        for up, cons in sorted(kernel.consumers.items()):
            if up in kernel.upcasts_returned or not cons:
                continue
            src = recs[up].inputs[0].dtype
            dst = recs[up].outputs[0].dtype

            def down(c) -> bool:
                r = recs[c]
                return r.base == "aten._to_copy" and r.outputs and \
                    r.outputs[0].dtype.itemsize <= src.itemsize
            if not all(down(c) for c in cons):
                continue
            downs = ", ".join(sorted({_name(recs[c].outputs[0].dtype)
                                      for c in cons}))
            findings.append(kernel.finding(
                "K003", recs[up],
                f"widening chain: {_name(src)} up-cast to {_name(dst)} is "
                f"only ever down-cast again (to {downs}) -- the wide "
                f"intermediate wastes the traffic narrow-width execution "
                f"saved; compute in {_name(src)} or drop the casts"))
        return findings
