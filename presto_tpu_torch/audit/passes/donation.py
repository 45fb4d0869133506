"""K006 donation safety + K007 captured constants.

Counterpart of presto_tpu/audit/passes/donation.py.

K006. The reference proves which jit inputs XLA can alias into an
output. The port's donation is a handoff (exec/donation.py): the
region executor gives a dead intermediate's last reference to the
region that consumes it, so its storages free as soon as their last
reader in the region returns. What can defeat it is a storage that is
still alive when the region returns: one the region passes through
into its output, or one that something else holds. The trace hands
each input the executor will donate to the closure as a copy in a
one-shot holder and reads, after the run, which of the
copy's storages are alive (KernelTrace.donated_alive); each input with
such a storage is a finding, anchored at the closure. The plan it
writes, `notes["donation_plan"]`, lists per donated input how many of
its storages outlived the run, and why.

K007. A tensor of 1 MiB or more (`K007_CONST_BYTES`, the reference's)
captured in the lowered closure's cells -- through nested closures,
lists, tuples, dicts and Batch/Column objects -- is pinned on the card
for the life of the compiled-plan cache entry, outside the memory
pool's accounting. Findings are anchored at the function whose cell
holds it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Tuple

import torch

from ..core import AuditPass, KernelTrace, register

__all__ = ["DonationSafetyPass", "BakedConstPass", "donation_plan",
           "captured_tensors", "K007_CONST_BYTES"]

K007_CONST_BYTES = 1 << 20


def donation_plan(kernel: KernelTrace) -> Dict[str, list]:
    """{"version": 1, "donated": [{arg, held_storages}], "held": [{arg,
    reason, storages}]} of the trace's donated inputs."""
    by_pos: Dict[int, Dict[str, int]] = {}
    for key, pos in kernel.donated.items():
        reasons = by_pos.setdefault(pos, {})
        why = kernel.donated_alive.get(key)
        if why is not None:
            reasons[why] = reasons.get(why, 0) + 1
    donated, held = [], []
    for pos, reasons in sorted(by_pos.items()):
        donated.append({"arg": pos, "held_storages": sum(reasons.values())})
        for why, n in sorted(reasons.items()):
            held.append({"arg": pos, "reason": why, "storages": n})
    return {"version": 1, "donated": donated, "held": held}


@register
class DonationSafetyPass(AuditPass):
    code = "K006"
    name = "donation-safety"
    description = ("a donated input whose storage is still alive when the "
                   "region returns (passed through, or held elsewhere)")

    def run(self, kernel: KernelTrace) -> List:
        plan = donation_plan(kernel)
        kernel.notes["donation_plan"] = plan
        co = getattr(kernel.fn, "__code__", None)
        return [kernel.code_finding(
            "K006", co,
            f"donated input {h['arg']}: {h['storages']} storage(s) "
            f"{h['reason']} when the region returned -- the handoff "
            f"frees nothing of them inside the region")
            for h in plan["held"]]


def captured_tensors(fn) -> List[Tuple[torch.Tensor, object]]:
    """(tensor, code object of the function whose cell holds it) for
    every tensor reachable from `fn`'s closure cells and defaults."""
    out: List[Tuple[torch.Tensor, object]] = []
    seen = set()
    stack = [(fn, getattr(fn, "__code__", None), 0)]
    while stack:
        x, co, depth = stack.pop()
        if depth > 12 or id(x) in seen:
            continue
        seen.add(id(x))
        depth += 1
        if isinstance(x, torch.Tensor):
            out.append((x, co))
        elif isinstance(x, functools.partial):
            stack.extend((a, co, depth)
                         for a in (x.func, *x.args, *x.keywords.values()))
        elif callable(x) and hasattr(x, "__code__"):
            for cell in x.__closure__ or ():
                try:
                    stack.append((cell.cell_contents, x.__code__, depth))
                except ValueError:  # an empty cell
                    pass
            stack.extend((d, x.__code__, depth)
                         for d in x.__defaults__ or ())
        elif isinstance(x, (list, tuple, set, frozenset)):
            stack.extend((y, co, depth) for y in x)
        elif isinstance(x, dict):
            stack.extend((y, co, depth) for y in x.values())
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend((getattr(x, fld.name), co, depth)
                         for fld in dataclasses.fields(x))
    return out


@register
class BakedConstPass(AuditPass):
    code = "K007"
    name = "baked-constant-bloat"
    description = ("large tensors captured in the lowered closure's cells "
                   "(pinned on the device for the cache entry's life, "
                   "outside pool accounting)")

    def run(self, kernel: KernelTrace) -> List:
        findings = []
        total = 0
        if kernel.fn is None:
            return findings
        for t, co in captured_tensors(kernel.fn):
            nbytes = t.numel() * t.element_size()
            total += nbytes
            if nbytes < K007_CONST_BYTES:
                continue
            dt = str(t.dtype).replace("torch.", "")
            findings.append(kernel.code_finding(
                "K007", co,
                f"closure captures a {dt}{list(t.shape)} tensor "
                f"({nbytes} bytes) -- it stays on the device for the "
                f"life of the compiled-plan cache entry, outside pool "
                f"accounting; pass it as an input (or shrink it below "
                f"{K007_CONST_BYTES} bytes)"))
        kernel.notes["baked_const_bytes"] = total
        return findings
