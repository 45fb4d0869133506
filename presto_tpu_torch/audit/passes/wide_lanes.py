"""K001: wide-lane escapes -- 64-bit outputs CREATED from all-narrow
inputs, outside the sanctioned widening sites.

Counterpart of presto_tpu/audit/passes/wide_lanes.py over the port's
op stream. Narrow-width execution (plan/widths.py) stages every
range-proven column at 32 bits or less; an op that makes an int64 or
float64 output when every tensor input is 32 bits or narrower (a
factory, which has none, included) is a lane someone widened: either
a sanctioned exactness site (int128 limb math, 64-bit key and order
words, accumulators, row ids) or an escape that doubles the bytes the
card moves for that lane. Wideness that flows in from a staged input
is not a finding.

Two things differ from the reference's IR:

  * torch's own contract gives some outputs int64 whatever the inputs
    (`INDEX_OUTPUTS`: nonzero, the index output of sort/argsort/topk/
    max/min, unique's inverse and counts); those outputs are not
    escapes. `searchsorted` is not among them: it has `out_int32`, so
    an int64 call there is flagged.
  * a hand-written kernel's launch is a record whose output was made by
    a factory the pass already judged; launches are skipped.
  * an output of at most one element is a scalar, not a lane (torch
    wraps each Python number an op takes in a 0-d int64 or float64
    tensor, and a literal's block holds one element).

Most of the port's sanctioned sites are index lanes: torch's gather,
scatter, sort and advanced indexing take int64 positions, where XLA's
take 32-bit ones, so row positions, permutations, group slots and
segment ids are int64 by the library's contract, not by choice.

The whitelist is by enclosing function (any segment of the op's
`co_qualname`), per file, each with its reason.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..core import AuditPass, KernelTrace, register

__all__ = ["WideLaneEscapePass", "WIDE_OK_FILES", "WIDE_OK_SITES",
           "INDEX_OUTPUTS"]

# ops whose listed outputs are int64 by torch's contract (positions in
# the op's output tuple); None: every output
INDEX_OUTPUTS: Dict[str, object] = {
    "aten.nonzero": None,
    "aten.argwhere": None,
    "aten.sort": (1,),
    "aten.argsort": None,
    "aten.topk": (1,),
    "aten.max": (1,),
    "aten.min": (1,),
    "aten.kthvalue": (1,),
    "aten.mode": (1,),
    "aten.cummax": (1,),
    "aten.cummin": (1,),
    "aten.argmax": None,
    "aten.argmin": None,
    "aten._unique2": (1, 2),
    "aten.unique_dim": (1, 2),
    "aten.unique_consecutive": (1, 2),
}

# whole files where 64-bit lanes ARE the contract
WIDE_OK_FILES: Dict[str, str] = {
    "presto_tpu_torch/int128.py":
        "the int128 limb kernels: every value is an (int64 hi, int64 lo) "
        "pair by definition",
}

_INDEX = ("int64 index lanes: torch's gather, scatter, sort and "
          "advanced indexing take int64 positions")

# file -> {enclosing function: reason}
WIDE_OK_SITES: Dict[str, Dict[str, str]] = {
    "presto_tpu_torch/ops/aggregation.py": {
        "_group_ids": "group ids of the hash-slot table, " + _INDEX,
        "_group_ids_small": "row positions and first-row slots of the "
                            "small-table group-by, " + _INDEX,
        "_SegSumPool": "exact segment sums accumulate in int64 (the "
                       "reference's _SegSumPool.add)",
        "_seg_reduce": "a segment reduction's identity, at its "
                       "accumulator's width",
        "_argbest": "row positions of min_by/max_by, " + _INDEX,
        "_sorted_states": "count accumulators are BIGINT",
        "_group_by_sorted": "segment ids (a cumsum) and group slots of "
                            "the sorted group-by, " + _INDEX,
        "group_by": "the output's group slots, " + _INDEX,
    },
    "presto_tpu_torch/ops/kernels.py": {
        "fused_limb_sums": "exact limb sums accumulate in int64 (the "
                           "kernel's output)",
        "fused_limb_sums_reference": "exact limb sums accumulate in int64 "
                                     "(the kernel's plain version)",
        "source_field": "a limb field is cut from its lane widened to "
                        "int64",
        "_recombine": "limb sums recombine into exact int64 totals",
    },
    "presto_tpu_torch/ops/keys.py": {
        "_fixed_words": "64-bit order words: one compare orders every "
                        "key type",
        "string_words": "strings packed 8 bytes to an int64 order word",
    },
    "presto_tpu_torch/ops/sort.py": {
        "lex_permutation": "the permutation, " + _INDEX,
        "sort_permutation": "the 64-bit order words the lexicographic "
                            "sort compares",
    },
    "presto_tpu_torch/ops/join.py": {
        "_pack_ranks": "64-bit packed ranks: one searchsorted order for "
                       "build and probe",
        "_sort_build": "the build side's 64-bit order words",
        "hash_join": "output row positions, " + _INDEX,
    },
    "presto_tpu_torch/expr/functions.py": {
        "_i64": "decimal and integer arithmetic widen narrowed lanes to "
                "the exact scaled-int64 domain first (plan/widths.py)",
        "_divide128": "int128 division's rounding bit joins the int64 "
                      "limbs",
        "_positions": "character positions, " + _INDEX,
        "_slice_rows": "character positions, " + _INDEX,
        "hash64_block": "the $hashValue analog: a 64-bit hash is the "
                        "contract partitioned exchanges route by",
    },
    "presto_tpu_torch/expr/compile.py": {
        "_like": "match positions in the char matrix, " + _INDEX,
    },
    "presto_tpu_torch/exec/planner.py": {
        "compile_plan": "row-id and grouping-set-id columns are logical "
                        "BIGINT (AssignUniqueId, GroupId)",
    },
    "presto_tpu_torch/parallel/exchange.py": {
        "_route_rows": "destination slots of routed rows, " + _INDEX,
        "exchange_by_range": "range splitter sampling packs order words "
                             "and sample positions in 64 bits",
    },
}

_WIDE = (torch.int64, torch.float64, torch.complex128, torch.uint64)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _is_wide(dt) -> bool:
    return dt in _WIDE


def site_allowed(rec, files=None, sites=None) -> bool:
    files = WIDE_OK_FILES if files is None else files
    sites = WIDE_OK_SITES if sites is None else sites
    if rec.src in files:
        return True
    allowed = sites.get(rec.src)
    return bool(allowed) and any(s in allowed for s in rec.stack)


@register
class WideLaneEscapePass(AuditPass):
    code = "K001"
    name = "wide-lane-escape"
    description = ("64-bit outputs created from all-narrow inputs outside "
                   "the whitelisted limb/key/accumulator/row-id sites")

    def run(self, kernel: KernelTrace) -> List:
        findings = []
        for rec in kernel.records:
            if rec.base.startswith("kernel."):
                continue
            exempt = INDEX_OUTPUTS.get(rec.base, ())
            if exempt is None:
                continue
            wide = [m.dtype for k, m in enumerate(rec.outputs)
                    if _is_wide(m.dtype) and _numel(m.shape) > 1
                    and k not in exempt]
            if not wide:
                continue
            if any(_is_wide(m.dtype) for m in rec.inputs):
                continue  # wideness flowed in; sanctioned at staging
            if site_allowed(rec):
                continue
            dt = str(wide[0]).replace("torch.", "")
            findings.append(kernel.finding(
                "K001", rec,
                f"{dt} lanes created by `{rec.op}` from all-narrow "
                f"inputs -- a wide-lane escape narrow-width execution "
                f"pays for in device memory traffic; widen at a "
                f"whitelisted exactness site or keep the lane narrow"))
        return findings
