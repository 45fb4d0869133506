"""Distributed stage composition over the workers of a mesh.

Counterpart of presto_tpu/parallel/stages.py (`distributed_group_by`,
`two_stage_group_by`, `distributed_hash_join`): the two-stage
aggregation (PARTIAL -> hash exchange of the partial states -> FINAL)
and the partitioned and broadcast joins, written over per-worker
batches (parallel/exchange.py). Each returns one result per worker and
one overflow flag, the OR over the workers of every flag the stage
raised (the reference's psum of its flags).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..block import Batch
from ..ops.aggregation import AggSpec, GroupByResult, group_by, merge_partials
from ..ops.join import JoinResult, hash_join
from .exchange import any_flag, broadcast_build, exchange_by_hash

__all__ = ["distributed_group_by", "two_stage_group_by",
           "distributed_hash_join"]


def distributed_group_by(shards: Sequence[Batch], key_channels: Sequence[int],
                         aggs: Sequence[AggSpec], max_groups: int,
                         slot_capacity: Optional[int] = None,
                         limb_form: str = "narrow"
                         ) -> Tuple[List[GroupByResult], torch.Tensor]:
    """PARTIAL group-by on each worker -> hash exchange of the partial
    states by their keys -> FINAL merge on each worker: every worker
    returns its disjoint slice of the final groups (states, not
    finalized), and the flag of any overflow."""
    parts = [group_by(b, key_channels, aggs, max_groups, limb_form)
             for b in shards]
    nkeys = len(key_channels)
    ex, ex_ovf = exchange_by_hash([p.batch for p in parts],
                                  list(range(nkeys)),
                                  slot_capacity or max_groups)
    finals = [merge_partials(b, nkeys, aggs, max_groups, limb_form)
              for b in ex]
    return finals, any_flag([p.overflow for p in parts] + [ex_ovf]
                            + [f.overflow for f in finals])


def two_stage_group_by(shards: Sequence[Batch], key_channels: Sequence[int],
                       aggs: Sequence[AggSpec], max_groups: int,
                       limb_form: str = "narrow"
                       ) -> Tuple[List[GroupByResult], torch.Tensor]:
    """distributed_group_by, then every worker's final groups gathered
    to every worker and merged into one table there (the replicated
    root-stage shape): each worker returns the whole result."""
    finals, ovf = distributed_group_by(shards, key_channels, aggs,
                                       max_groups, limb_form=limb_form)
    nkeys = len(key_channels)
    merged = [merge_partials(b, nkeys, aggs, max_groups, limb_form)
              for b in broadcast_build([f.batch for f in finals])]
    return merged, any_flag([ovf] + [m.overflow for m in merged])


def distributed_hash_join(probe_shards: Sequence[Batch],
                          build_shards: Sequence[Batch],
                          probe_keys: Sequence[int],
                          build_keys: Sequence[int], out_capacity: int,
                          strategy: str = "partitioned",
                          slot_capacity: Optional[int] = None,
                          join_type: str = "inner",
                          build_output_channels: Optional[Sequence[int]] = None
                          ) -> Tuple[List[JoinResult], torch.Tensor]:
    """strategy "partitioned": both sides repartitioned by their join
    keys, then a local join on each worker (slots default to the probe
    shard's capacity, as the reference's); "broadcast": the build side
    replicated to every worker, the probe side where it is."""
    flags = []
    if strategy == "broadcast":
        probes, builds = probe_shards, broadcast_build(build_shards)
    else:
        slot = slot_capacity or max(b.capacity for b in probe_shards)
        probes, p_ovf = exchange_by_hash(probe_shards, probe_keys, slot)
        builds, b_ovf = exchange_by_hash(build_shards, build_keys, slot)
        flags += [p_ovf, b_ovf]
    res = [hash_join(p, b, probe_keys, build_keys, out_capacity, join_type,
                     build_output_channels)
           for p, b in zip(probes, builds)]
    return res, any_flag(flags + [r.overflow for r in res])
