"""The port's distributed stages against the reference's on 8 workers.

presto_tpu_torch/parallel/stages.py over eight CPU workers against
presto_tpu/parallel/stages.py under `jax.shard_map` over the 8-device
CPU mesh, in the shapes of tests/test_parallel.py: the PARTIAL ->
exchange -> FINAL group-by (each worker's disjoint slice of the final
states, and the replicated merge of two_stage_group_by) and the
partitioned and broadcast joins (inner; a FULL join partitioned and
a LEFT join broadcast). Every worker's rows
and the overflow flag must be the reference's.
"""

import numpy as np
import pytest

from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.ops.aggregation import AggSpec as RAgg
from presto_tpu.parallel import stages as RS

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.exec.runner import shard_batch
from presto_tpu_torch.ops.aggregation import AggSpec as PAgg
from presto_tpu_torch.parallel import stages as PS

from _torch_mesh_common import (port_mesh, port_worker_rows,
                                ref_worker_rows, shard_map)

AGGS = [("sum", 1, "bigint"), ("count_star", None, "bigint"),
        ("min", 1, "bigint"), ("max", 1, "bigint"),
        ("sum", 2, "decimal(38,2)"), ("avg", 2, "decimal(38,2)")]


def _both(sigs, arrays, nulls=None):
    rb = RB.batch_from_numpy([RT.parse_type(s) for s in sigs], arrays,
                             nulls=nulls)
    pb = PB.batch_from_numpy([PT.parse_type(s) for s in sigs], arrays,
                             nulls=nulls, device="cpu")
    return rb, shard_batch(pb, port_mesh())


def _group_input(total=512, groups=23, seed=7):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, groups, total).astype(np.int64)
    vals = rng.integers(-50, 100, total).astype(np.int64)
    dec = np.empty(total, dtype=object)
    dec[:] = [int(x) * 10 ** 18 for x in rng.integers(-9, 9, total)]
    nulls = [np.zeros(total, bool), rng.random(total) < 0.1,
             rng.random(total) < 0.1]
    return _both(["bigint", "bigint", "decimal(38,2)"], [keys, vals, dec],
                 nulls)


def _aggs(cls, types):
    return [cls(n, c, types.parse_type(t)) for n, c, t in AGGS]


@pytest.mark.parametrize("max_groups", [64, 8], ids=["fits", "overflows"])
def test_distributed_group_by_matches_the_reference(mesh8, max_groups):
    rb, shards = _group_input()
    ref, ref_ovf = shard_map(
        mesh8, lambda s: (lambda r: (r[0].batch, r[1]))(
            RS.distributed_group_by(s, [0], _aggs(RAgg, RT), max_groups)),
        rb)
    got, ovf = PS.distributed_group_by(shards, [0], _aggs(PAgg, PT),
                                       max_groups)
    assert bool(ovf) == bool(ref_ovf.any()) == (max_groups == 8)
    if max_groups == 64:
        assert port_worker_rows([r.batch for r in got]) == \
            ref_worker_rows(ref)


def test_two_stage_group_by_matches_the_reference(mesh8):
    rb, shards = _group_input()
    ref, ref_ovf = shard_map(
        mesh8, lambda s: (lambda r: (r[0].batch, r[1]))(
            RS.two_stage_group_by(s, [0], _aggs(RAgg, RT), 64)), rb)
    got, ovf = PS.two_stage_group_by(shards, [0], _aggs(PAgg, PT), 64)
    assert not bool(ovf) and not ref_ovf.any()
    rows = port_worker_rows([r.batch for r in got])
    assert rows == ref_worker_rows(ref)
    assert all(r == rows[0] for r in rows) and len(rows[0]) == 23


# a FULL join needs the partitioned strategy (a replicated build would
# emit its unmatched rows once per worker); the broadcast one keeps
# every probe row of a LEFT join
@pytest.mark.parametrize("strategy,join_type", [
    ("partitioned", "inner"), ("broadcast", "inner"),
    ("partitioned", "full"), ("broadcast", "left")])
def test_distributed_hash_join_matches_the_reference(mesh8, strategy,
                                                     join_type):
    rng = np.random.default_rng(11)
    np_, nb = 256, 64
    pk = rng.integers(0, 80, np_).astype(np.int64)
    pv = np.arange(np_, dtype=np.int64)
    bk = rng.permutation(80)[:nb].astype(np.int64)
    bv = np.empty(nb, dtype=object)
    bv[:] = [f"v{k}" for k in bk]
    rp, pp = _both(["bigint", "bigint"], [pk, pv])
    rbb, pbb = _both(["bigint", "varchar(4)"], [bk, bv])
    ref, ref_ovf = shard_map(
        mesh8, lambda p, b: (lambda r: (r[0].batch, r[1]))(
            RS.distributed_hash_join(p, b, [0], [0], 512,
                                     strategy=strategy, join_type=join_type,
                                     build_output_channels=[1])), rp, rbb)
    got, ovf = PS.distributed_hash_join(pp, pbb, [0], [0], 512,
                                        strategy=strategy,
                                        join_type=join_type,
                                        build_output_channels=[1])
    assert not bool(ovf) and not ref_ovf.any()
    rows = port_worker_rows([r.batch for r in got])
    assert rows == ref_worker_rows(ref)
    assert sum(sum(w.values()) for w in rows) >= 200
