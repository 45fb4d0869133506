"""The port's mesh and exchanges against the reference's on 8 workers.

`make_mesh` places the port's workers; each exchange of
presto_tpu_torch/parallel/exchange.py runs over eight CPU workers and
presto_tpu/parallel/exchange.py under `jax.shard_map` over the 8-device
CPU mesh, on one seeded batch with strings, decimal(38,2) lanes, NULLs,
arrays and rows (tests/_torch_mesh_common.py). Every worker must
receive the reference's rows (as a multiset) and raise the reference's
overflow flag, a forced overflow included.
"""

import pytest
import torch

from presto_tpu.parallel import exchange as RX
from presto_tpu.parallel.mesh import WORKERS_AXIS

from presto_tpu_torch.exec.runner import shard_batch
from presto_tpu_torch.parallel import exchange as PX
from presto_tpu_torch.parallel import make_mesh
from presto_tpu_torch.parallel.mesh import WORKERS_AXIS as PORT_AXIS

from _torch_mesh_common import (WORKERS, mixed_batches, port_mesh,
                                port_worker_rows, ref_worker_rows,
                                shard_map)


def _port_shards():
    _, pb = mixed_batches()
    return shard_batch(pb, port_mesh())


def test_make_mesh_places_workers_and_refuses_missing_devices():
    m = make_mesh(8, devices=("cpu",) * 8)
    assert m.size == 8 and m.axis_name == PORT_AXIS == WORKERS_AXIS
    assert all(d == torch.device("cpu") for d in m.devices)
    assert make_mesh(devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError):
        make_mesh(3, devices=("cpu",) * 2)
    if torch.cuda.device_count() < 64:
        with pytest.raises(RuntimeError, match="devices="):
            make_mesh(64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            make_mesh()
        with pytest.raises(RuntimeError):
            make_mesh(4, devices=("cuda:0",) * 4)


def test_shards_are_the_references_contiguous_split(mesh8):
    rb, pb = mixed_batches()
    ref, _ = shard_map(mesh8, lambda s: (s, None), rb)
    assert port_worker_rows(shard_batch(pb, port_mesh())) == \
        ref_worker_rows(ref)


@pytest.mark.parametrize("keys", [[0], [0, 1], [2], [1, 2]],
                         ids=["bigint", "bigint_varchar", "decimal",
                              "varchar_decimal"])
def test_exchange_by_hash_matches_the_reference(mesh8, keys):
    rb, _ = mixed_batches()
    ref, ref_ovf = shard_map(
        mesh8, lambda s: RX.exchange_by_hash(s, keys, WORKERS_AXIS, 64), rb)
    got, ovf = PX.exchange_by_hash(_port_shards(), keys, 64)
    assert not ref_ovf.any() and not ovf.any()
    assert [b.capacity for b in got] == [WORKERS * 64] * WORKERS
    assert port_worker_rows(got) == ref_worker_rows(ref)
    assert all(sum(w.values()) for w in port_worker_rows(got))


def test_exchange_by_hash_forced_overflow_matches_the_reference(mesh8):
    """Slots of 2 rows: most buckets overflow; the flags and the rows
    kept (each bucket's first rows in row order) are the reference's."""
    rb, _ = mixed_batches()
    ref, ref_ovf = shard_map(
        mesh8, lambda s: RX.exchange_by_hash(s, [0], WORKERS_AXIS, 2), rb)
    got, ovf = PX.exchange_by_hash(_port_shards(), [0], 2)
    assert ref_ovf.any()
    assert ovf.tolist() == ref_ovf.tolist()
    assert port_worker_rows(got) == ref_worker_rows(ref)


@pytest.mark.parametrize("sort_keys", [
    [(0, False, True)],
    [(1, False, True), (2, True, False)],
    [(5, True, True)],
    [(2, False, False), (0, True, True)],
], ids=["bigint", "varchar_decimal_desc", "double_desc", "decimal_bigint"])
def test_exchange_by_range_matches_the_reference(mesh8, sort_keys):
    rb, _ = mixed_batches()
    ref, ref_ovf = shard_map(
        mesh8, lambda s: RX.exchange_by_range(s, sort_keys, WORKERS_AXIS,
                                              64), rb)
    got, ovf = PX.exchange_by_range(_port_shards(), sort_keys, 64)
    assert ovf.tolist() == ref_ovf.tolist()
    assert port_worker_rows(got) == ref_worker_rows(ref)


def test_exchange_by_range_forced_overflow_matches_the_reference(mesh8):
    rb, _ = mixed_batches()
    keys = [(0, False, True)]
    ref, ref_ovf = shard_map(
        mesh8, lambda s: RX.exchange_by_range(s, keys, WORKERS_AXIS, 4), rb)
    got, ovf = PX.exchange_by_range(_port_shards(), keys, 4)
    assert ref_ovf.any()
    assert ovf.tolist() == ref_ovf.tolist()
    assert port_worker_rows(got) == ref_worker_rows(ref)


@pytest.mark.parametrize("name", ["broadcast_build", "gather_to_root"])
def test_replicating_exchanges_match_the_reference(mesh8, name):
    rb, _ = mixed_batches()
    ref, _ = shard_map(
        mesh8, lambda s: (getattr(RX, name)(s, WORKERS_AXIS), None), rb)
    got = getattr(PX, name)(_port_shards())
    rows = ref_worker_rows(ref)
    assert port_worker_rows(got) == rows
    assert all(r == rows[0] for r in rows)


def test_exchange_records_the_rows_each_worker_received():
    PX.RECEIVED = []
    try:
        got, _ = PX.exchange_by_hash(_port_shards(), [0], 64)
        (kind, counts), = PX.RECEIVED
    finally:
        PX.RECEIVED = None
    assert kind == "hash"
    assert [int(c) for c in counts] == \
        [int(b.active.sum()) for b in got]
