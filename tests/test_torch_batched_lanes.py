"""Which lanes of a batched dispatch carry the member axis: the premise of
fused_limb_sums_batched's tiles of members (ops/csrc/fused_limb_sums.cu
stages and splits a lane every member shares once for a tile of
members, and applies the members' masks at the tensor-core operand).

On the CPU at sf 0.01, the dashboard and lineitem templates of
scripts/batching_phase.py run as one batched dispatch
(BatchingExecutor.bench_dispatch) with a spy on
ops.kernels.fused_limb_sums_batched:

  * the value lanes the sums read (the dashboard's `totalprice`, the
    lineitem's 128-bit `extendedprice * discount`) are (n,): shared by
    every member; every mask and every counted bool lane is (B, n): one
    row a member, and the members' masks differ;
  * the batch's rows equal the port's serial rows of each text and the
    reference's batched rows (presto_tpu/exec/batching.py).

The kernel itself is held against its plain version on the card by
chip_smoke.py (phase_fused, the kernel rows of both batches).
"""

import numpy as np
import presto_tpu  # noqa: F401  (jax x64 before any array is made)
import pytest
import torch

from presto_tpu_torch.ops import kernels as K

SF = 0.01
DASH = ("SELECT orderpriority, count(*) AS orders, sum(totalprice) AS s "
        "FROM orders WHERE custkey = {} "
        "GROUP BY orderpriority ORDER BY orderpriority")
LINEITEM = ("SELECT sum(extendedprice * discount) FROM lineitem "
            "WHERE discount BETWEEN 0.05 AND 0.07 AND quantity < {}")
# each family's template, keys (one dashboard key no order has), the
# rows of its scanned table at SF, the value lane's kind and its
# lowest sum field's width
FAMILIES = {"dashboard": (DASH, (4, 10, 99999, 37), 15_000, torch.int32),
            "lineitem": (LINEITEM, (1, 24, 50, 12), 60_000, "int128")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for the module: six xdist workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _exact(res):
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.queries import exact_rows
    types = [PT.parse_type(str(t)) for t in res.types]
    return (list(res.names), [str(t) for t in res.types],
            exact_rows(res.columns, res.nulls, types, res.row_count))


def _batched(texts, monkeypatch):
    """`texts` as one batched dispatch on the CPU: the results and every
    call of fused_limb_sums_batched (ids, sources, requests, groups,
    batch)."""
    from presto_tpu_torch.exec.batching import (BatchingExecutor,
                                                batching_totals,
                                                clear_batching)
    calls, real = [], K.fused_limb_sums_batched

    def spy(ids, sources, requests, groups, batch, **kw):
        calls.append((ids, sources, requests, groups, batch))
        return real(ids, sources, requests, groups, batch, **kw)

    clear_batching()
    monkeypatch.setattr(K, "fused_limb_sums_batched", spy)
    try:
        got = BatchingExecutor().bench_dispatch(texts, sf=SF, device="cpu")
    finally:
        monkeypatch.undo()
    assert batching_totals()["collapses"] == {"failpoint": 0, "overflow": 0,
                                              "error": 0}
    clear_batching()
    return got, calls


def _serial(text):
    from presto_tpu_torch.exec import run_query
    from presto_tpu_torch.exec.batching import BatchingExecutor
    prepared = BatchingExecutor()._prepare(
        text, sf=SF, session={}, catalog=None, device=torch.device("cpu"),
        max_groups=None, join_capacity=None)[0]
    return run_query(prepared, sf=SF, device="cpu", prepared=True)


def _lanes(source):
    return list(source) if isinstance(source, tuple) else [source]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_value_lanes_are_shared_and_masks_per_member(family, monkeypatch):
    template, keys, rows, kind = FAMILIES[family]
    texts = [template.format(k) for k in keys]
    _got, calls = _batched(texts, monkeypatch)
    assert len(calls) == 1, len(calls)
    ids, sources, requests, groups, batch = calls[0]
    assert batch == len(texts)
    assert ids.shape[-1] == rows
    sums = [r for r in requests if r.bits > 1]
    counts = [r for r in requests if r.bits == 1]
    assert sums and counts
    # the value lane: one source, shared, of the expected kind
    values = {r.source for r in sums}
    assert len(values) == 1
    value = sources[values.pop()]
    if kind == "int128":
        assert isinstance(value, tuple)
        assert all(t.dtype == torch.int64 for t in value)
    else:
        assert not isinstance(value, tuple) and value.dtype == kind
    assert all(t.shape == (rows,) for t in _lanes(value)), \
        [tuple(t.shape) for t in _lanes(value)]
    # every mask and every counted bool lane: one row a member
    member = [sources[r.mask] for r in requests if r.mask != -1] + \
        [sources[r.source] for r in counts]
    assert member
    for lane in member:
        assert not isinstance(lane, tuple) and lane.dtype == torch.bool
        assert lane.shape == (batch, rows), tuple(lane.shape)
    # the members' filters differ, so their masks do
    mask = sources[sums[0].mask]
    assert not all(torch.equal(mask[0], mask[m]) for m in range(1, batch))
    if family == "lineitem":  # a keyless sum: one group, the ids shared
        assert groups == 1 and ids.shape == (rows,)
    else:  # the group ids follow the member's filter
        assert groups >= 5 and ids.shape == (batch, rows)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_batched_rows_equal_serial_and_the_reference(family, monkeypatch):
    from presto_tpu.exec.batching import BatchingExecutor as RefExecutor
    from presto_tpu.exec.batching import clear_batching as ref_clear
    template, keys, _rows, _kind = FAMILIES[family]
    texts = [template.format(k) for k in keys]
    got, calls = _batched(texts, monkeypatch)
    assert len(calls) == 1
    ref_clear()
    want = RefExecutor().bench_dispatch(texts, sf=SF)
    ref_clear()
    for text, g, w in zip(texts, got, want):
        assert _exact(g) == _exact(w), text
        assert _exact(g) == _exact(_serial(text)), text


def test_batched_wrapper_takes_blocks_and_its_lanes():
    """The batched wrapper's `blocks` (the kernel's chunk ranges a tile
    of members) leaves the sums alone: on the CPU the plain version of
    the dashboard's lane layout, per-member ids and masks over a shared
    int32 value lane, equals each member's own call."""
    rng = np.random.default_rng(7)
    batch, n, groups = 5, 3001, 8
    R = K.LimbRequest
    ids = torch.from_numpy(rng.integers(-1, 6, (batch, n)).astype(np.int32))
    live = torch.from_numpy(rng.random((batch, n)) < 0.6)
    keep = torch.from_numpy(rng.random((batch, n)) < 0.3)
    price = torch.from_numpy(rng.integers(-(1 << 31), (1 << 31) - 1, n)
                             .astype(np.int32))
    sources = [live, keep, price]
    reqs = [R(0, -1, 0, 1, True), R(1, -1, 0, 1, True),
            R(2, 1, 0, 13, False), R(2, 1, 13, 13, False),
            R(2, 0, 26, 13, True)]
    got = K.fused_limb_sums_batched(ids, sources, reqs, groups, batch,
                                    blocks=1)
    assert torch.equal(got, K.fused_limb_sums_batched(ids, sources, reqs,
                                                      groups, batch))
    for m in range(batch):
        assert torch.equal(got[m], K.fused_limb_sums(
            ids[m], [live[m], keep[m], price], reqs, groups))
