"""Shared by the tests of the port's mesh tier (tests/test_torch_mesh_*.py):
one seeded batch staged by both packages, the reference's per-worker
run under `jax.shard_map` over the 8-device CPU mesh (the `mesh8`
fixture of tests/conftest.py), the port's 8-worker CPU mesh, and each
worker's active rows as a multiset, the form in which the tests compare
the two: order within a worker is no contract (the reference's
`lax.sort` is not stable)."""

import collections

import numpy as np
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
import jax
from jax.sharding import PartitionSpec as P
from presto_tpu import block as RB
from presto_tpu import types as RT
from presto_tpu.parallel.mesh import WORKERS_AXIS

from presto_tpu_torch import block as PB
from presto_tpu_torch import types as PT
from presto_tpu_torch.parallel import make_mesh

WORKERS = 8


def port_mesh(n=WORKERS):
    return make_mesh(n, devices=("cpu",) * n)


def canon(v):
    """A fetched value in a comparable, hashable form."""
    if v is None:
        return None
    if isinstance(v, (float, np.floating)):
        return float(v).hex()
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, dict):
        return tuple((canon(a), canon(b)) for a, b in v.items())
    if isinstance(v, (list, tuple)):
        return tuple(canon(x) for x in v)
    if isinstance(v, bytes):
        return v.decode("latin-1")
    return v


def _rows(to_numpy, batch, start, stop):
    cols = [to_numpy(batch.column(c)) for c in range(len(batch.columns))]
    act = np.asarray(batch.active)[start:stop]
    out = collections.Counter()
    for i in np.flatnonzero(act) + start:
        out[tuple(None if np.asarray(n)[i] else canon(v[i])
                  for v, n in cols)] += 1
    return out


def ref_worker_rows(batch, n=WORKERS):
    """Per worker, the active rows of a reference batch whose axis 0 is
    the concatenation of n equal shards."""
    step = batch.capacity // n
    return [_rows(RB.to_numpy, batch, w * step, (w + 1) * step)
            for w in range(n)]


def port_worker_rows(batches):
    """Per worker, the active rows of the port's per-worker batches."""
    return [_rows(PB.to_numpy, b, 0, b.capacity) for b in batches]


def shard_map(mesh8, fn, *batches):
    """Run fn(*shards) -> (batch, flag or None) under shard_map; returns
    the whole output batch and the per-worker flags (or None)."""
    def step(*shards):
        out, flag = fn(*shards)
        return out, (jax.numpy.zeros((1,), bool) if flag is None
                     else flag.reshape(1))
    f = jax.shard_map(step, mesh=mesh8,
                      in_specs=tuple(P(WORKERS_AXIS) for _ in batches),
                      out_specs=(P(WORKERS_AXIS), P(WORKERS_AXIS)),
                      check_vma=False)
    out, flags = jax.jit(f)(*batches)
    return out, np.asarray(flags)


SIGS = ["bigint", "varchar(8)", "decimal(38,2)", "array(bigint)",
        "row(bigint,varchar(4))", "double"]
WORDS = ["", "ab", "xyz", "abcdefgh", "b", "zz", "ab", "q"]


def mixed_batches(rows=480, capacity=512, seed=3):
    """(reference batch, port batch) of the same seeded rows: bigint
    keys of 37 values, short strings, decimal(38,2) beyond 64 bits,
    arrays of up to three bigints, rows of (bigint, varchar), doubles;
    a seventh of each column NULL (the row field's own NULLs too), a
    tenth of the rows inactive, and the last `capacity - rows` slots
    padding."""
    rng = np.random.default_rng(seed)
    n = rows

    def obj(vals):
        a = np.empty(n, dtype=object)
        a[:] = vals
        return a

    arrays = [
        rng.integers(0, 37, n).astype(np.int64),
        obj([WORDS[i] for i in rng.integers(0, len(WORDS), n)]),
        obj([int(x) * (10 ** 19) + int(y) for x, y in
             zip(rng.integers(-40, 40, n), rng.integers(0, 999, n))]),
        obj([[int(v) if rng.random() > 0.2 else None
              for v in rng.integers(-5, 6, rng.integers(0, 4))]
             for _ in range(n)]),
        obj([(int(rng.integers(-9, 9)) if rng.random() > 0.2 else None,
              WORDS[rng.integers(0, 4)]) for _ in range(n)]),
        rng.normal(size=n),
    ]
    nulls = [rng.random(n) < 1 / 7 for _ in SIGS]
    rb = RB.batch_from_numpy([RT.parse_type(s) for s in SIGS], arrays,
                             nulls=nulls, capacity=capacity)
    pb = PB.batch_from_numpy([PT.parse_type(s) for s in SIGS], arrays,
                             nulls=nulls, capacity=capacity, device="cpu")
    keep = np.ones(capacity, dtype=bool)
    keep[rng.random(capacity) < 0.1] = False
    rb = rb.with_active(rb.active & jax.numpy.asarray(keep))
    pb = pb.with_active(pb.active & torch.from_numpy(keep))
    return rb, pb


def exact_sorted(res):
    """A result's rows in the corpora's exact form, sorted."""
    from presto_tpu_torch.queries import exact_rows
    types = [PT.parse_type(str(t)) for t in res.types]
    return sorted(map(repr, exact_rows(res.columns, res.nulls, types,
                                       res.row_count)))


def assert_tpch_mesh_equals_one_device(n, sf=0.01):
    """TPC-H qn (the corpus's text and capacities) through the port's
    `sql` on eight CPU workers returns the port's one-device rows,
    exactly."""
    from presto_tpu_torch import sql
    from presto_tpu_torch.queries import load_corpus
    e = load_corpus()[f"q{n}_two_stage"]
    kw = dict(max_groups=e["max_groups"], join_capacity=e["join_capacity"])
    one = sql(e["sql"], sf=sf, device="cpu", **kw)
    mesh = sql(e["sql"], sf=sf, mesh=port_mesh(), **kw)
    assert mesh.names == one.names
    assert exact_sorted(mesh) == exact_sorted(one)
    return one, mesh
