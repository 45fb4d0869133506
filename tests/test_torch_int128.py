"""The port's 128-bit lane arithmetic against presto_tpu.int128.

The reference holds `lo` (and every unsigned word) as uint64; the port
holds the same bits as int64. Inputs are seeded numpy vectors plus
edge values (0, +-1, +-2^63, carries across lo); results must match bit
for bit.
"""

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
import jax.numpy as jnp
from presto_tpu import int128 as R

from presto_tpu_torch import int128 as P

I64_EDGES = [0, 1, -1, (1 << 63) - 1, -(1 << 63), (1 << 32), -(1 << 32),
             (1 << 32) - 1, 12345678901234, -98765432109876]


def _i64(rng, n=64):
    v = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64,
                     endpoint=True)
    return np.concatenate([np.array(I64_EDGES, np.int64), v])


def _lo(rng, n=64):
    """uint64 lanes with carry-prone values."""
    edges = np.array([0, 1, (1 << 64) - 1, (1 << 63), (1 << 63) - 1,
                      (1 << 64) - 2, 0xFFFFFFFF, 1 << 32, 7, 99],
                     dtype=np.uint64)
    return np.concatenate([edges, rng.integers(0, (1 << 64) - 1, n,
                                               dtype=np.uint64,
                                               endpoint=True)])


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    return torch.from_numpy(a.copy())


def _np(x):
    """Reference lanes as int64 bit patterns."""
    a = np.asarray(x)
    return a.view(np.int64) if a.dtype == np.uint64 else a


def _eq(ref, port):
    if isinstance(ref, (tuple, list)):
        assert len(ref) == len(port)
        for r, p in zip(ref, port):
            _eq(r, p)
        return
    r = _np(ref)
    p = port.numpy()
    if r.dtype == np.bool_:
        assert np.array_equal(r, p)
    else:
        assert np.array_equal(r.astype(np.int64), p.astype(np.int64))


@pytest.fixture
def lanes():
    rng = np.random.default_rng(7)
    a, b = _i64(rng), _i64(rng)[::-1].copy()
    return rng, a, b, _lo(rng), _lo(rng)[::-1].copy()


def test_add_neg_from_int64_and_cmp(lanes):
    _, a, b, al, bl = lanes
    ra = (jnp.asarray(a), jnp.asarray(al))
    rb = (jnp.asarray(b), jnp.asarray(bl))
    pa, pb = (_t(a), _t(al)), (_t(b), _t(bl))
    _eq(R.add128(*ra, *rb), P.add128(*pa, *pb))
    _eq(R.neg128(*ra), P.neg128(*pa))
    _eq(R.from_int64(jnp.asarray(a)), P.from_int64(_t(a)))
    _eq(R.cmp128(*ra, *rb), P.cmp128(*pa, *pb))
    _eq(R.cmp128(*ra, *ra), P.cmp128(*pa, *pa))


@pytest.mark.parametrize("s", [0, 1, 13, 51, 63, 64, 65, 117, 127])
def test_shl128_const(lanes, s):
    _, a, _, _, _ = lanes
    _eq(R.shl128_const(jnp.asarray(a), s), P.shl128_const(_t(a), s))


def test_multiplies(lanes):
    _, a, b, al, bl = lanes
    _eq(R.mulu64_wide(jnp.asarray(al), jnp.asarray(bl)),
        P.mulu64_wide(_t(al), _t(bl)))
    _eq(R.mul_i64_i64_128(jnp.asarray(a), jnp.asarray(b)),
        P.mul_i64_i64_128(_t(a), _t(b)))
    _eq(R.mul128(jnp.asarray(a), jnp.asarray(al), jnp.asarray(b),
                 jnp.asarray(bl)),
        P.mul128(_t(a), _t(al), _t(b), _t(bl)))
    for m in (1, 10, 10 ** 18, (1 << 63) - 1):
        _eq(R.mul128_by_u64(jnp.asarray(a), jnp.asarray(al), m),
            P.mul128_by_u64(_t(a), _t(al), m))
    _eq(R.rescale128_up(jnp.asarray(a), jnp.asarray(al), 10 ** 20),
        P.rescale128_up(_t(a), _t(al), 10 ** 20))


def test_signed_product_is_exact(lanes):
    _, a, b, _, _ = lanes
    hi, lo = P.mul_i64_i64_128(_t(a), _t(b))
    got = P.int128_to_python(hi.numpy(), lo.numpy())
    assert list(got) == [int(x) * int(y) for x, y in zip(a, b)]


@pytest.mark.parametrize("nlimbs", [1, 2, 3, 5])
@pytest.mark.parametrize("bits", [8, 13])
def test_limb_splits(lanes, nlimbs, bits):
    _, a, _, al, _ = lanes
    _eq(R.limbs_of_i64(jnp.asarray(a), bits, nlimbs),
        P.limbs_of_i64(_t(a), bits, nlimbs))
    _eq(R.limbs13_of_i64(jnp.asarray(a), nlimbs),
        P.limbs13_of_i64(_t(a), nlimbs))


def test_limbs13_of_128_and_recombine(lanes):
    _, a, _, al, _ = lanes
    ref = R.limbs13_of_128(jnp.asarray(a), jnp.asarray(al))
    port = P.limbs13_of_128(_t(a), _t(al))
    _eq(ref, port)
    # the limbs recombine into the original value
    hi, lo = P.combine_limb_totals_128(torch.stack(port, dim=-1))
    assert np.array_equal(hi.numpy(), a)
    assert np.array_equal(lo.numpy(), al.view(np.int64))
    # and summed limb totals recombine like the reference's
    tot = np.stack([np.asarray(l) for l in ref], axis=-1)[:72] \
        .reshape(4, 18, 10).sum(axis=1)
    _eq(R.combine_limb_totals_128(jnp.asarray(tot)),
        P.combine_limb_totals_128(torch.from_numpy(tot)))


def test_division(lanes):
    rng, a, _, al, _ = lanes
    n = len(a)
    counts = np.concatenate([[1, 2, 3, 7, (1 << 47) - 1],
                             rng.integers(1, 1 << 40, n - 5)]).astype(np.int64)
    # div128_by_count needs |value| < 2^110 for rem * 2^16 headroom; use
    # 96-bit magnitudes of both signs
    hi = (a >> 32).astype(np.int64)
    _eq(R.div128_by_count(jnp.asarray(hi), jnp.asarray(al),
                          jnp.asarray(counts)),
        P.div128_by_count(_t(hi), _t(al), _t(counts)))
    d = np.concatenate([[1, 3, (1 << 63) - 1, (1 << 62) + 1, 10],
                        rng.integers(1, (1 << 63) - 1, n - 5)]).astype(np.int64)
    mag = np.abs(hi)
    _eq(R.divmod128_by_u64(jnp.asarray(mag), jnp.asarray(al),
                           jnp.asarray(d)),
        P.divmod128_by_u64(_t(mag), _t(al), _t(d)))


def test_python_conversions(lanes):
    _, a, _, al, _ = lanes
    vals = [int(h) * (1 << 64) + int(l) for h, l in zip(a, al)] + [None]
    rh, rl = R.python_to_int128(vals)
    ph, pl = P.python_to_int128(vals)
    assert np.array_equal(rh, ph)
    assert np.array_equal(rl.view(np.int64), pl)
    assert list(R.int128_to_python(rh, rl)) == \
        list(P.int128_to_python(ph, pl))
