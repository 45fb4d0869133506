"""limb_partial_sums: the port's plain version against the reference's
Pallas kernel (interpret mode) in both limb forms, and the wrapper's
argument checks. The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import presto_tpu  # noqa: F401  (enables jax x64 before any jnp array)
import jax.numpy as jnp
from presto_tpu.ops import aggregation as RA
from presto_tpu.ops.pallas_kernels import limb_partial_sums as ref_kernel

from presto_tpu_torch.ops import aggregation as PA
from presto_tpu_torch.ops import kernels as K

FORMS = {"narrow": (np.int16, jnp.bfloat16, -128, 256),
         "wide": (np.float32, jnp.float32, -8191, 8192)}


def _ref(ids, limbs, groups, form):
    _, compute, _, _ = FORMS[form]
    return np.asarray(ref_kernel(jnp.asarray(ids), jnp.asarray(limbs),
                                 groups, interpret=True,
                                 compute_dtype=compute))


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("n,groups,L", [(2048, 16, 7), (1500, 5, 3),
                                        (3000, 64, 9)])
def test_plain_matches_pallas_reference(form, n, groups, L):
    dt, _, lo, hi = FORMS[form]
    rng = np.random.default_rng(n + groups)
    ids = rng.integers(0, groups, n).astype(np.int32)
    limbs = rng.integers(lo, hi, (n, L)).astype(dt)
    got = K.limb_partial_sums(torch.from_numpy(ids), torch.from_numpy(limbs),
                              groups)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), _ref(ids, limbs, groups, form))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_padding_and_out_of_range_ids_drop(form):
    dt = FORMS[form][0]
    ids = np.array([0, 1, 2, 3, 16, 16, 2, -1, 99], np.int32)
    limbs = np.ones((9, 3), dt)
    got = K.limb_partial_sums(torch.from_numpy(ids), torch.from_numpy(limbs),
                              16).numpy()
    assert got.shape == (1, 16, 3)
    tot = got.sum(axis=0)
    assert tot[0, 0] == 1 and tot[2, 0] == 2
    assert tot.sum() == 5 * 3  # ids 16, -1 and 99 contribute nothing
    # the reference's sentinel (id == G) drops the same rows
    keep = (ids >= 0) & (ids < 16)
    assert np.array_equal(
        got, _ref(np.where(keep, ids, 16), limbs, 16, form))


@pytest.mark.parametrize("form,top", [("narrow", 255), ("wide", 8191)])
def test_worst_case_tile_is_exact(form, top):
    """Every limb at its form's extreme over a full tile: the largest
    per-tile sum the kernel must hold exactly in float32."""
    dt = FORMS[form][0]
    n = 2 * K.SUM_TILE
    ids = np.zeros(n, np.int32)
    ids[K.SUM_TILE:] = 15
    for sign in (1, -1):
        limbs = np.full((n, 4), sign * top, dt)
        got = K.limb_partial_sums(torch.from_numpy(ids),
                                  torch.from_numpy(limbs), 16).numpy()
        assert got[0, 0, 0] == sign * top * K.SUM_TILE
        assert got[1, 15, 3] == sign * top * K.SUM_TILE
        assert np.array_equal(got, _ref(ids, limbs, 16, form))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    ids = torch.zeros(8, dtype=torch.int32)
    limbs = torch.zeros((8, 2), dtype=torch.int16)
    with pytest.raises(TypeError):
        K.limb_partial_sums(ids.to(torch.int64), limbs, 4)
    with pytest.raises(TypeError):
        K.limb_partial_sums(ids, limbs.to(torch.int32), 4)
    with pytest.raises(ValueError):
        K.limb_partial_sums(ids, limbs, 65)
    with pytest.raises(ValueError):
        K.limb_partial_sums(ids[:4], limbs, 4)
    # a device with no kernel raises; nothing falls back to the CPU form
    with pytest.raises(ValueError, match="no kernel"):
        K.limb_partial_sums(ids.to("meta"), limbs.to("meta"), 4)


@pytest.mark.parametrize("form", ["narrow", "wide"])
def test_fused_limb_sums_matches_reference_pool(form, monkeypatch):
    """The whole fused pool (limb split, one kernel call, int64 tile
    combine) against the reference's einsum form of the same pool."""
    monkeypatch.setenv("PRESTO_TPU_SMALLG", "einsum")
    monkeypatch.setenv("PRESTO_TPU_BF16", "1" if form == "narrow" else "0")
    rng = np.random.default_rng(11)
    n, groups = 5000, 16
    ids = rng.integers(0, groups, n).astype(np.int32)
    reqs = [(rng.integers(-(1 << 40), 1 << 40, n), 48),
            (rng.integers(-8191, 8192, n), 13),
            (rng.integers(0, 2, n), 1),
            (rng.integers(-(1 << 62), 1 << 62, n), 64)]
    want = RA._fused_limb_sums(jnp.asarray(ids),
                               [(jnp.asarray(c), b) for c, b in reqs],
                               groups)
    got = PA._fused_limb_sums(torch.from_numpy(ids),
                              [(torch.from_numpy(c), b) for c, b in reqs],
                              groups, form)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
