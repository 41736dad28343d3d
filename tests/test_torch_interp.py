"""Port ``ops.interp`` vs the JAX package's ``ops.interp`` on the same numpy
grids and points, in and out of the box.

Tolerance: atol = 1e-6 * max|value| (observed: equal). ``trilinear`` is
held to the eager JAX function (each operation rounded on its own). Its
``contract=True`` form, the corner sum of the compiled JAX tracers, is
held to the compiled JAX time step in test_torch_time.py; here it stays
within atol = 1e-5 * max|value| of the uncontracted sum, which it rounds
differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.ops import interp as jinterp
from synthpy_tpu_torch.ops import interp as tinterp

torch.set_num_threads(1)

TOL = 1e-6


def _grid(seed, dims, C):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=(*dims, C) if C else dims).astype(np.float32)
    coords = [np.linspace(-1.0 - 0.1 * d, 1.5 + 0.2 * d, n,
                          dtype=np.float32) for d, n in enumerate(dims)]
    # points inside, outside on every face, on the far edges, and a NaN
    pts = rng.uniform(-1.6, 2.2, size=(3000, 3)).astype(np.float32)
    pts[:3] = [c[-1] for c in coords]
    pts[3] = [c[0] for c in coords]
    pts[4, 1] = np.nan
    return values, coords, pts


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.nanmax(np.abs(want)))


@pytest.mark.parametrize("C", [0, 1, 4, 8])
@pytest.mark.parametrize("dims", [(21, 23, 25), (9, 7, 5)])
def test_trilinear_matches_jax(dims, C):
    values, coords, pts = _grid(C + dims[0], dims, C)
    origin = np.array([c[0] for c in coords], np.float32)
    inv = np.array([1.0 / (c[1] - c[0]) for c in coords], np.float32)
    want = jinterp.trilinear(values, pts, origin, inv)
    got = tinterp.trilinear(torch.from_numpy(values), torch.from_numpy(pts),
                            origin, inv)
    _close(got.numpy(), want)
    assert np.asarray(want)[5:][np.all(np.abs(pts[5:]) > 2.0, 1)].sum() == 0
    got_c = tinterp.trilinear(torch.from_numpy(values), torch.from_numpy(pts),
                              origin, inv, contract=True).numpy()
    np.testing.assert_array_equal(np.isnan(got_c), np.isnan(got.numpy()))
    np.testing.assert_allclose(got_c, got.numpy(), rtol=0,
                               atol=10 * TOL * np.abs(values).max())


def test_trilinear_fill_value_and_regular_grid_interpolator():
    values, coords, pts = _grid(3, (11, 12, 13), 0)
    want = jinterp.regular_grid_interpolator(
        [jnp.asarray(c) for c in coords], values, pts, fill_value=-2.5)
    got = tinterp.regular_grid_interpolator(
        [torch.from_numpy(c) for c in coords], torch.from_numpy(values),
        torch.from_numpy(pts), fill_value=-2.5)
    _close(got.numpy(), want)
    assert (got == -2.5).any()
    o, i = tinterp.grid_geometry([torch.from_numpy(c) for c in coords])
    jo, ji = jinterp.grid_geometry([jnp.asarray(c) for c in coords])
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    vec = np.full(3, 7.0, np.float32)
    values4, _, _ = _grid(4, (11, 12, 13), 3)
    origin = np.asarray(jo)
    inv = np.asarray(ji)
    _close(tinterp.trilinear(torch.from_numpy(values4),
                             torch.from_numpy(pts), origin, inv,
                             fill_value=torch.from_numpy(vec)).numpy(),
           jinterp.trilinear(values4, pts, origin, inv, fill_value=vec))


@pytest.mark.parametrize("C", [0, 2])
def test_trilinear_nonuniform_matches_jax(C):
    rng = np.random.default_rng(11 + C)
    dims = (9, 10, 11)
    coords = [np.sort(rng.uniform(-1.0, 1.0, n)).astype(np.float32)
              for n in dims]
    values = rng.normal(size=(*dims, C) if C else dims).astype(np.float32)
    pts = rng.uniform(-1.2, 1.2, size=(2000, 3)).astype(np.float32)
    want = jinterp.trilinear_nonuniform([jnp.asarray(c) for c in coords],
                                        values, pts, fill_value=0.5)
    got = tinterp.trilinear_nonuniform([torch.from_numpy(c) for c in coords],
                                       torch.from_numpy(values),
                                       torch.from_numpy(pts), fill_value=0.5)
    _close(got.numpy(), want)


def test_fma_rounds_once():
    a = torch.tensor([1.0 + 2.0**-23], dtype=torch.float32)
    c = torch.tensor([-1.0 - 2.0**-22], dtype=torch.float32)
    # a * a = 1 + 2^-22 + 2^-46: the separate product rounds the 2^-46 away
    assert float(tinterp.fma(a, a, c)) == 2.0**-46
    assert float(a * a + c) == 0.0
