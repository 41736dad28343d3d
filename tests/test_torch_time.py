"""Port time-domain tracer (kernel K5's plain version) vs the JAX package.

The same domain (carried across by ``convert``) and the same JAX-drawn
rays go through JAX ``solve`` / ``trace_rk4`` / ``_rhs`` and the port's.
Tolerance per exit column: atol = 1e-6 * max|column|, same NaN pattern;
rf rows and the Jones vector (whose angle is the phase column) 2e-6 of
their scale.
The port follows the multiply-adds XLA's CPU compiler fuses in the JAX
step (the corner sum and each s + c k); most exit columns come out
bit-equal, and where XLA's vectorised corner sum rounds another way a
velocity component differs in the last place. The step constants
(t_end, dt, n_steps) are equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields.domain import build_pack as jbuild_pack
from synthpy_tpu.fields.domain import layout_of
from synthpy_tpu.tracer import init_beam
from synthpy_tpu.tracer import propagator as jprop
from synthpy_tpu_torch import convert
from synthpy_tpu_torch import tracer as ttracer
from synthpy_tpu_torch.fields.domain import build_pack
from synthpy_tpu_torch.kernels import march
from synthpy_tpu_torch.tracer import propagator as tprop

torch.set_num_threads(1)

EXT = 5e-3
TOL = 1e-6


def scene(layout=(False, False, False), probe="z", dims=(21, 23, 25)):
    """A lens (along the probing axis) with the switched-on channels."""
    ib, ps, bon = layout
    jd = JDomain(2 * EXT, dims, probing_direction=probe,
                 inv_brems=ib, phaseshift=ps)
    jd.test_liner(ne_0=8e24, LR=1.8e-3) if probe == "y" else \
        jd.test_lens(ne_0=8e24, LR=1.8e-3)
    if ib:
        rng = np.random.default_rng(1)
        jd.external_Te(50.0 + 10.0 * rng.random(jd.dims))
        jd.external_Z(2.0 * np.ones(jd.dims))
    if bon:
        jd.test_B(Bmax=10.0)
    return jd


def rays(probe, n=2048, seed=0):
    return init_beam(jax.random.PRNGKey(seed), n, 2.5e-3, 1e-3, EXT,
                     "circular", probe)


def assert_columns_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    for c in range(want.shape[0]):
        scale = np.nanmax(np.abs(want[c])) if want.size else 0.0
        np.testing.assert_allclose(got[c], want[c], rtol=0,
                                   atol=tol * max(scale, 1e-30),
                                   err_msg=f"column {c}")


LAYOUTS = [(ib, ps, b) for ib in (False, True) for ps in (False, True)
           for b in (False, True)]
CASES = ([(lay, "z") for lay in LAYOUTS]
         + [((True, True, True), "x"), ((True, True, True), "y")])


@pytest.mark.parametrize("layout,probe", CASES)
def test_solve_matches_jax(layout, probe):
    jd = scene(layout, probe)
    s0 = rays(probe)
    td = convert.domain(jd, "cpu")
    want = jprop.solve(s0, jd, return_E=True)
    got = tprop.solve(convert.tensor(s0, "cpu"), td, return_E=True)
    assert got.duration >= 0
    # the rays were deflected, and the enabled channels moved
    assert np.abs(np.asarray(want.sf)[3 + "xyz".index(probe) - 2]).max() > 0
    assert_columns_close(got.sf.numpy(), want.sf)
    for row in range(4):
        w = np.asarray(want.rf)[row]
        np.testing.assert_allclose(got.rf.numpy()[row], w, rtol=0,
                                   atol=2 * TOL * np.abs(w).max())
    # the Jones vector turns with the phase column (hundreds of radians
    # when phaseshift is on): its tolerance is that column's
    phase = np.abs(np.asarray(want.sf)[7]).max()
    np.testing.assert_allclose(got.Jf.numpy(), np.asarray(want.Jf), rtol=0,
                               atol=2 * TOL * max(phase, 1.0))


@pytest.mark.parametrize("layout", [(False, False, False), (True, True, True)])
def test_trace_rk4_and_rhs_match_jax(layout):
    """The compiled JAX step and the port's plain step: one step, and 30,
    rays partly outside the box and a NaN ray included; and the
    right-hand side on its own."""
    jd = scene(layout, "z", dims=33)
    jp = jbuild_pack(jd)
    tp = convert.trace_pack(jp, "cpu")
    s0 = np.asarray(rays("z", 1024)).copy()
    s0[0, ::5] += 4e-3       # a fifth of the bundle leaves the box
    s0[5, 7] = np.nan
    rows = s0.T.copy()
    lay = layout_of(jd)
    dt = jnp.asarray(jnp.sqrt(8.0) * EXT / 299792458.0 / 40, jnp.float32)
    for n in (1, 30):
        want = np.asarray(jprop.trace_rk4(rows, jp.channels, jp.origin,
                                          jp.inv_spacing, dt, layout=lay,
                                          n_steps=n))
        got = tprop.trace_rk4(torch.from_numpy(rows), tp.channels, tp.origin,
                              tp.inv_spacing, float(dt), layout=lay,
                              n_steps=n).numpy()
        assert_columns_close(got.T, want.T)
    rhs = jax.jit(lambda s: jprop._rhs(s, jp.channels, jp.origin,
                                       jp.inv_spacing, lay, -1.0))
    got = tprop._rhs(torch.from_numpy(rows), tp.channels,
                     torch.from_numpy(tp.origin),
                     torch.from_numpy(tp.inv_spacing), lay, -1.0).numpy()
    assert_columns_close(got.T, np.asarray(rhs(rows)).T)


@pytest.mark.parametrize("dims,depth,spc", [
    ((21, 21, 21), None, 1.0), ((17, 19, 33), 7e-3, 1.0),
    ((512, 512, 512), None, 1.0), ((64, 64, 100), 3e-3, 2.5)])
def test_step_constants_match_jax(dims, depth, spc):
    jd = JDomain(2 * EXT, dims)
    td = convert.domain(jd, "cpu")
    depth = jd.extent if depth is None else depth
    n = tprop.default_n_steps(td, depth, spc)
    assert n == jprop.default_n_steps(jd, depth, spc)
    t_end = jnp.sqrt(8.0) * depth / 299792458.0
    assert tprop.t_end_of(depth) == np.float32(t_end)
    assert tprop.dt_of(n, depth) == float(jnp.asarray(t_end / n,
                                                      jnp.float32))
    assert tprop.dt_of(n, depth, t_end=1e-10) == float(np.float32(1e-10 / n))
    if dims == (512, 512, 512):
        assert n == 723


def test_solve_options_and_exports():
    jd = scene((False, True, False), "z", dims=21)
    s0 = rays("z", 256, seed=4)
    td = convert.domain(jd, "cpu")
    ts0 = convert.tensor(s0, "cpu")
    for kw in (dict(n_steps=12), dict(steps_per_cell=2.0),
               dict(t_end=2e-11, n_steps=9), dict(keep_current_plane=True),
               dict(probing_depth=EXT * 1.5)):
        want = jprop.solve(s0, jd, **kw)
        got = ttracer.solve(ts0, td, pack=build_pack(td), **kw)
        assert_columns_close(got.sf.numpy(), want.sf)
        assert_columns_close(got.rf.numpy(), want.rf, tol=2 * TOL)
    import synthpy_tpu_torch
    assert synthpy_tpu_torch.solve is ttracer.solve


def test_ray_order_of_3d_cell():
    """K5 and K6 take the rays in the order of their 3-D corner cell (the
    trilinear's clip(floor(t), 0, n - 2), a NaN giving 0), stably."""
    jd = scene(dims=(21, 23, 25))
    jp = jbuild_pack(jd)
    s0 = np.asarray(rays("z", 4096, seed=5)).copy()
    s0[0, ::7] += 6e-3           # past the upper edge in x
    s0[1, ::11] -= 6e-3          # past the lower edge in y
    s0[2, 3] = np.nan
    rows = torch.from_numpy(s0.T.copy())
    dims = jp.channels.shape[:3]
    o = np.asarray(jp.origin, np.float32)
    inv = np.asarray(jp.inv_spacing, np.float32)
    idx = []
    for a in range(3):
        t = np.floor((s0[a] - o[a]) * inv[a])
        idx.append(np.clip(np.nan_to_num(t, nan=0.0), 0, dims[a] - 2)
                   .astype(np.int64))
    want = (idx[0] * dims[1] + idx[1]) * dims[2] + idx[2]
    got = march.entry_cells(rows, dims, jp.origin, jp.inv_spacing)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        march.ray_order(rows, dims, jp.origin, jp.inv_spacing).numpy(),
        np.argsort(want, kind="stable"))
