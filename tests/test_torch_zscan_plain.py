"""Port plain z-scan march (kernel K4's plain version) vs the JAX package.

The same TracePack (built by JAX, carried across by ``convert``) and the
same JAX-drawn rays go through JAX ``make_zscan_pack`` / ``trace_zscan`` /
``solve_zscan`` and the port's, on float32 and bfloat16 planes with one
and four substeps. Packs are compared bit for bit; exit columns within
atol = 1e-6 * max|column| with the same NaN pattern (float order differs
where XLA fuses multiply-adds, which the plain march does not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import pipeline as jpipe
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields.domain import build_pack as jbuild_pack
from synthpy_tpu.fields.domain import layout_of
from synthpy_tpu.tracer import init_beam
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu_torch import convert
from synthpy_tpu_torch import pipeline as tpipe
from synthpy_tpu_torch.tracer import zscan as tz

torch.set_num_threads(1)

EXT = 5e-3
TOL = 1e-6
BINS = (54, 40)


def scene(probe="z", physics=False, dims=(21, 23, 25)):
    """A lens along the probing axis; with ``physics``, absorption, phase
    and a field B along the probing axis (Faraday rotation adds up along
    the ray instead of cancelling, so the pol column is well
    conditioned)."""
    jd = JDomain(2 * EXT, dims, probing_direction=probe,
                 inv_brems=physics, phaseshift=physics)
    jd.test_liner(ne_0=8e24, LR=1.8e-3) if probe == "y" else \
        jd.test_lens(ne_0=8e24, LR=1.8e-3)
    if physics:
        rng = np.random.default_rng(2)
        jd.external_Te(50.0 + 10.0 * rng.random(jd.dims))
        jd.external_Z(2.0 * np.ones(jd.dims))
        B = np.zeros((*jd.dims, 3), np.float32)
        B[..., "xyz".index(probe)] = 10.0 * (1.0 + rng.random(jd.dims))
        jd.external_B(B)
    return jd


def permuted(s0, probe):
    p = "xyz".index(probe)
    a, b = [i for i in range(3) if i != p]
    s = np.asarray(s0)
    return np.stack([s[a], s[b], s[3 + a], s[3 + b], s[3 + p], s[6], s[7],
                     s[8]], axis=1)


def assert_columns_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    for c in range(want.shape[1]):
        scale = np.nanmax(np.abs(want[:, c])) if want.size else 0.0
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=0,
                                   atol=tol * max(scale, 1e-30),
                                   err_msg=f"column {c}")


@pytest.mark.parametrize("probe,physics", [("z", False), ("z", True),
                                           ("x", True), ("y", False)])
def test_zscan_pack_matches_jax_bitwise(probe, physics):
    jd = scene(probe, physics)
    jp = jbuild_pack(jd)
    tp = convert.trace_pack(jp, "cpu")
    for dtype, tdtype in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = jz.make_zscan_pack(jp, layout_of(jd), probe, dtype=dtype)
        got = tz.make_zscan_pack(tp, layout_of(jd), probe, dtype=tdtype)
        carried = convert.zscan_pack(want, "cpu")
        assert torch.equal(got.planes, carried.planes)
        assert got.planes.is_contiguous()
        assert torch.equal(got.origin_ab, carried.origin_ab)
        assert torch.equal(got.inv_spacing_ab, carried.inv_spacing_ab)
        assert (got.p0, got.dp, got.omega) == (want.p0, want.dp, want.omega)
    K = 8
    want = jz.make_segment_pack(jz.make_zscan_pack(jp, layout_of(jd), probe),
                                K=K)
    got = tz.make_segment_pack(tz.make_zscan_pack(tp, layout_of(jd), probe),
                               K=K)
    carried = convert.segment_pack(want, "cpu")
    assert torch.equal(got.seg_planes, carried.seg_planes)
    assert got._replace(seg_planes=None, origin_ab=None,
                        inv_spacing_ab=None) == carried._replace(
        seg_planes=None, origin_ab=None, inv_spacing_ab=None)


@pytest.mark.parametrize("substeps", [1, 4])
@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("probe,physics", [("z", False), ("z", True),
                                           ("x", True)])
def test_trace_zscan_matches_jax(probe, physics, tier, substeps):
    jd = scene(probe, physics)
    lay = layout_of(jd)
    jzp = jz.make_zscan_pack(jbuild_pack(jd), lay, probe,
                             dtype=jnp.bfloat16 if tier == "bf16" else None)
    tzp = convert.zscan_pack(jzp, "cpu")
    u = permuted(init_beam(jax.random.PRNGKey(3), 2048, 2.5e-3, 1e-3, EXT,
                           "circular", probe), probe).copy()
    u[::6, 0] += 4e-3          # a sixth of the bundle outside the box
    u[11, 4] = np.nan
    n_slabs = jzp.planes.shape[0] - 1
    want = np.asarray(jz.trace_zscan(
        u, jzp.planes, jzp.origin_ab, jzp.inv_spacing_ab,
        jnp.asarray(jzp.dp, jnp.float32), layout=lay, n_slabs=n_slabs,
        substeps=substeps))
    got = tz.trace_zscan(torch.from_numpy(u), tzp.planes, tzp.origin_ab,
                         tzp.inv_spacing_ab, tzp.dp, layout=lay,
                         n_slabs=n_slabs, substeps=substeps).numpy()
    assert np.nanmax(np.abs(want[:, 2] - u[:, 2])) > 0   # deflected
    assert_columns_close(got, want)


@pytest.mark.parametrize("sort_rays", [False, True])
def test_solve_zscan_matches_jax(sort_rays):
    jd = scene("z", True)
    s0 = init_beam(jax.random.PRNGKey(5), 2048, 2.5e-3, 1e-3, EXT,
                   "circular")
    td = convert.domain(jd, "cpu")
    ts0 = convert.tensor(s0, "cpu")
    for kw in (dict(), dict(substeps=4, probing_depth=7e-3)):
        want = jz.solve_zscan(s0, jd, return_E=True, sort_rays=sort_rays,
                              **kw)
        got = tz.solve_zscan(ts0, td, return_E=True, sort_rays=sort_rays,
                             **kw)
        assert got.duration >= 0
        assert_columns_close(got.sf.numpy().T, np.asarray(want.sf).T)
        assert_columns_close(got.rf.numpy().T, np.asarray(want.rf).T,
                             tol=2 * TOL)
    import synthpy_tpu_torch
    assert synthpy_tpu_torch.solve_zscan is tz.solve_zscan


def _close_images(Ht, Hj, frac=0.002):
    Ht = Ht.numpy()
    Hj = np.asarray(Hj)
    assert Ht.shape == Hj.shape == (BINS[1], BINS[0])
    assert Ht.sum() == Hj.sum() > 0
    assert np.abs(Ht - Hj).sum() <= frac * Hj.sum()


def test_default_run_is_plain_zscan_like_jax():
    """``run(domain, s0)`` with no solver is the plain z-scan march in both
    packages; the bf16 ZScanPack and sort_rays go through synth_image_zscan
    as in JAX, and the plain march takes no integrator."""
    jd = JDomain(2 * EXT, 33).test_lens(ne_0=5e24, LR=1.5e-3)
    s0 = init_beam(jax.random.PRNGKey(0), 8192, 2e-3, 0.0, EXT, "circular")
    td, ts0 = convert.domain(jd, "cpu"), convert.tensor(s0, "cpu")
    _close_images(tpipe.run(td, ts0, bins=BINS), jpipe.run(jd, s0, bins=BINS))
    jzp = jz.make_zscan_pack(jbuild_pack(jd), layout_of(jd),
                             dtype=jnp.bfloat16)
    kw = dict(bins=BINS, sort_rays=True, steps_per_cell=2.0)
    Hj = jpipe.run(jd, s0, zpack=jzp, **kw)
    Ht = tpipe.run(td, ts0, zpack=convert.zscan_pack(jzp, "cpu"), **kw)
    _close_images(Ht, Hj)
    with pytest.raises(ValueError, match="plain zscan tracer is rk4"):
        tpipe.run(td, ts0, bins=BINS, integrator="rk2")
