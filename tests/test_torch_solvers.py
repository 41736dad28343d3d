"""The slice as a whole: port ``pipeline.run(solver="time"|"zscan")``, the
critical-density fallback and ``run_split`` vs the JAX package, with the
same JAX-drawn rays; and the packs carried across by ``convert``.

Images: equal sums and |H_port - H_jax|.sum() <= 0.002 * H_jax.sum() (a
ray within the last place of a bin edge can land in the next bin). The
run_split and fallback checks mirror tests/test_critical.py.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import constants
from synthpy_tpu import pipeline as jpipe
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields.domain import build_pack as jbuild_pack
from synthpy_tpu.fields.domain import layout_of
from synthpy_tpu.tracer import init_beam
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu_torch import convert
from synthpy_tpu_torch import pipeline as tpipe

torch.set_num_threads(1)

EXT = 5e-3
LWL = 1064e-9
NC = float(constants.critical_density(constants.omega_from_lwl(LWL)))


def _close_images(Ht, Hj, frac=0.002):
    Ht = Ht.numpy() if isinstance(Ht, torch.Tensor) else Ht
    Hj = np.asarray(Hj)
    assert Ht.shape == Hj.shape
    assert Ht.sum() == Hj.sum() > 0
    assert np.abs(Ht - Hj).sum() <= frac * Hj.sum()


@pytest.fixture(scope="module")
def bench():
    jd = JDomain(2 * EXT, 33).test_lens(ne_0=5e24, LR=1.5e-3)
    s0 = init_beam(jax.random.PRNGKey(0), 8192, 2e-3, 0.0, EXT, "circular")
    return jd, convert.domain(jd, "cpu"), s0, convert.tensor(s0, "cpu")


@pytest.mark.parametrize("solver", ["time", "zscan"])
def test_run_images_match_jax(bench, solver):
    jd, td, s0, ts0 = bench
    names = ("shadowgraphy", "schlieren_df", "refractometry")
    kw = dict(solver=solver, bins=(54, 40), diagnostic=names)
    Hj = jpipe.run(jd, s0, **kw)
    Ht = tpipe.run(td, ts0, **kw)
    assert set(Ht) == set(names)
    for n in names:
        _close_images(Ht[n], Hj[n])


def test_time_path_options_match_jax(bench):
    """A carried pack, an explicit step count, a deeper exit plane, and the
    polarimetry weights, on the x-probing physics scene."""
    jd = JDomain(2 * EXT, (21, 23, 25), probing_direction="x",
                 phaseshift=True).test_lens(ne_0=8e24, LR=1.8e-3)
    jd.test_B(Bmax=10.0)
    s0 = init_beam(jax.random.PRNGKey(2), 4096, 2e-3, 0.0, EXT, "circular",
                   "x")
    td, ts0 = convert.domain(jd, "cpu"), convert.tensor(s0, "cpu")
    jp = jbuild_pack(jd)
    kw = dict(solver="time", bins=(54, 40), n_steps=30, probing_depth=6e-3,
              diagnostic=("shadowgraphy", "polarimetry"))
    Hj = jpipe.run(jd, s0, pack=jp, **kw)
    Ht = tpipe.run(td, ts0, pack=convert.trace_pack(jp, "cpu"), **kw)
    _close_images(Ht["shadowgraphy"], Hj["shadowgraphy"])
    np.testing.assert_allclose(Ht["polarimetry"].sum(),
                               np.asarray(Hj["polarimetry"]).sum(),
                               rtol=1e-5)


def overcritical(n=31, peak=1.5):
    """Gaussian barrier along z peaking at ``peak`` * nc
    (tests/test_critical.py)."""
    d = JDomain(2 * EXT, n)
    prof = peak * NC * np.exp(-(np.asarray(d.z) / (0.3 * EXT)) ** 2)
    return d.external_ne(np.broadcast_to(prof[None, None, :],
                                         (n, n, n)).copy())


def test_guard_falls_back_to_time_solver():
    jd = overcritical()
    td = convert.domain(jd, "cpu")
    s0 = init_beam(jax.random.PRNGKey(4), 1000, 1e-3, 0.0, EXT, "circular")
    ts0 = convert.tensor(s0, "cpu")
    with pytest.warns(UserWarning, match="critical density"):
        img = tpipe.run(td, ts0, lwl=LWL, bins=(32, 24))
    assert torch.equal(img, tpipe.run(td, ts0, solver="time", lwl=LWL,
                                      bins=(32, 24)))
    assert bool(torch.isfinite(img).all())
    with pytest.warns(UserWarning, match="critical density"):
        img_j = jpipe.run(jd, s0, lwl=LWL, bins=(32, 24))
    np.testing.assert_array_equal(img.numpy(), np.asarray(img_j))
    with pytest.warns(UserWarning, match="critical density"):
        img2 = tpipe.run(td, ts0, solver="zscan_seg", lwl=LWL,
                         bins=(32, 24), seg_K=8)
    assert torch.equal(img2, img)


def test_guard_fallback_drops_solver_specific_kwargs():
    td = convert.domain(overcritical(), "cpu")
    s0 = convert.tensor(init_beam(jax.random.PRNGKey(4), 500, 1e-3, 0.0,
                                  EXT, "circular"), "cpu")
    with pytest.warns(UserWarning, match="dropping integrator, seg_weights"):
        img = tpipe.run(td, s0, solver="zscan_seg", lwl=LWL, bins=(16, 12),
                        seg_K=8, integrator="rk2", seg_weights="slab",
                        pack_dtype="bf16")
    assert bool(torch.isfinite(img).all())
    # below the threshold the guard is silent
    quiet = convert.domain(JDomain(2 * EXT, 21).test_lens(1e23, 2e-3), "cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        img = tpipe.run(quiet, s0, lwl=LWL, bins=(16, 12))
    assert not [w for w in rec if "critical" in str(w.message)]
    assert float(img.sum()) > 0


def filament_domain(n=41):
    """A localised overcritical filament in a subcritical lens
    (tests/test_critical.py's mixed bundle)."""
    d = JDomain(2 * EXT, n)
    x = np.asarray(d.z)
    X, Y = np.meshgrid(x, x, indexing="ij")
    r2 = X**2 + Y**2
    prof = (2.0 * NC * np.exp(-r2 / (0.6e-3) ** 2)
            + 5e24 * np.exp(-r2 / (2e-3) ** 2))
    return d.external_ne(np.broadcast_to(prof[:, :, None],
                                         (n, n, n)).copy())


def test_run_split_mixed_bundle_matches_jax():
    jd = filament_domain()
    td = convert.domain(jd, "cpu")
    s0 = init_beam(jax.random.PRNGKey(7), 20000, 3e-3, 0.0, EXT, "circular")
    ts0 = convert.tensor(s0, "cpu")
    img = tpipe.run_split(td, ts0, bins=(24, 18), pad_to=4096, seg_K=8)
    img_time = tpipe.run(td, ts0, solver="time", critical_guard=None,
                         bins=(24, 18))
    assert bool(torch.isfinite(img).all())
    rel = float((img - img_time).abs().sum() / img_time.sum())
    assert rel < 0.01, rel
    img_j = jpipe.run_split(jd, s0, bins=(24, 18), pad_to=4096, seg_K=8)
    _close_images(img, img_j)


def test_run_split_one_sided_bundles_are_exact():
    sub = JDomain(2 * EXT, 21).test_lens(5e24, 1.5e-3)
    td = convert.domain(sub, "cpu")
    s0 = convert.tensor(init_beam(jax.random.PRNGKey(8), 4096, 1.5e-3, 0.0,
                                  EXT, "circular"), "cpu")
    a = tpipe.run_split(td, s0, bins=(16, 12), pad_to=4096, seg_K=8)
    b = tpipe.run(td, s0, solver="zscan_seg", seg_K=8, critical_guard=None,
                  bins=(16, 12))
    assert torch.equal(a, b)
    td = convert.domain(overcritical(), "cpu")
    s0 = convert.tensor(init_beam(jax.random.PRNGKey(9), 2048, 1e-3, 0.0,
                                  EXT, "circular"), "cpu")
    a = tpipe.run_split(td, s0, bins=(16, 12), pad_to=2048,
                        diagnostic=["shadowgraphy", "refractometry"])
    b = tpipe.run(td, s0, solver="time", critical_guard=None, bins=(16, 12),
                  diagnostic=["shadowgraphy", "refractometry"])
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_coherent_and_analytic_paths_raise(bench):
    _, td, _, ts0 = bench
    hot = convert.domain(overcritical(n=21), "cpu")
    with pytest.raises(NotImplementedError, match="A.6"):
        tpipe.run_split(hot, ts0, bins=(16, 12), diagnostic="interferometry")
    with pytest.raises(NotImplementedError, match="A.9"):
        tpipe.run(td, ts0, solver="analytic")
    with pytest.raises(ValueError, match="unknown solver"):
        tpipe.run(td, ts0, solver="rk45")


def test_packs_carry_across_bit_for_bit():
    jd = JDomain(2 * EXT, (9, 10, 11), phaseshift=True).test_lens(5e24, 2e-3)
    jd.test_B(Bmax=3.0)
    jp = jbuild_pack(jd)
    tp = convert.trace_pack(jp, "cpu")
    np.testing.assert_array_equal(tp.channels.numpy(),
                                  np.asarray(jp.channels))
    np.testing.assert_array_equal(tp.origin, np.asarray(jp.origin))
    np.testing.assert_array_equal(tp.inv_spacing, np.asarray(jp.inv_spacing))
    assert tp.omega == jp.omega
    for dtype in (None, jnp.bfloat16):
        jzp = jz.make_zscan_pack(jp, layout_of(jd), "y", dtype=dtype)
        tzp = convert.zscan_pack(jzp, "cpu")
        planes = np.asarray(jzp.planes)
        if dtype is None:
            np.testing.assert_array_equal(tzp.planes.numpy(), planes)
        else:
            assert tzp.planes.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                tzp.planes.view(torch.int16).numpy(), planes.view(np.int16))
        np.testing.assert_array_equal(tzp.origin_ab.numpy(),
                                      np.asarray(jzp.origin_ab))
        np.testing.assert_array_equal(tzp.inv_spacing_ab.numpy(),
                                      np.asarray(jzp.inv_spacing_ab))
        assert (tzp.p0, tzp.dp, tzp.omega) == (jzp.p0, jzp.dp, jzp.omega)
