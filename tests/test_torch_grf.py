"""GRF generators and spectra (``synthpy_tpu_torch.fields.grf`` and
``spectrum``) against the JAX package, given the same key.

The noise is the same threefry draw on both sides (normals to a few ulp),
so fields agree to the order of the FFT and contraction sums: held within
1e-5 of max|f| (observed <= 3.2e-7); so does ``grf_domain_fft(mesh=)``'s
sharded field, against the single-device field and JAX's sharded one.
Coordinates within 1e-6. The classes advance their key as JAX's do. Spectra: integer and linear shells to
1e-5 (counts exact); log shells' edges are float32 powers whose last place
may move a mode across an edge, so they are held by the slope they give.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from synthpy_tpu.fields import grf as jg
from synthpy_tpu.fields import spectrum as js
from synthpy_tpu_torch import random as tr
from synthpy_tpu_torch.fields import grf as tg
from synthpy_tpu_torch.fields import spectrum as ts
from synthpy_tpu_torch.parallel import Mesh, Sharded

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)


def _close(j, t, rel=1e-5):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape
    assert np.abs(j - t).max() <= rel * np.abs(j).max(), (
        np.abs(j - t).max() / np.abs(j).max())


KEYS = [3, 11]


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("ndim,N,law,d", [(3, 8, "kolmogorov", 1.0),
                                          (2, 12, "p2", 0.5),
                                          (1, 20, "kolmogorov", 1.0)])
def test_grf_fft_matches_jax(seed, ndim, N, law, d):
    jf = jg.kolmogorov if law == "kolmogorov" else jg.power_law(2.0)
    tf = tg.kolmogorov if law == "kolmogorov" else tg.power_law(2.0)
    _close(jg.grf_fft(jax.random.PRNGKey(seed), N, jf, ndim, d),
           tg.grf_fft(tr.PRNGKey(seed), N, tf, ndim, d, device="cpu"))


@pytest.mark.parametrize("ndim,res,factor", [(3, 16, 1.0), (3, 8, 1.5),
                                             (2, 16, 1.0), (1, 32, 1.0)])
def test_grf_domain_fft_matches_jax(ndim, res, factor):
    jc, jf = jg.grf_domain_fft(jax.random.PRNGKey(5), jg.kolmogorov, 2e-3,
                               4e-4, 5e-3, res, factor=factor, ndim=ndim)
    tc, tf = tg.grf_domain_fft(tr.PRNGKey(5), tg.kolmogorov, 2e-3, 4e-4,
                               5e-3, res, factor=factor, ndim=ndim,
                               device="cpu")
    _close(jf, tf)
    assert abs(float(tf.abs().max()) - 1.0) < 1e-6
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6 * float(np.abs(a).max()))
    # mesh=: the field split over 8 shards, within 1e-5 of the
    # single-device field and of JAX's sharded field, the coords equal
    tmesh = Mesh((8,), ("grid",), devices=["cpu"] * 8)
    if ndim == 1:
        with pytest.raises(ValueError, match="ndim >= 2"):
            tg.grf_domain_fft(tr.PRNGKey(5), tg.kolmogorov, 2e-3, 4e-4,
                              5e-3, res, ndim=1, mesh=tmesh, device="cpu")
        return
    jmesh = jax.make_mesh((8,), ("grid",), axis_types=(AxisType.Auto,))
    _, jfs = jg.grf_domain_fft(jax.random.PRNGKey(5), jg.kolmogorov, 2e-3,
                               4e-4, 5e-3, res, factor=factor, ndim=ndim,
                               mesh=jmesh)
    sc, sf = tg.grf_domain_fft(tr.PRNGKey(5), tg.kolmogorov, 2e-3, 4e-4,
                               5e-3, res, factor=factor, ndim=ndim,
                               mesh=tmesh, device="cpu")
    assert isinstance(sf, Sharded) and sf.spec[0] == "grid"
    assert [b.shape[0] for b in sf.shards] == [tf.shape[0] // 8] * 8
    whole = sf.gather()
    _close(tf, whole)
    _close(jfs, whole)
    for a, b in zip(tc, sc):
        assert torch.equal(a, b)


def test_grf_cos_match_jax():
    jk, tk = jax.random.PRNGKey(3), tr.PRNGKey(3)
    _close(jg.grf_cos_1d(jk, jg.kolmogorov, 1e-2, 64, 50, 100.0)[1],
           tg.grf_cos_1d(tk, tg.kolmogorov, 1e-2, 64, 50, 100.0,
                         device="cpu")[1])
    _close(jg.grf_cos_2d(jk, jg.kolmogorov, 1e-2, 1e-2, 24, 20, 40,
                         100.0)[1],
           tg.grf_cos_2d(tk, tg.kolmogorov, 1e-2, 1e-2, 24, 20, 40, 100.0,
                         device="cpu")[1])
    jc, jf = jg.grf_cos_3d(jk, jg.kolmogorov, 1e-2, 1e-2, 1e-2, 12, 10, 8,
                           30, 100.0)
    tc, tf = tg.grf_cos_3d(tk, tg.kolmogorov, 1e-2, 1e-2, 1e-2, 12, 10, 8,
                           30, 100.0, device="cpu")
    _close(jf, tf)
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


def test_grf_vector_solenoidal_matches_jax():
    _, jb = jg.grf_vector_solenoidal(jax.random.PRNGKey(2), jg.kolmogorov,
                                     2e-3, 4e-4, 5e-3, 8, rms=3.0)
    tc, tb = tg.grf_vector_solenoidal(tr.PRNGKey(2), tg.kolmogorov, 2e-3,
                                      4e-4, 5e-3, 8, rms=3.0, device="cpu")
    _close(jb, tb)
    assert tb.shape == (16, 16, 16, 3) and len(tc) == 3
    rms = float(torch.sqrt(torch.mean(torch.sum(tb**2, dim=-1))))
    assert rms == pytest.approx(3.0, rel=1e-5)


@pytest.mark.parametrize("cls,call", [
    ("gaussian1D", lambda g: g.domain_fft(2e-3, 4e-4, 5e-3, 16)),
    ("gaussian2D", lambda g: g.cos(1e-2, 1e-2, 16, 12, 30, 100.0)),
    ("gaussian3D", lambda g: g.domain_fft(2e-3, 4e-4, 5e-3, 8)),
    ("gaussian3D", lambda g: g.fft(6))])
def test_classes_advance_their_key_as_jax(cls, call):
    jgen = getattr(jg, cls)(jg.kolmogorov, seed=4)
    tgen = getattr(tg, cls)(tg.kolmogorov, seed=4, device="cpu")
    for _ in range(2):
        _close(call(jgen), call(tgen))
        np.testing.assert_array_equal(tgen.key.numpy(),
                                      np.asarray(jgen.key))


def test_slope_recovery():
    """A fresh band-limited field shows its imposed power-law slope, as
    tests/test_fields.py checks the JAX package's."""
    p = 11.0 / 3.0
    extent, res = 1e-3, 64
    _, field = tg.grf_domain_fft(tr.PRNGKey(7), tg.power_law(p),
                                 l_max=extent, l_min=extent / 16,
                                 extent=extent, res=res, device="cpu")
    k, E, cnt = ts.radial_spectrum(field, 2 * extent, nbins=48,
                                   log_bins=True)
    slope = ts.fit_spectral_slope(k, E, cnt, 2 * np.pi / extent * 1.5,
                                  2 * np.pi / (extent / 16) * 0.7)
    assert slope == pytest.approx(-p, abs=0.45)


@pytest.fixture(scope="module")
def field():
    _, f = jg.grf_domain_fft(jax.random.PRNGKey(1), jg.power_law(11 / 3),
                             2e-3, 2e-4, 5e-3, 24)
    return np.array(f)


@pytest.mark.parametrize("kw", [{}, {"nbins": 20}], ids=["shells",
                                                         "linear"])
def test_radial_spectrum_matches_jax(field, kw):
    jk, jE, jc = js.radial_spectrum(jnp.asarray(field), 1e-2, **kw)
    tk, tE, tc = ts.radial_spectrum(torch.from_numpy(field), 1e-2, **kw)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6)
    np.testing.assert_allclose(tE.numpy(), np.asarray(jE), rtol=1e-5,
                               atol=1e-5 * float(np.asarray(jE).max()))


def test_log_shells_and_slope_match_jax(field):
    jk, jE, jc = js.radial_spectrum(jnp.asarray(field), 1e-2, nbins=24,
                                    log_bins=True)
    tk, tE, tc = ts.radial_spectrum(torch.from_numpy(field), 1e-2,
                                    nbins=24, log_bins=True)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5)
    assert abs(float(tc.sum()) - float(np.asarray(jc).sum())) <= 2
    lo, hi = 2 * np.pi / 2e-3 * 1.5, 2 * np.pi / 2e-4 * 0.7
    assert ts.fit_spectral_slope(tk, tE, tc, lo, hi) == pytest.approx(
        js.fit_spectral_slope(jk, jE, jc, lo, hi), abs=1e-3)
    # the fit itself, on the same arrays, is the JAX package's
    assert ts.fit_spectral_slope(jk, jE, jc, lo, hi) == js.fit_spectral_slope(
        jk, jE, jc, lo, hi)


def test_moving_average_matches_jax():
    a = np.random.default_rng(0).standard_normal(20).astype(np.float32)
    for n in (1, 3, 5):
        np.testing.assert_allclose(
            ts.moving_average(torch.from_numpy(a), n).numpy(),
            np.asarray(js.moving_average(jnp.asarray(a), n)), rtol=1e-6,
            atol=1e-6)
