"""The port's priors (``synthpy_tpu_torch.priors``) against the JAX
package's, on the CPU: the cases of tests/test_priors.py on the port, and
values and gradients against JAX on the same numpy inputs.

Tolerances: tv, haar and white_l2 are float32 sums of the same terms,
within 1e-6 relative (observed ~1e-7); the spectral priors go through two
FFTs of float32 data (pocketfft in both frameworks, possibly in other
orders), within 1e-5 of the field's largest value (observed ~5e-7), and
so are their gradients; the modal prior's mode selection, count and
tau are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import priors as jpriors
from synthpy_tpu_torch.fields.spectrum import (fit_spectral_slope,
                                               radial_spectrum)
from synthpy_tpu_torch.priors import (haar2d, haar_l1, ihaar2d,
                                      make_grf_modal, make_grf_whitener, tv,
                                      white_l2)

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


# -- the cases of tests/test_priors.py --------------------------------------

def test_tv_matches_inline_definition():
    g = torch.from_numpy(_normal(0, (17, 23)))
    inline = (torch.mean(torch.abs(torch.diff(g, dim=0)))
              + torch.mean(torch.abs(torch.diff(g, dim=1))))
    assert np.allclose(float(tv(g)), float(inline), rtol=1e-6)
    assert float(tv(torch.ones((8, 8, 8)))) == 0.0


def test_haar_round_trip_and_parseval():
    g = torch.from_numpy(_normal(1, (32, 64)))
    a, details = haar2d(g, levels=3)
    assert np.allclose(ihaar2d(a, details).numpy(), g.numpy(), atol=1e-5)
    e = float((a ** 2).sum() + sum((x ** 2).sum() for tri in details
                                   for x in tri))
    assert np.allclose(e, float((g ** 2).sum()), rtol=1e-5)


def test_haar_round_trip_3d_slicewise():
    g = torch.from_numpy(_normal(2, (16, 16, 5)))
    a, details = haar2d(g, levels=2)
    assert np.allclose(ihaar2d(a, details).numpy(), g.numpy(), atol=1e-5)


def test_haar_l1_taxes_speckle_not_smooth():
    x = torch.linspace(-1, 1, 64)
    smooth = torch.exp(-(x[:, None] ** 2 + x[None, :] ** 2) / 0.2)
    noisy = smooth + 0.5 * torch.from_numpy(_normal(3, (64, 64)))
    assert float(haar_l1(noisy)) > 2.0 * float(haar_l1(smooth))
    with pytest.raises(ValueError):
        haar2d(torch.zeros((12, 12)), levels=3)


def test_grf_whitener_unit_variance_and_slope():
    n, L = 128, 1.0
    colorize, n_active = make_grf_whitener((n, n), L / n,
                                           lambda k: k ** (-3.0),
                                           device="cpu")
    assert n_active > 0
    g = colorize(torch.from_numpy(_normal(4, (n, n))))
    assert g.shape == (n, n)
    assert 0.5 < float(g.var()) < 2.0
    k, E, c = radial_spectrum(g, L)
    k_fund = 2 * np.pi / L
    slope = fit_spectral_slope(k, E, c, 4 * k_fund, 20 * k_fund)
    assert -3.8 < slope < -2.2, slope


def test_grf_whitener_band_limit_and_map_gradient():
    n, L = 64, 1.0
    colorize, _ = make_grf_whitener((n, n), L / n, lambda k: k ** (-2.0),
                                    l_max=L / 2, l_min=L / 8, device="cpu")
    theta = torch.from_numpy(_normal(5, (n, n)))
    k, E, c = radial_spectrum(colorize(theta), L)
    k, E, c = (np.asarray(v) for v in (k, E, c))
    kin = (k >= 2 * np.pi / (L / 2)) & (k <= 2 * np.pi / (L / 8))
    occupied = c > 0
    assert E[kin & occupied].sum() > 100.0 * max(E[~kin & occupied].sum(),
                                                 1e-30)
    target = colorize(torch.from_numpy(_normal(6, (n, n))))
    th = theta.clone().requires_grad_()
    loss = torch.mean((colorize(th) - target) ** 2) + white_l2(th)
    g, = torch.autograd.grad(loss, th)
    assert bool(torch.isfinite(g).all())
    gp, = torch.autograd.grad(white_l2(th), th)
    assert np.allclose(gp.numpy(), theta.numpy() / theta.numel(), rtol=1e-6)
    with pytest.raises(ValueError):
        make_grf_whitener((n, n), L / n, lambda k: k ** (-2.0),
                          l_max=L / 1000, l_min=L / 2000, device="cpu")


# -- values and gradients against JAX ---------------------------------------

def _grad_both(jfn, tfn, x):
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tv_ = tfn(xt)
    tg, = torch.autograd.grad(tv_, xt)
    return (float(jv), np.asarray(jg)), (float(tv_.detach()), tg.numpy())


@pytest.mark.parametrize("shape", [(16, 24), (16, 16, 5)])
def test_tv_haar_white_match_jax(shape):
    x = _normal(7, shape)
    pairs = [(jpriors.tv, tv), (jpriors.white_l2, white_l2),
             (lambda g: jpriors.haar_l1(g, levels=2),
              lambda g: haar_l1(g, levels=2)),
             (lambda g: jpriors.haar_l1(g, 2, detail_only=False),
              lambda g: haar_l1(g, 2, detail_only=False))]
    for jfn, tfn in pairs:
        (jv, jg), (tv_, tg) = _grad_both(jfn, tfn, x)
        np.testing.assert_allclose(tv_, jv, rtol=1e-6)
        _close(tg, jg, 1e-6)
    ja, jd = jpriors.haar2d(jnp.asarray(x), levels=2)
    ta, td = haar2d(torch.from_numpy(x), levels=2)
    _close(ta, ja, 1e-6)
    for jt, tt in zip(jd, td):
        for a, b in zip(tt, jt):
            _close(a, b, 1e-6)
    _close(ihaar2d(ta, td), jpriors.ihaar2d(ja, jd), 1e-6)


@pytest.mark.parametrize("band", [(None, None), (0.5, 1 / 8)])
def test_grf_whitener_matches_jax(band):
    shape, dx = (32, 24), 1.0 / 32
    kf = lambda k: k ** (-3.0)  # noqa: E731
    jc, jn = jpriors.make_grf_whitener(shape, dx, kf, *band)
    tc, tn = make_grf_whitener(shape, dx, kf, *band, device="cpu")
    assert jn == tn
    theta = _normal(8, shape)
    _close(tc(torch.from_numpy(theta)), jc(jnp.asarray(theta)), 1e-5)
    target = _normal(9, shape)
    (jv, jg), (tv_, tg) = _grad_both(
        lambda t: jnp.sum(jnp.asarray(target) * jc(t)),
        lambda t: torch.sum(torch.from_numpy(target) * tc(t)), theta)
    _close(tg, jg, 1e-5)


def test_grf_modal_matches_jax():
    shape, dx = (24, 24), 1.0 / 24
    kf = lambda k: k ** (-4.0)  # noqa: E731
    js, jn = jpriors.make_grf_modal(shape, dx, kf, l_max=0.9, l_min=0.1)
    ts, tn = make_grf_modal(shape, dx, kf, l_max=0.9, l_min=0.1,
                            device="cpu")
    assert jn == tn and tn > 10
    u = _normal(10, (tn, 2))
    g = ts(torch.from_numpy(u))
    _close(g, js(jnp.asarray(u)), 1e-5)
    assert 0.3 < float((g ** 2).mean()) < 3.0   # ~unit variance
    target = _normal(11, shape)
    (jv, jg), (tv_, tg) = _grad_both(
        lambda t: jnp.sum(jnp.asarray(target) * js(t)),
        lambda t: torch.sum(torch.from_numpy(target) * ts(t)), u)
    _close(tg, jg, 1e-5)
    with pytest.raises(ValueError):
        make_grf_modal(shape, dx, kf, l_max=1e-3, l_min=5e-4, device="cpu")
