"""The port's FFT wrappers (``ops.dft``) and Fresnel propagation
(``ops.fresnel``) against the JAX package.

Tolerances. Windows and pads are elementwise float32 and held to 1e-6
(last-place cos differences). Transformed fields go through pocketfft here
and XLA's FFT in JAX, which round differently: they are held to 2e-5 of
the field's largest |value| (a 2-D FFT pair of a few thousand points adds
~1e-6 relative per pass); the phases the JAX package rounds to float32
(the transfer function's, the ~1e6 rad carrier's) are rounded at the same
places, so the complex field ``U`` itself is compared, not only |U|^2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from synthpy_tpu.ops import dft as jdft
from synthpy_tpu.ops import fresnel as jfresnel
from synthpy_tpu_torch.ops import dft as tdft
from synthpy_tpu_torch.ops import fresnel as tfresnel

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)


def _field(nx=24, ny=20, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(nx, ny))
            + 1j * rng.normal(size=(nx, ny))).astype(np.complex64)


def _close_rel(got, want, tol=2e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("alpha", [0.0, 0.4, 0.5, 1.0, 1.5])
@pytest.mark.parametrize("M", [1 + 1, 7, 64])
def test_tukey_matches_jax_and_scipy(M, alpha):
    got = tfresnel.tukey(M, alpha).numpy()
    np.testing.assert_allclose(got, np.asarray(jfresnel.tukey(M, alpha)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, scipy.signal.windows.tukey(M, alpha),
                               rtol=0, atol=2e-6)


@pytest.mark.parametrize("pad_factor", [1, 2, 3])
def test_reflect_padding_wider_than_the_array(pad_factor):
    """Pads of pad_factor * n a side repeat the reflection with period
    2 (n - 1), as jnp.pad(mode="reflect") does (torch's pad refuses)."""
    for n in (2, 3, 5, 8):
        a = np.arange(n)
        want = np.asarray(jnp.pad(jnp.asarray(a), n * pad_factor,
                                  mode="reflect"))
        idx = tfresnel.reflect_index(n, n * pad_factor, n * pad_factor)
        np.testing.assert_array_equal(a[idx.numpy()], want)
    U0 = _field()
    got = tfresnel.prepare_field_for_propagation(torch.from_numpy(U0),
                                                 pad_factor=pad_factor)
    want = jfresnel.prepare_field_for_propagation(jnp.asarray(U0),
                                                  pad_factor=pad_factor)
    assert got.shape == (24 * (1 + 2 * pad_factor), 20 * (1 + 2 * pad_factor))
    _close_rel(got, want, 1e-6)


def test_dft_matches_jax():
    U = _field()
    t = torch.from_numpy(U)
    _close_rel(tdft.fft2(t), jdft.fft2(jnp.asarray(U)))
    _close_rel(tdft.ifft2(t), jdft.ifft2(jnp.asarray(U)))
    _close_rel(tdft.fftn(t, axes=(0,)), jdft.fftn(jnp.asarray(U), axes=(0,)))
    _close_rel(tdft.ifftn(t), jdft.ifftn(jnp.asarray(U)))
    r = np.random.default_rng(1).normal(size=(8, 6)).astype(np.float32)
    _close_rel(tdft.fft2(torch.from_numpy(r)), jdft.fft2(jnp.asarray(r)))


@pytest.mark.parametrize("n", [7, 8, 33, 512])
def test_fftfreq_matches_jax(n):
    """Host float64 rounded to float32 for a Python spacing; float32
    arithmetic for a float32 coordinate step (multislice's)."""
    np.testing.assert_array_equal(tdft.fftfreq(n, d=1.3e-5).numpy(),
                                  np.asarray(jdft.fftfreq(n, d=1.3e-5)))
    c = jnp.linspace(-5e-3, 5e-3, 33)
    want = np.asarray(jdft.fftfreq(n, d=c[1] - c[0]))
    tc = torch.linspace(-5e-3, 5e-3, 33)
    assert float(tc[1] - tc[0]) == float(c[1] - c[0])
    np.testing.assert_array_equal(tdft.fftfreq(n, d=tc[1] - tc[0]).numpy(),
                                  want)


@pytest.mark.parametrize("lanex", [None, 5e-5], ids=["no_psf", "lanex"])
@pytest.mark.parametrize("pad_factor", [1, 2])
def test_fresnel_propagate_matches_jax(lanex, pad_factor):
    U0 = _field()
    L, lwl, z = (6e-3, 5e-3), 1064e-9, 0.3
    want = jfresnel.fresnel_propagate(
        jfresnel.prepare_field_for_propagation(jnp.asarray(U0),
                                               pad_factor=pad_factor),
        L, lwl, z, U0.shape, pad_factor=pad_factor, lanex_fwhm_m=lanex)
    got = tfresnel.fresnel_propagate(
        tfresnel.prepare_field_for_propagation(torch.from_numpy(U0),
                                               pad_factor=pad_factor),
        L, lwl, z, U0.shape, pad_factor=pad_factor, lanex_fwhm_m=lanex)
    _close_rel(got, want)


def test_carrier_rounds_as_jax():
    """exp(i (2 pi / lambda) z) with its ~1.8e6 rad argument rounded to
    float32 first: the port's phasor equals JAX's complex64 value."""
    for lwl, z in ((1064e-9, 0.3), (532e-9, 0.05), (1064e-9, 1e-2)):
        phi = (2 * np.pi / lwl) * z
        want = complex(np.asarray(jnp.exp(1j * phi)))
        assert tfresnel.unit_phasor(phi) == want


def _ray_case(n=4000, seed=3):
    rng = np.random.default_rng(seed)
    rays = np.zeros((4, n), np.float32)
    rays[0] = rng.uniform(-2.5, 2.5, n)
    rays[2] = rng.uniform(-2.5, 2.5, n)
    amp = rng.uniform(0.5, 1.0, n).astype(np.float32)
    phase = (rays[0] ** 2 + 0.5 * rays[2]).astype(np.float32)
    grid = np.linspace(-3.0, 3.0, 32, dtype=np.float32)
    return rays, amp, phase, grid


def test_propagate_matches_jax():
    """Deposit (one pass for amplitude and phase) and Fresnel propagation of
    a ray bundle, as Refractometry.fresnel_solve runs it."""
    rays, amp, phase, grid = _ray_case()
    want = jfresnel.propagate(1064e-9, jnp.asarray(grid), jnp.asarray(grid),
                              6e-3, 6e-3, jnp.asarray(rays),
                              jnp.asarray(amp), jnp.asarray(phase), 0.3)
    got = tfresnel.propagate(1064e-9, torch.from_numpy(grid),
                             torch.from_numpy(grid), 6e-3, 6e-3,
                             torch.from_numpy(rays), torch.from_numpy(amp),
                             torch.from_numpy(phase), 0.3)
    assert got.shape == (32, 32)
    _close_rel(got, want)


def test_fresnel_number():
    assert tfresnel.fresnel_number(6e-3, 1064e-9, 0.3) == \
        jfresnel.fresnel_number(6e-3, 1064e-9, 0.3)
