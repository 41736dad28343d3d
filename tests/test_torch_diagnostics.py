"""The port's diagnostic classes (``optics.diagnostics``) and
``pipeline.DIAGNOSTICS`` against the JAX package's, on the same exit rays.

Tolerances. The incoherent element chains are eager float32 ``rtm``
primitives; JAX's ``L @ r`` on the CPU rounds its 4x4 products otherwise
than the port's written-out multiply-add chains (contracted, ~1 ulp of the
largest term), so rays after every solve are held to 4e-6 of each row's
largest |value| (observed 1.7e-6 after the seven elements of the
two-lens telescope: a few ulps an element), the rays killed
must match, and ray-count images may differ by a ray that crosses a bin
edge: at most 4 rays moved.
The coherent benches accumulate ~1e3-1e4 rad of phase, which float32
reorderings move by ~1e-3 rad: they are held to JAX in float64 (fields
to 1e-9 of the largest, images to 1e-9 of their peak), and their float32
images by relative L1 <= 3% (tests/test_torch_coherent.py: JAX's own
float32 interferogram lies ~2% from its float64 one). The Fresnel
hybrid is float32 FFT work: its intensity and resampled image are held to
1e-4 of their peak (pocketfft against XLA's FFT). Weighted (polarogram)
images to 1e-5 relative: per-ray weights differ by the last place of
sin/cos.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import pipeline as jpipe
from synthpy_tpu.optics import diagnostics as jdiag
from synthpy_tpu_torch import pipeline as tpipe
from synthpy_tpu_torch.optics import diagnostics as tdiag

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

LWL = 1064e-9
BIN = dict(bin_scale=32)     # 107 x 80 pixels


def _rays(n=5000, seed=0, dtype=np.float32):
    """(4, N) exit rays [m, rad] with some outside the apertures and stops,
    and (2, N) Jones vectors amp e^(i phase) R(pol) y-hat."""
    rng = np.random.default_rng(seed)
    rf = np.empty((4, n))
    rf[0] = rng.uniform(-4e-3, 4e-3, n)
    rf[2] = rng.uniform(-4e-3, 4e-3, n)
    # most rays deflected by mrad, a fifth by up to ~0.1 rad (killed by the
    # lens apertures)
    wide = np.where(rng.uniform(size=n) < 0.2, 0.05, 3e-3)
    rf[1] = rng.normal(0, 1, n) * wide + 0.2 * rf[0]
    rf[3] = rng.normal(0, 1, n) * wide - 0.1 * rf[2]
    amp = rng.uniform(0.5, 1.0, n)
    phase = rng.uniform(-50.0, 50.0, n)
    pol = rng.normal(0, 0.3, n)
    e = amp * np.exp(1j * phase)
    J = np.stack([-np.sin(pol) * e, np.cos(pol) * e])
    ctype = np.complex64 if dtype == np.float32 else np.complex128
    return rf.astype(dtype), J.astype(ctype)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _pair(cls, rf, J=None, **kw):
    """The same bench in JAX and in the port (CPU tensors)."""
    j = getattr(jdiag, cls)(LWL, jnp.asarray(rf),
                            None if J is None else jnp.asarray(J), **kw)
    tkw = {k: (torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
               else v) for k, v in kw.items()}
    t = getattr(tdiag, cls)(LWL, torch.from_numpy(rf),
                            None if J is None else torch.from_numpy(J), **tkw)
    return j, t


INCOHERENT = [("Shadowgraphy", "single_lens_solve", {}),
              ("Shadowgraphy", "two_lens_solve", {}),
              ("Shadowgraphy", "single_exp_solve", {"detL": 300}),
              ("Shadowgraphy", "solve", {}),
              ("Polarimetry", "two_lens_solve", {}),
              ("Schlieren", "DF_solve", {}),
              ("Schlieren", "DF_solve", {"R": 2.5}),
              ("Schlieren", "LF_solve", {}),
              ("Refractometry", "incoherent_solve", {})]


@pytest.mark.parametrize("focal_plane", [0.0, 12.5])
@pytest.mark.parametrize("cls,solve,kw", INCOHERENT,
                         ids=[f"{c}.{s}{'_' + str(k) if k else ''}"
                              for c, s, k in INCOHERENT])
def test_incoherent_solve_and_histogram_match_jax(cls, solve, kw,
                                                  focal_plane):
    rf, _ = _rays()
    j, t = _pair(cls, rf, focal_plane=focal_plane)
    rj = _np(getattr(j, solve)(**kw))
    rt = _np(getattr(t, solve)(**kw))
    assert 0 < np.isnan(rj[0]).sum() < rj.shape[1]
    np.testing.assert_array_equal(np.isnan(rt), np.isnan(rj))
    scale = np.nanmax(np.abs(rj), axis=1, keepdims=True)
    live = np.isfinite(rj)
    assert (np.abs(rt - rj)[live] <= (4e-6 * scale * live)[live]).all()
    Hj = _np(j.histogram(**BIN))
    Ht = _np(t.histogram(**BIN))
    assert Ht.shape == Hj.shape == (2574 // 32, 3448 // 32)
    assert Ht.sum() == Hj.sum() > 0
    assert np.abs(Ht - Hj).sum() <= 2 * 4
    # linspace rounds its float32 points otherwise than jnp.linspace
    np.testing.assert_allclose(_np(t.xedges), _np(j.xedges), rtol=1e-5)


@pytest.mark.parametrize("beta", [85.0, 90.0, 30.0])
def test_polarogram_matches_jax(beta):
    rf, J = _rays(seed=1)
    j, t = _pair("Polarimetry", rf, J)
    j.solve()
    t.solve()
    Hj = _np(j.polarogram(beta_deg=beta, **BIN))
    Ht = _np(t.polarogram(beta_deg=beta, **BIN))
    assert Ht.dtype == np.float32
    np.testing.assert_allclose(Ht, Hj, rtol=1e-5, atol=1e-5 * Hj.max())
    with pytest.raises(RuntimeError, match="Jones"):
        tdiag.Polarimetry(LWL, torch.from_numpy(rf)).polarogram()


def _coherent(name, j, t, conv, **kw):
    """Run a coherent bench on both sides: (JAX image, port image)."""
    if name == "refractometry":
        j.coherent_solve()
        t.coherent_solve()
        return (_np(j.refractogram(convention=conv, **BIN, **kw)),
                _np(t.refractogram(convention=conv, **BIN, **kw)))
    j.two_lens_solve(n_fringes=6, deg=25)
    t.two_lens_solve(n_fringes=6, deg=25)
    return (_np(j.interferogram(convention=conv, **BIN)),
            _np(t.interferogram(convention=conv, **BIN)))


CLS = {"refractometry": "Refractometry", "interferometry": "Interferometry"}


@pytest.mark.parametrize("conv", ["legacy", "intensity"])
@pytest.mark.parametrize("name", ["refractometry", "interferometry"])
def test_coherent_benches_match_jax_float64(name, conv):
    rf, J = _rays(seed=2, dtype=np.float64)
    with jax.enable_x64(True):
        j, t = _pair(CLS[name], rf, J)
        Hj, Ht = _coherent(name, j, t, conv)
        Jj = _np(j.Jf)
    assert Ht.shape == Hj.shape == (2574 // 32 - 1, 3448 // 32 - 1)
    Jt = _np(t.Jf)
    keep = np.isfinite(Jj)
    np.testing.assert_array_equal(np.isfinite(Jt), keep)
    np.testing.assert_allclose(Jt[keep], Jj[keep], rtol=0,
                               atol=1e-9 * np.abs(Jj[keep]).max())
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-9 * Hj.max())


@pytest.mark.parametrize("name", ["refractometry", "interferometry"])
def test_coherent_benches_match_jax_float32(name):
    rf, J = _rays(seed=3)
    j, t = _pair(CLS[name], rf, J)
    Hj, Ht = _coherent(name, j, t, "intensity")
    assert Ht.dtype == np.float32
    assert np.abs(Ht - Hj).sum() / np.abs(Hj).sum() <= 0.03


def test_interferometry_bkg_and_legacy_wavenumber_match_jax():
    """The legacy convention's phases are 1e3 larger (~1e6 rad), so float64
    libm differences between sides are held to 1e-7 of the peak there."""
    rf, J = _rays(seed=4, dtype=np.float64)
    with jax.enable_x64(True):
        for legacy, tol in ((False, 1e-9), (True, 1e-7)):
            j, t = _pair("Interferometry", rf, J,
                         legacy_mm_wavenumber=legacy)
            bj = _np(j.bkg(n_fringes=8, deg=60, **BIN))
            bt = _np(t.bkg(n_fringes=8, deg=60, **BIN))
            np.testing.assert_allclose(bt, bj, rtol=0, atol=tol * bj.max())
            # bkg restores the shot's field and rays
            np.testing.assert_array_equal(_np(t.Jf), J)
            Hj = _np(j.interferogram(**BIN))
            Ht = _np(t.interferogram(**BIN))
            np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-9 * Hj.max())


def test_refractogram_speckle_feeds_the_ports_draw_to_jax():
    """The port draws the speckle from a torch.Generator; JAX's arithmetic
    on the same draw gives the same refractogram."""
    rf, J = _rays(seed=5, dtype=np.float64)
    sigma = 0.7
    with jax.enable_x64(True):
        j, t = _pair("Refractometry", rf, J)
        j.coherent_solve()
        t.coherent_solve()
        g = torch.randn(J.shape[1], generator=torch.Generator().manual_seed(9),
                        dtype=torch.float64).numpy()
        j.Jf = j.Jf * jnp.exp(1.0j * (sigma * jnp.asarray(g)))
        Hj = _np(j.refractogram(**BIN))
    Ht = _np(t.refractogram(speckle_phase=sigma,
                            key=torch.Generator().manual_seed(9), **BIN))
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-9 * Hj.max())
    # the default key is a generator seeded with 0
    t2 = tdiag.Refractometry(LWL, torch.from_numpy(rf), torch.from_numpy(J))
    t2.coherent_solve()
    t3 = tdiag.Refractometry(LWL, torch.from_numpy(rf), torch.from_numpy(J))
    t3.coherent_solve()
    np.testing.assert_array_equal(
        _np(t2.refractogram(speckle_phase=sigma, **BIN)),
        _np(t3.refractogram(speckle_phase=sigma,
                            key=torch.Generator().manual_seed(0), **BIN)))


def test_refractogram_speckle_from_a_key_is_jaxs():
    """A port key draws the speckle JAX draws from the same key (its
    float32 normals, within a few ulp): the refractogram is JAX's on that
    draw. The chain runs in float64, where JAX's default draw would be
    float64, so JAX's float32 draw is applied by hand."""
    from synthpy_tpu_torch import convert

    rf, J = _rays(seed=5, dtype=np.float64)
    sigma = 0.7
    with jax.enable_x64(True):
        j, t = _pair("Refractometry", rf, J)
        j.coherent_solve()
        t.coherent_solve()
        g = jax.random.normal(jax.random.PRNGKey(9), J.shape[1:],
                              dtype=jnp.float32).astype(jnp.float64)
        j.Jf = j.Jf * jnp.exp(1.0j * (sigma * g))
        Hj = _np(j.refractogram(**BIN))
    Ht = _np(t.refractogram(speckle_phase=sigma,
                            key=convert.key(jax.random.PRNGKey(9)), **BIN))
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-5 * Hj.max())


def _fresnel_case(n=6000, seed=6):
    rng = np.random.default_rng(seed)
    rf = np.zeros((4, n), np.float32)
    rf[0] = rng.uniform(-2.5e-3, 2.5e-3, n)
    rf[2] = rng.uniform(-2.5e-3, 2.5e-3, n)
    amp = rng.uniform(0.5, 1.0, n).astype(np.float32)
    phase = (3e6 * (rf[0] ** 2 + rf[2] ** 2)).astype(np.float32)
    grid = np.linspace(-3.0, 3.0, 48, dtype=np.float32)
    return rf, dict(x=grid, y=grid, x_l=6e-3, y_l=6e-3, amp=amp, phase=phase)


@pytest.mark.parametrize("z", [None, 0.3])
def test_fresnel_solve_and_resample_match_jax(z):
    rf, kw = _fresnel_case()
    j, t = _pair("Refractometry", rf, **kw)
    Hj = _np(j.fresnel_solve(z=z))
    Ht = _np(t.fresnel_solve(z=z))
    assert Ht.shape == Hj.shape == (48, 48)
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-4 * Hj.max())
    Uj, Ut = _np(j.U), _np(t.U)
    np.testing.assert_allclose(Ut, Uj, rtol=0, atol=1e-4 * np.abs(Uj).max())
    Rj = _np(j.resample_to_detector(**BIN))
    Rt = _np(t.resample_to_detector(**BIN))
    assert Rt.shape == Rj.shape == (2574 // 32, 3448 // 32)
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-4 * Rj.max())
    assert (Rj == 0).any() and (Rt[Rj == 0] == 0).all()


def test_fresnel_solve_needs_its_grid():
    rf, _ = _fresnel_case(n=10)
    t = tdiag.Refractometry(LWL, torch.from_numpy(rf))
    with pytest.raises(RuntimeError, match="fresnel_solve needs"):
        t.fresnel_solve()
    with pytest.raises(RuntimeError, match="fresnel_solve first"):
        t.resample_to_detector()


def test_diagnostics_table_matches_jax():
    assert tpipe.DIAGNOSTICS.keys() == jpipe.DIAGNOSTICS.keys()
    for name, (cls, method, coherent) in jpipe.DIAGNOSTICS.items():
        tcls, tmethod, tcoh = tpipe.DIAGNOSTICS[name]
        assert (tcls.__name__, tmethod, tcoh) == (cls.__name__, method,
                                                  coherent)
        assert hasattr(tcls, tmethod)


def test_class_surface():
    """clear_rays, plot, the histogram_legacy alias and the device rule."""
    rf, J = _rays(n=200, seed=7)
    t = tdiag.Shadowgraphy(LWL, torch.from_numpy(rf), torch.from_numpy(J))
    assert t.device.type == "cpu" and t.r0.shape == (4, 200)
    t.solve()
    t.histogram(**BIN)

    class Ax:
        def imshow(self, H, **kw):
            self.H, self.kw = H, kw
            return "img"

    ax = Ax()
    assert t.plot(ax) == "img"
    assert ax.H.shape == (80, 107) and ax.kw["extent"] == [-9.0, 9.0,
                                                          -6.75, 6.75]
    assert tdiag.Diagnostic.histogram_legacy is \
        tdiag.Diagnostic.coherent_histogram
    t.clear_rays()
    assert t.rf is None and t.r0 is None and t.Jf is None
    with pytest.raises(ValueError):
        tdiag.Shadowgraphy(LWL, None)
    with pytest.raises(RuntimeError, match="Jones"):
        tdiag.Shadowgraphy(LWL, torch.from_numpy(rf)).coherent_histogram()
    # an array goes to device= (default cuda: refused on a host without one)
    on_cpu = tdiag.Shadowgraphy(LWL, rf, device="cpu")
    assert on_cpu.r0.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdiag.Shadowgraphy(LWL, rf)
