"""The port's analysis (``analysis.fringes``, ``analysis.abel``) against the
JAX package, following tests/test_analysis_loop.py and tests/test_abel.py.

Tolerances. The fringe functions run numpy on the host on both sides, so
given the same image they are equal bit for bit (tensors on any device are
taken as input). The Abel pair is float32 linear algebra: the chord
matrix is elementwise (a few ulps of its largest radius), a projection is
a matrix product summed in another order (1e-5 relative), and the
inverses are triangular / dense solves of a matrix with condition
~1e2-1e4 (2e-4 relative; the JAX package holds its own round trip to
2e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.analysis import abel as jabel
from synthpy_tpu.analysis import fringes as jfr
from synthpy_tpu_torch.analysis import abel as tabel
from synthpy_tpu_torch.analysis import fringes as tfr

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

LWL = 1064e-9


def _fringes(ny=48, nx=64, phi0=-6.0, seed=0):
    """(shot, background) fringe images of a Gaussian phase object on a
    tilted carrier, float32, with a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:ny, 0:nx].astype(np.float64)
    carrier = 2 * np.pi * (0.21 * x + 0.07 * y)
    phi = phi0 * np.exp(-((x - nx / 2) ** 2 + (y - ny / 2) ** 2) / 120.0)
    shot = (1.0 + 0.8 * np.cos(carrier + phi)
            + 0.02 * rng.normal(size=x.shape))
    bkg = 1.0 + 0.8 * np.cos(carrier)
    return shot.astype(np.float32), bkg.astype(np.float32)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["array",
                                                          "tensor"])
def test_fringe_phase_matches_jax(as_tensor):
    shot, bkg = _fringes()
    wrap = torch.from_numpy if as_tensor else (lambda a: a)
    assert tfr.carrier_frequency(wrap(bkg)) == jfr.carrier_frequency(
        jnp.asarray(bkg))
    p_t, a_t = tfr.extract_phase(wrap(shot), return_amplitude=True)
    p_j, a_j = jfr.extract_phase(jnp.asarray(shot), return_amplitude=True)
    np.testing.assert_array_equal(p_t, p_j)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(
        tfr.extract_phase(wrap(shot), carrier=(3, 13), filter_radius=0.3),
        jfr.extract_phase(jnp.asarray(shot), carrier=(3, 13),
                          filter_radius=0.3))
    d_t, v_t = tfr.phase_difference(wrap(shot), wrap(bkg),
                                    return_visibility=True)
    d_j, v_j = jfr.phase_difference(jnp.asarray(shot), jnp.asarray(bkg),
                                    return_visibility=True)
    assert isinstance(d_t, np.ndarray)
    np.testing.assert_array_equal(d_t, d_j)
    np.testing.assert_array_equal(v_t, v_j)


@pytest.mark.parametrize("anchor", [None, (24, 32), (0, 5)])
def test_unwrap_and_rectify_match_jax(anchor):
    shot, bkg = _fringes(phi0=-14.0)
    d = jfr.phase_difference(shot, bkg)
    want = jfr.unwrap_2d(d, anchor=anchor)
    got = tfr.unwrap_2d(torch.from_numpy(d), anchor=anchor)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfr.unwrap_1d(torch.from_numpy(d), 0),
                                  jfr.unwrap_1d(d, 0))
    mask = np.zeros(d.shape, bool)
    mask[:4] = True
    np.testing.assert_array_equal(
        tfr.rectify_phase_offset(torch.from_numpy(want),
                                 torch.from_numpy(mask)),
        jfr.rectify_phase_offset(want, mask))


def test_chord_matrix_and_projection_match_jax():
    L_t = tabel.chord_matrix(40, 0.3, device="cpu").numpy()
    L_j = np.asarray(jabel.chord_matrix(40, 0.3))
    # a chord is 2 (sqrt(a) - sqrt(b)) of radii up to n dr = 12, which XLA
    # computes with contracted r^2 - y^2: a few ulps of 12, doubled
    np.testing.assert_allclose(L_t, L_j, rtol=0,
                               atol=8 * np.spacing(np.float32(12.0)))
    assert np.allclose(L_t, np.triu(L_t))
    rng = np.random.default_rng(3)
    f = rng.uniform(0.5, 2.0, (5, 40)).astype(np.float32)
    F_t = tabel.abel_forward(torch.from_numpy(f), dr=0.3)
    F_j = np.asarray(jabel.abel_forward(f, dr=0.3))
    np.testing.assert_allclose(F_t.numpy(), F_j, rtol=1e-5)
    np.testing.assert_allclose(
        tabel.abel_forward(f, dr=0.3, device="cpu").numpy(), F_j,
        rtol=1e-5)


@pytest.mark.parametrize("reg", [0.0, 1e-3, 1e-1])
def test_abel_invert_matches_jax(reg):
    rng = np.random.default_rng(4)
    r = (np.arange(40) + 0.5) * 0.3
    f = (np.exp(-(r / 4.0) ** 2)[None] * rng.uniform(0.8, 1.2, (3, 1))
         ).astype(np.float32)
    F = np.asarray(jabel.abel_forward(f, dr=0.3))
    F = F + (1e-3 * rng.normal(size=F.shape)).astype(np.float32)
    want = np.asarray(jabel.abel_invert(F, 0.3, reg=reg))
    got = tabel.abel_invert(torch.from_numpy(F), 0.3, reg=reg).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 40)
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=2e-4 * np.abs(want).max())


def test_phase_maps_to_density_as_jax():
    """phase_to_line_density and invert_phase_map on the same phase map
    (a projected Gaussian column, physical sign), and the JAX test's
    recovery of the column's peak density."""
    n0, w, dr = 2e24, 2e-3, 1e-4
    y = (np.arange(-40, 40) + 0.5) * dr
    omega = 2 * np.pi * 2.99792458e8 / LWL
    n_c = 3.14207787e-4 * omega**2
    phase = -(omega / (2 * n_c * 2.99792458e8)) * np.sqrt(np.pi) * w * n0 \
        * np.exp(-(y / w) ** 2)
    pmap = np.tile(phase, (6, 1)).astype(np.float32)
    np.testing.assert_allclose(
        tabel.phase_to_line_density(torch.from_numpy(pmap), LWL).numpy(),
        np.asarray(jabel.phase_to_line_density(pmap, LWL)), rtol=1e-6)
    for axis_index, reg in ((None, 0.0), (40, 1e-3)):
        want = np.asarray(jabel.invert_phase_map(pmap, dr, LWL,
                                                 axis_index=axis_index,
                                                 reg=reg))
        got = tabel.invert_phase_map(torch.from_numpy(pmap), dr, LWL,
                                     axis_index=axis_index, reg=reg).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=2e-4 * np.abs(want).max())
    assert abs(got[0, 0] / n0 - 1.0) < 0.05


def test_analysis_loop_on_a_synthetic_interferogram():
    """Fringes -> wrapped phase -> anchored unwrap -> offset -> Abel, port
    against JAX on the same images (tests/test_analysis_loop.py's chain at
    64 x 48 pixels)."""
    shot, bkg = _fringes(phi0=-9.0, seed=2)
    out = []
    for fr, ab, wrap in ((tfr, tabel, torch.from_numpy), (jfr, jabel,
                                                         jnp.asarray)):
        d = fr.phase_difference(wrap(shot), wrap(bkg))
        uw = fr.unwrap_2d(d, anchor=(24, 32))
        ring = np.zeros(uw.shape, bool)
        ring[:3] = ring[-3:] = True
        uw = fr.rectify_phase_offset(uw, ring)
        rows = np.ascontiguousarray(uw.T[28:36], np.float32)
        out.append(np.asarray(ab.invert_phase_map(wrap(rows), 1e-4, LWL,
                                                  axis_index=24)))
    np.testing.assert_allclose(out[0], out[1], rtol=2e-4,
                               atol=2e-4 * np.abs(out[1]).max())
    assert np.abs(out[1]).max() > 0
