"""Port detector chain (kernel K3's plain version) vs the JAX package:
histogram2d, apply_stages on every bench, ray_to_Jonesvector and the fused
exit-state -> image path.

Counts are exact (binning follows numpy's rules in float32 on both
sides). Ray transfer is held to 1e-5 of each row's largest value with the
same NaN pattern: the JAX package sums each 4x4 product in XLA's dot
order, the port in explicit multiply-add chains, and an imaging bench
cancels terms (up to ~800 mm x 0.02 rad) several times larger than the
result, so the two differ by a few ulps of those terms (observed 4.4e-6
mm on rows of 4 mm), not of the result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import pipeline as jpipe
from synthpy_tpu.ops.histogram import histogram2d as jhist
from synthpy_tpu.optics import compose as jcomp
from synthpy_tpu.optics.rtm import m_to_mm as jm_to_mm
from synthpy_tpu.tracer.beam import init_beam
from synthpy_tpu.tracer.propagator import ray_to_Jonesvector as jray
from synthpy_tpu.tracer.zscan import reassemble_state as jreassemble
from synthpy_tpu_torch.kernels import detector
from synthpy_tpu_torch.ops.histogram import histogram2d
from synthpy_tpu_torch.optics import compose as tcomp
from synthpy_tpu_torch.optics import rtm
from synthpy_tpu_torch.tracer.propagator import ray_to_Jonesvector
from synthpy_tpu_torch.tracer.zscan import reassemble_state

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
RANGE = ((-9.0, 9.0), (-6.75, 6.75))


def _edge_values(rng, n, lo, hi):
    v = rng.uniform(lo - 1.0, hi + 1.0, n).astype(np.float32)
    v[:6] = (np.nan, hi, lo, np.inf, -np.inf, np.nextafter(np.float32(hi),
                                                          np.float32(0)))
    return v


@pytest.mark.parametrize("weighted", [False, True])
def test_histogram2d_matches_jax(weighted):
    rng = np.random.default_rng(11)
    x = _edge_values(rng, 5000, *RANGE[0])
    y = _edge_values(rng, 5000, *RANGE[1])
    y[6:9] = (RANGE[1][1], np.nan, RANGE[1][0])
    w = rng.random(5000).astype(np.float32) if weighted else None
    want = np.asarray(jhist(jnp.asarray(x), jnp.asarray(y), (54, 40), RANGE,
                            None if w is None else jnp.asarray(w))[0])
    got, xe, ye = histogram2d(torch.from_numpy(x), torch.from_numpy(y),
                              (54, 40), RANGE,
                              None if w is None else torch.from_numpy(w))
    assert got.shape == (40, 54) and xe.shape == (55,) and ye.shape == (41,)
    if weighted:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[-1, :].sum() > 0 and got[:, -1].sum() > 0


@pytest.fixture(scope="module")
def exit_rays():
    """A (9, N) exit-like state (rays spread and tilted) and its (N, 8)."""
    s0 = np.array(init_beam(jax.random.PRNGKey(2), 6000, 4e-3, 8e-3, EXT,
                            "circular"))
    s0[2] = EXT * 1.02
    return s0


def _rays_only(stages):
    return [s for s in stages if s[0] not in ("phase", "mark")]


@pytest.mark.parametrize("bench", sorted(jcomp.BENCHES))
def test_apply_stages_matches_jax(exit_rays, bench):
    rf, _ = jray(jnp.asarray(exit_rays), EXT)
    r = jm_to_mm(rf)
    jst = _rays_only(jcomp.BENCHES[bench][0]())
    tst = _rays_only(tcomp.BENCHES[bench][0]())
    assert len(jst) == len(tst)
    for a, b in zip(jst, tst):
        assert a[0] == b[0]
        np.testing.assert_array_equal(np.asarray(a[1:], dtype=object).shape,
                                      np.asarray(b[1:], dtype=object).shape)
    want = np.asarray(jcomp.apply_stages(r, jst))
    got = tcomp.apply_stages(torch.from_numpy(np.array(r)), tst).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want).any() == (bench.startswith("schlieren"))
    for row in range(4):
        scale = np.nanmax(np.abs(want[row]))
        np.testing.assert_allclose(got[row], want[row], rtol=0,
                                   atol=1e-5 * scale)


RTM_CASES = {
    "lens": (lambda m, r: m.lens(r, 150.0, 220.0)),
    "travel": (lambda m, r: m.travel(r, 333.0)),
    "aperture": (lambda m, r: m.circular_aperture(r, 2.0)),
    "stop": (lambda m, r: m.circular_stop(r, 1.5)),
    "annular": (lambda m, r: m.annular_stop(r, 1.0, 2.5)),
    "rect": (lambda m, r: m.rect_aperture(r, 1.5, 1.0)),
    "rect_exact": (lambda m, r: m.rect_aperture(r, 1.5, 1.0, exact=True)),
    "knife_x": (lambda m, r: m.knife_edge(r, 0.3, "x", 1)),
    "knife_y": (lambda m, r: m.knife_edge(r, -0.2, "y", -1)),
}


@pytest.mark.parametrize("case", sorted(RTM_CASES))
def test_rtm_primitives_match_jax(exit_rays, case):
    from synthpy_tpu.optics import rtm as jrtm
    rf, _ = jray(jnp.asarray(exit_rays), EXT)
    r = jm_to_mm(rf)
    want = np.asarray(RTM_CASES[case](jrtm, r))
    got = RTM_CASES[case](rtm, torch.from_numpy(np.array(r))).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert 0 < np.isnan(want[0]).sum() < want.shape[1] or case in (
        "lens", "travel")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_coherent_stages_raise():
    """The ("phase",) checkpoints need a field and a wavelength, and the
    incoherent detector refuses them."""
    r = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="needs E and wavelength"):
        tcomp.apply_stages(r, tcomp.interferometry_two_lens())
    with pytest.raises(ValueError, match="detect_field"):
        detector.stage_table(tcomp.refractometer_coherent())


@pytest.mark.parametrize("direction", ["x", "y", "z"])
def test_ray_to_jonesvector_matches_jax(exit_rays, direction):
    s = exit_rays.copy()
    # move the state to the given probing axis (p first, then a, b)
    order = {"x": (2, 0, 1), "y": (0, 2, 1), "z": (0, 1, 2)}[direction]
    s[0:3] = exit_rays[list(order)]
    s[3:6] = exit_rays[[3 + o for o in order]]
    s[6] = 0.9
    s[7] = np.linspace(0, 30, s.shape[1])
    s[8] = np.linspace(-1, 1, s.shape[1])
    rf_j, J_j = jray(jnp.asarray(s), EXT, probing_direction=direction,
                     return_E=True)
    rf_t, J_t = ray_to_Jonesvector(torch.from_numpy(s), EXT,
                                   probing_direction=direction,
                                   return_E=True)
    np.testing.assert_allclose(rf_t.numpy(), np.asarray(rf_j), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("direction", ["x", "y", "z"])
def test_reassemble_state_matches_jax(exit_rays, direction):
    uf = np.ascontiguousarray(exit_rays[[0, 1, 3, 4, 5, 6, 7, 8]].T)
    want = np.asarray(jreassemble(jnp.asarray(uf), EXT, direction))
    got = reassemble_state(torch.from_numpy(uf), EXT, direction).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bench", ["shadowgraphy", "schlieren_df",
                                   "schlieren_lf", "refractometry",
                                   "polarimetry"])
def test_fused_detector_matches_jax_image(exit_rays, bench):
    """detect_plain (the chain the kernel fuses) vs JAX _image_from_sf."""
    s = exit_rays.copy()
    s[8] = np.linspace(-1, 1, s.shape[1])
    uf = np.ascontiguousarray(s[[0, 1, 3, 4, 5, 6, 7, 8]].T)
    p_end = float(s[2, 0])
    sf = jreassemble(jnp.asarray(uf), p_end, "z")
    want = np.asarray(jpipe._image_from_sf(
        sf, jnp.asarray(EXT, jnp.float32), diagnostic=bench,
        probing_direction="z", bins=(54, 40), lwl=1064e-9, L=400.0, R=25.0,
        Lx=18.0, Ly=13.5, focal_plane=0.0))
    from synthpy_tpu_torch.pipeline import _image_from_uf
    got = _image_from_uf(torch.from_numpy(uf), p_end, EXT, diagnostic=bench,
                         probing_direction="z", bins=(54, 40), L=400.0,
                         R=25.0, Lx=18.0, Ly=13.5, focal_plane=0.0).numpy()
    if bench == "polarimetry":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert got.sum() == want.sum() > 0
        assert np.abs(got - want).sum() <= 2


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("perm", ["shuffled", "sorted"])
def test_detect_in_any_order_matches_caller_order(exit_rays, perm,
                                                   weighted):
    """The image does not depend on the order of the rays: counts are
    equal, weighted sums equal to float rounding."""
    uf = torch.from_numpy(np.ascontiguousarray(
        exit_rays[[0, 1, 3, 4, 5, 6, 7, 8]].T))
    n = uf.shape[0]
    rng = np.random.default_rng(4)
    order = torch.from_numpy(
        rng.permutation(n) if perm == "shuffled"
        else np.argsort(np.round(exit_rays[0] * 1e3), kind="stable"))
    w = (torch.from_numpy(rng.random(n).astype(np.float32)) if weighted
         else None)
    args = (EXT * 1.02, EXT, "z", tcomp.shadowgraphy_two_lens(), (54, 40),
            RANGE)
    want = detector.detect(uf, *args, weights=w)
    got = detector.detect(uf[order].contiguous(), *args,
                          weights=None if w is None else w[order])
    assert float(want.sum()) > 0
    if weighted:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    else:
        assert torch.equal(got, want)


def test_stage_table_layout():
    st = [("matrix", np.arange(16.0).reshape(4, 4)), ("aperture", 3.0),
          ("stop", 0.5), ("rect", 2.0, 4.0), ("knife", 0.25, "x", -1)]
    t = detector.stage_table(st)
    assert t.shape == (5, 17) and t.dtype == np.float32
    np.testing.assert_array_equal(t[:, 0], [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(t[0, 1:], np.arange(16.0))
    np.testing.assert_array_equal(t[1:4, 1:3], [[9, 0], [0.25, 0], [4, 16]])
    np.testing.assert_array_equal(t[4, 1:4], [0, -1, 0.25])
    r = torch.tensor([[0.3, 0.1, -1.0], [0, 0, 0], [0.0, 0.0, 0.0],
                      [0, 0, 0]], dtype=torch.float32)
    out = rtm.knife_edge(r, 0.25, "x", -1)
    assert torch.isnan(out[:, 1:]).all() and not torch.isnan(out[:, 0]).any()
