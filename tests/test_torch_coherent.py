"""The port's coherent benches (interferometry, coherent refractometry):
the stage math, the coherent detector (kernel K3's field form, plain
version) and ``pipeline.run`` / ``run_split`` against the JAX package.

Tolerances. The accumulated optical phase is ~1e4 rad, so in float32 any
reordering moves a ray's phase by 0.01-0.1 rad (tests/test_compose_legacy:
137-193): the stage math and the detector chain are held to JAX in float64
(rays to 1e-12, fields to 1e-7, images to 1e-9 of their peak), which the
plain versions take. Float32 images of whole runs are held by their
relative L1 distance, <= 0.03: on the 33^3 lens the JAX package's own
float32 interferogram lies 1.8% (coherent refractogram 0.9%) from its
float64 one, and the port's from JAX's 1.6% (0.7%). Ray counts (a unit
field through the stages without their phase checkpoints) are exact.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import pipeline as jpipe
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.ops import histogram as jhist
from synthpy_tpu.optics import compose as jcomp
from synthpy_tpu.optics import rtm as jrtm
from synthpy_tpu.tracer import init_beam
from synthpy_tpu.tracer.zscan import reassemble_state as jreassemble
from synthpy_tpu_torch import convert
from synthpy_tpu_torch import pipeline as tpipe
from synthpy_tpu_torch.kernels import detector
from synthpy_tpu_torch.ops import histogram as thist
from synthpy_tpu_torch.optics import compose as tcomp
from synthpy_tpu_torch.optics import rtm as trtm

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
COHERENT = ("interferometry", "refractometry_coherent")


def _rays64(n=400, seed=5, spread=2e-3):
    """(4, N) float64 RTM rays [m, rad] (tests/test_compose_legacy) and
    their (2, N) Jones vectors."""
    rng = np.random.default_rng(seed)
    rf = rng.uniform(-spread, spread, (4, n))
    J = np.stack([rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n),
                  np.ones(n)]).astype(np.complex128)
    return rf, J


def _close_complex(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    for part in (np.real, np.imag):
        np.testing.assert_allclose(part(got), part(want), rtol=tol,
                                   atol=tol, equal_nan=True)


@pytest.mark.parametrize("bench", COHERENT)
def test_apply_stages_coherent_matches_jax_float64(bench):
    rf, J = _rays64(spread=1.5e-2)   # some rays outside the apertures
    r_mm = rf.copy()
    r_mm[0::2] *= 1e3
    stages_t = tcomp.BENCHES[bench][0]()
    with jax.enable_x64(True):
        E0 = jnp.asarray(J)
        if bench == "interferometry":
            E0 = jcomp.interfere_ref_beam(jnp.asarray(r_mm), E0, 10, 20)
        rj, Ej = jcomp.apply_stages(jnp.asarray(r_mm),
                                    jcomp.BENCHES[bench][0](), E=E0,
                                    wavelength=532e-9)
        rj, Ej = np.asarray(rj), np.asarray(Ej)
    E0 = torch.from_numpy(J)
    r0 = torch.from_numpy(r_mm)
    if bench == "interferometry":
        E0 = tcomp.interfere_ref_beam(r0, E0, 10, 20)
    rt, Et = tcomp.apply_stages(r0, stages_t, E=E0, wavelength=532e-9)
    assert 0 < np.isnan(rj[0]).sum() < rj.shape[1]
    np.testing.assert_allclose(rt.numpy(), rj, rtol=1e-12, atol=1e-12,
                               equal_nan=True)
    _close_complex(Et, Ej, 1e-7)
    with pytest.raises(ValueError, match="phase"):
        tcomp.apply_stages(r0, stages_t)


@pytest.mark.parametrize("deg", [20.0, 60.0])
def test_interfere_ref_beam_and_aperture_match_jax(deg):
    rf, J = _rays64(seed=8, spread=4e-3)
    with jax.enable_x64(True):
        want = np.asarray(jcomp.interfere_ref_beam(jnp.asarray(rf),
                                                   jnp.asarray(J), 7, deg))
        rj, Ej = jrtm.circular_aperture(jnp.asarray(rf), 3e-3,
                                        E=jnp.asarray(J))
        rj, Ej = np.asarray(rj), np.asarray(Ej)
    got = tcomp.interfere_ref_beam(torch.from_numpy(rf), torch.from_numpy(J),
                                   7, deg)
    _close_complex(got, want, 1e-12)
    rt, Et = trtm.circular_aperture(torch.from_numpy(rf), 3e-3,
                                    E=torch.from_numpy(J))
    assert 0 < np.isnan(rj[0]).sum() < rj.shape[1]
    np.testing.assert_array_equal(rt.numpy(), rj)
    np.testing.assert_array_equal(Et.numpy(), Ej)


@pytest.mark.parametrize("return_acc", [False, True])
@pytest.mark.parametrize("convention", ["legacy", "intensity"])
def test_complex_histogram_matches_jax(convention, return_acc):
    rng = np.random.default_rng(11)
    n = 6000
    x = rng.uniform(-10.0, 10.0, n)
    y = rng.uniform(-7.5, 7.5, n)
    x[:5] = (np.nan, 9.0, -9.0, np.inf, 8.999999)
    y[5:8] = (6.75, np.nan, -6.75)
    Jx = rng.normal(size=n) + 1j * rng.normal(size=n)
    Jy = rng.normal(size=n) + 1j * rng.normal(size=n)
    args = (55, 41, 18.0, 13.5)
    with jax.enable_x64(True):
        want = np.asarray(jhist.complex_histogram(
            *(jnp.asarray(v) for v in (x, y, Jx, Jy)), *args,
            convention=convention, return_acc=return_acc))
    got = thist.complex_histogram(
        *(torch.from_numpy(v) for v in (x, y, Jx, Jy)), *args,
        convention=convention, return_acc=return_acc).numpy()
    assert got.shape == want.shape == (
        (40, 54, 2 if convention == "legacy" else 4) if return_acc
        else (40, 54))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    if return_acc:
        with jax.enable_x64(True):
            fin = np.asarray(jhist.finalize_complex(jnp.asarray(want),
                                                    convention))
        np.testing.assert_allclose(
            thist.finalize_complex(torch.from_numpy(got), convention), fin,
            rtol=1e-12)
    # float32 ray counts: a unit field puts 1 a ray into Re Jy, exactly
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    ones = np.ones(n, np.complex64)
    cj = np.asarray(jhist.complex_histogram(
        jnp.asarray(x32), jnp.asarray(y32), jnp.asarray(ones),
        jnp.asarray(ones), *args, return_acc=True))[..., 1]
    ct = thist.complex_histogram(
        torch.from_numpy(x32), torch.from_numpy(y32),
        torch.from_numpy(ones), torch.from_numpy(ones), *args,
        return_acc=True)[..., 1].numpy()
    np.testing.assert_array_equal(ct, cj)
    with pytest.raises(ValueError, match="convention"):
        thist.finalize_complex(torch.zeros((2, 2, 2)), "amplitude")


@pytest.fixture(scope="module")
def exit_states():
    """An exit-like (9, N) float64 state at an f32-exact exit plane."""
    s0 = np.array(init_beam(jax.random.PRNGKey(2), 6000, 4e-3, 8e-3, EXT,
                            "circular"), np.float64)
    s0[2] = np.float32(EXT * 1.02)
    rng = np.random.default_rng(3)
    s0[6] = rng.uniform(0.5, 1.0, s0.shape[1])
    s0[7] = rng.uniform(0.0, 300.0, s0.shape[1])
    s0[8] = np.linspace(-1, 1, s0.shape[1])
    return s0


@pytest.mark.parametrize("convention", ["legacy", "intensity"])
@pytest.mark.parametrize("bench", COHERENT)
def test_coherent_detector_chain_matches_jax_float64(exit_states, bench,
                                                     convention):
    """The chain the coherent kernel fuses (detect_field's plain version)
    vs JAX _image_from_sf, in float64."""
    s = exit_states
    uf = np.ascontiguousarray(s[[0, 1, 3, 4, 5, 6, 7, 8]].T)
    p_end, depth = float(s[2, 0]), float(np.float32(EXT))
    kw = dict(diagnostic=bench, probing_direction="z", bins=(54, 40),
              lwl=1064e-9, L=400.0, R=25.0, Lx=18.0, Ly=13.5,
              focal_plane=0.0, coherent_convention=convention,
              n_fringes=10.0, deg=20.0)
    with jax.enable_x64(True):
        sf = jreassemble(jnp.asarray(uf), p_end, "z")
        want = np.asarray(jpipe._image_from_sf(
            sf, jnp.asarray(depth), **kw))
        raw = np.asarray(jpipe._image_from_sf(
            sf, jnp.asarray(depth), **kw, coherent_raw=True))
    got = tpipe._image_from_uf(torch.from_numpy(uf), p_end, depth,
                               **kw).numpy()
    assert got.shape == want.shape == (40, 54) and want.max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * want.max())
    acc = detector.detect_field(
        torch.from_numpy(uf), p_end, depth, "z",
        tcomp.BENCHES[bench][0](), (54, 40), 18.0, 13.5, 1064e-9, convention,
        ref=(10.0, 20.0) if bench == "interferometry" else None)
    np.testing.assert_allclose(acc.numpy(), raw, rtol=0,
                               atol=1e-9 * np.abs(raw).max())


@pytest.fixture(scope="module")
def scene():
    jd = JDomain(2 * EXT, 33).test_lens(ne_0=5e24, LR=1.5e-3)
    jd.phaseshift = True
    s0 = init_beam(jax.random.PRNGKey(0), 8192, 2e-3, 0.0, EXT, "circular")
    td = convert.domain(jd, "cpu").test_lens(ne_0=5e24, LR=1.5e-3)
    return jd, td, s0, convert.tensor(s0, "cpu")


def _rel_l1(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape and np.isfinite(a).all()
    return float(np.abs(a - b).sum() / np.abs(b).sum())


@pytest.mark.parametrize("bench", COHERENT)
@pytest.mark.parametrize("solver", ["zscan_seg", "zscan", "time",
                                    "analytic"])
def test_run_coherent_matches_jax(scene, solver, bench):
    jd, td, s0, ts0 = scene
    kw = dict(solver=solver, bins=(54, 40), diagnostic=bench,
              coherent_convention="intensity" if solver == "time"
              else "legacy")
    if solver != "analytic":
        kw["seg_K"] = 8
    Hj = jpipe.run(jd, s0, **kw)
    Ht = tpipe.run(td, ts0, **kw)
    assert _rel_l1(Ht, Hj) <= 0.03


def test_mixed_coherence_tuples(scene):
    _, td, _, ts0 = scene
    names = ["shadowgraphy", "interferometry", "refractometry_coherent",
             "polarimetry"]
    kw = dict(solver="zscan_seg", seg_K=8, bins=(32, 24))
    multi = tpipe.run(td, ts0, diagnostic=names, **kw)
    assert set(multi) == set(names)
    for name in names:
        assert multi[name].shape == (24, 32)
        assert torch.equal(multi[name], tpipe.run(td, ts0, diagnostic=name,
                                                  **kw))


def test_coherent_raw_halves_sum_to_one_call(scene):
    """Raw field sums of two halves of the bundle, added and finalized
    once, give the one-call image (tests/test_zscan.py:391-394)."""
    _, td, _, ts0 = scene
    names = ("interferometry", "shadowgraphy")
    kw = dict(solver="zscan", bins=(30, 22), diagnostic=names)
    ref = tpipe.run(td, ts0, **kw)
    half = ts0.shape[1] // 2
    a = tpipe.run(td, ts0[:, :half], coherent_raw=True, **kw)
    b = tpipe.run(td, ts0[:, half:], coherent_raw=True, **kw)
    assert a["interferometry"].shape == (22, 30, 2)
    out = tpipe.finalize_coherent(
        tuple(a[n] + b[n] for n in names), names)
    want = ref["interferometry"].numpy()
    np.testing.assert_allclose(out[0].numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    assert torch.equal(out[1], ref["shadowgraphy"])


def test_run_split_interferometry_sums_raw(scene):
    """run_split warns, sums the partitions' raw field sums and finalizes
    once: on a subcritical field one partition holds every ray, so it is
    the one-call zscan_seg image; on a filament it follows JAX."""
    _, td, _, ts0 = scene
    kw = dict(bins=(32, 24), seg_K=8, diagnostic="interferometry")
    with pytest.warns(UserWarning, match="solver-sensitive"):
        img = tpipe.run_split(td, ts0, **kw)
    assert torch.equal(img, tpipe.run(td, ts0, solver="zscan_seg",
                                      critical_guard=None, **kw))
    with pytest.warns(UserWarning, match="solver-sensitive"):
        raw = tpipe.run_split(td, ts0, coherent_raw=True, **kw)
    assert raw.shape == (24, 32, 2)
    n = 41
    jd = JDomain(2 * EXT, n)
    x = np.asarray(jd.z)
    X, Y = np.meshgrid(x, x, indexing="ij")
    r2 = X**2 + Y**2
    nc = 3.14207787e-4 * (2 * np.pi * 2.99792458e8 / 1064e-9) ** 2
    prof = (2.0 * nc * np.exp(-r2 / (0.6e-3) ** 2)
            + 5e24 * np.exp(-r2 / (2e-3) ** 2))
    jd.external_ne(np.broadcast_to(prof[:, :, None], (n, n, n)).copy())
    s0 = init_beam(jax.random.PRNGKey(7), 20000, 3e-3, 0.0, EXT, "circular")
    kw = dict(bins=(24, 18), pad_to=4096, seg_K=8,
              diagnostic=("interferometry", "shadowgraphy"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        out = tpipe.run_split(convert.domain(jd, "cpu"),
                              convert.tensor(s0, "cpu"), **kw)
        want = jpipe.run_split(jd, s0, **kw)
    # the time tracer's rays are the phase-sensitive ones (the JAX
    # package's own float32 time interferogram lies 18% from its float64
    # one on the lens): twice the bound of a single-solver run
    assert _rel_l1(out["interferometry"], want["interferometry"]) <= 0.06
    assert _rel_l1(out["shadowgraphy"], want["shadowgraphy"]) <= 0.002
