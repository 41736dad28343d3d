"""The port's pack-free analytic tracer (``tracer.analytic``, kernel K7's
plain version and the autograd route) against the JAX package's, with the
same JAX-drawn rays; the cases of tests/test_analytic.py on the port.

Tolerances. Exit states: each row within 1e-5 of its largest value (the
JAX test's rtol at tests/test_analytic.py:104) and the phase row within
1e-4: the forms' gradients are written out by hand, not taken by
``jax.grad``, so they may differ in the last place, and omega (n - 1)
cancels: at ne / nc = 1e-4 one last place of n is 6e-4 of a stage's
phase. Hand-written gradients: within 2e-6 of the largest (the JAX test's
rtol at :57) of ``torch.autograd`` of the same torch closure and of
``jax.grad`` of the JAX closure. Images: equal sums and
|H_port - H_jax|.sum() <= 0.002 H_jax.sum() (tests/test_torch_pipeline).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import constants
from synthpy_tpu import pipeline as jpipe
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.tracer import init_beam
from synthpy_tpu.tracer.analytic import solve_zscan_analytic as jsolve
from synthpy_tpu_torch import convert
from synthpy_tpu_torch import pipeline as tpipe
from synthpy_tpu_torch.fields import ScalarDomain
from synthpy_tpu_torch.kernels import analytic as k7
from synthpy_tpu_torch.tracer import solve_zscan_analytic, \
    solve_zscan_segments
from synthpy_tpu_torch.tracer.analytic import trace_domain_analytic

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
LWL = 1064e-9
FORMS = {
    "test_null": {},
    "test_slab": {"s": 0.5, "ne_0": 2e23},
    "test_linear_cos": {"Ly": 2e-3},
    "test_exponential_cos": {"s": 4e-3},
    "test_lens": {"ne_0": 5e24, "LR": 1.5e-3},
    "test_liner": {"ne_0": 5e24, "LR": 2e-3},
}


def _beam(n=512, key=0, size=2e-3, probe="z", div=0.0):
    return init_beam(jax.random.PRNGKey(key), n, size, div, EXT, "circular",
                     probe)


def _t(a):
    return convert.tensor(a, "cpu")


def _both(field, dims=33, probe="z", physics=False, **kw):
    """The same test_* scene in the JAX package and in the port."""
    out = []
    for make in (lambda: JDomain(2 * EXT, dims, probing_direction=probe,
                                 phaseshift=physics),
                 lambda: ScalarDomain(2 * EXT, dims, probing_direction=probe,
                                      phaseshift=physics, device="cpu")):
        d = getattr(make(), field)(**{**FORMS.get(field, {}), **kw})
        if physics:
            d.test_B(Bmax=3.0)
        out.append(d)
    return out


def _close_rows(got, want, phase_tol=1e-4, tol=1e-5):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    for row in range(want.shape[0]):
        scale = max(np.abs(want[row]).max(), 1e-30)
        err = np.abs(got[row] - want[row]).max()
        assert err <= (phase_tol if row == 7 else tol) * scale, (row, err,
                                                                 scale)


# each form on each probing axis; rk4 and the phase / Faraday channels
# (C = 7) on the y axis, rk4 alone on x
CASES = {"z": ("rk2", False), "x": ("rk4", False), "y": ("rk4", True)}


@pytest.mark.parametrize("probe", sorted(CASES))
@pytest.mark.parametrize("field", sorted(FORMS))
def test_forms_march_matches_jax(field, probe):
    integrator, physics = CASES[probe]
    jd, td = _both(field, (17, 19, 21), probe, physics)
    assert isinstance(td.analytic["ne"], k7.ClosedForm)
    s0 = _beam(1024, key=1, size=3e-3, probe=probe, div=1e-3)
    kw = dict(n_steps=12, integrator=integrator, return_E=True)
    rj = jsolve(s0, jd, **kw)
    rt = solve_zscan_analytic(_t(s0), td, **kw)
    _close_rows(rt.sf, rj.sf)
    # |dE| <= |d phase| on a unit field
    phase = np.abs(np.asarray(rj.sf[7])).max()
    np.testing.assert_allclose(rt.Jf.numpy(), np.asarray(rj.Jf), rtol=0,
                               atol=1e-4 * max(phase, 1.0))


@pytest.mark.parametrize("field", sorted(FORMS))
def test_hand_gradients_match_autograd_and_jax_grad(field):
    jd, td = _both(field, 9, "z", physics=True)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-EXT, EXT, (3, 4096)).astype(np.float32)
    form = td.analytic["ne"]
    xyz = [torch.from_numpy(p.copy()).requires_grad_() for p in pts]
    out = form(*xyz)
    want = (torch.autograd.grad(out.sum(), xyz, allow_unused=True)
            if out.requires_grad else (None,) * 3)
    got = form.grad(*(torch.from_numpy(p) for p in pts))
    jgrad = jax.grad(lambda X, Y, Z: jnp.sum(jd.analytic["ne"](X, Y, Z)),
                     argnums=(0, 1, 2))(*(jnp.asarray(p) for p in pts))
    scale = max(max(float(np.abs(np.asarray(g)).max()) for g in jgrad),
                1e-30)
    for g, w, j in zip(got, want, jgrad):
        w = np.zeros(pts.shape[1]) if w is None else w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-6 * scale)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=2e-6 * scale)
    # and the values agree with the JAX closure's
    jv = np.asarray(jd.analytic["ne"](*(jnp.asarray(p) for p in pts)))
    tv = form(*(torch.from_numpy(p) for p in pts)).numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-6,
                               atol=1e-6 * max(np.abs(jv).max(), 1e-30))
    jB = jd.analytic["B"](*(jnp.asarray(p) for p in pts))
    tB = td.analytic["B"](*(torch.from_numpy(p) for p in pts))
    for a, b in zip(tB, jB):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_null_field_straight_lines():
    jd, td = _both("test_null")
    s0 = _beam(256)
    sf = solve_zscan_analytic(_t(s0), td).sf.numpy()
    s0n = np.asarray(s0)
    np.testing.assert_allclose(sf[0], s0n[0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(sf[3:6], s0n[3:6], rtol=1e-7)
    np.testing.assert_allclose(sf[6], 1.0)
    np.testing.assert_allclose(sf[7], 0.0)
    np.testing.assert_allclose(sf[8], 0.0)
    np.testing.assert_array_equal(sf, np.asarray(jsolve(s0, jd).sf))


def test_slab_constant_acceleration_closed_form():
    ne_0, s = 2e23, 1.0
    jd, td = _both("test_slab", 65, s=s, ne_0=ne_0)
    s0 = _beam(128, size=1e-3)
    sf = solve_zscan_analytic(_t(s0), td, integrator="rk2").sf.numpy()
    nc = constants.critical_density(constants.omega_from_lwl(LWL))
    G = -0.5 * constants.C**2 * (ne_0 * s / EXT) / nc
    s0n = np.asarray(s0)
    L = 2 * EXT
    vx_exact = s0n[3] + G * L / s0n[5]
    x_exact = s0n[0] + s0n[3] / s0n[5] * L + 0.5 * G * (L / s0n[5]) ** 2
    np.testing.assert_allclose(sf[3], vx_exact, rtol=2e-6)
    np.testing.assert_allclose(sf[0], x_exact, rtol=0,
                               atol=2e-6 * np.abs(x_exact).max())
    _close_rows(sf, jsolve(s0, jd, integrator="rk2").sf)


def test_lens_analytic_converges_to_gridded_march():
    """(tests/test_analytic.py:62 on the port.)"""
    s0 = _t(_beam(512))
    errs = []
    for dim in (33, 65, 129):
        d = ScalarDomain(2 * EXT, dim, device="cpu").test_lens(ne_0=5e24,
                                                               LR=1.5e-3)
        ra = solve_zscan_analytic(s0, d, n_steps=256)
        rg = solve_zscan_segments(s0, d, K=dim - 1)
        errs.append(float((ra.sf[3] - rg.sf[3]).abs().max()))
    assert errs[2] < errs[1] < errs[0]
    assert errs[2] < 2e-2 * float(ra.sf[3].abs().max())


def test_uniform_phase_attenuation_faraday_integrals():
    """User closures (the autograd route, with Te, Z and B): exact
    closed-form integrals, and the JAX package's result."""
    ne_c, Te_c, Z_c, Bz = 1e24, 100.0, 2.0, 5.0
    spec_t = {
        "ne": lambda x, y, z: ne_c + 0.0 * (x + y + z),
        "Te": lambda x, y, z: Te_c + 0.0 * x,
        "Z": lambda x, y, z: Z_c + 0.0 * x,
        "B": lambda x, y, z: (torch.zeros_like(x), torch.zeros_like(x),
                              Bz + 0.0 * x),
    }
    spec_j = dict(spec_t, B=lambda x, y, z: (jnp.zeros_like(x),
                                             jnp.zeros_like(x),
                                             Bz + 0.0 * x))
    kw = dict(inv_brems=True, phaseshift=True, B_on=True)
    td = ScalarDomain(2 * EXT, 33, device="cpu", **kw)
    td.analytic = spec_t
    jd = JDomain(2 * EXT, 33, **kw)
    jd.analytic = spec_j
    s0 = _beam(64, size=1e-3)
    sf = solve_zscan_analytic(_t(s0), td, lwl=LWL, integrator="rk2",
                              route="autograd").sf.numpy()
    omega = constants.omega_from_lwl(LWL)
    L = 2 * EXT
    vz = np.asarray(s0)[5]
    phase_exact = omega * (constants.n_refrac(ne_c, omega) - 1.0) * L / vz
    kap = float(constants.kappa(jnp.asarray(ne_c), jnp.asarray(Te_c),
                                jnp.asarray(Z_c), omega))
    np.testing.assert_allclose(sf[7], phase_exact, rtol=1e-5)
    np.testing.assert_allclose(sf[6], np.exp(-kap * L / vz), rtol=1e-5)
    np.testing.assert_allclose(
        sf[8], constants.verdet_constant(LWL) * ne_c * Bz * L, rtol=1e-3)
    _close_rows(sf, jsolve(s0, jd, lwl=LWL, integrator="rk2").sf)
    # the spec chooses the route: a closure cannot take the kernel's
    with pytest.raises(ValueError, match="route='kernel'"):
        solve_zscan_analytic(_t(s0), td, route="kernel")


@pytest.mark.parametrize("physics", [False, True])
def test_autograd_route_matches_kernel_route(physics):
    """The forms' torch closures through autograd == their hand-written
    gradients through K7's plain version."""
    _, td = _both("test_lens", (17, 19, 21), "y", physics)
    s0 = _t(_beam(512, size=3e-3, probe="y", div=1e-3))
    a = solve_zscan_analytic(s0, td, n_steps=10, route="autograd").sf
    b = solve_zscan_analytic(s0, td, n_steps=10, route="kernel").sf
    _close_rows(a, b.numpy(), phase_tol=1e-5, tol=1e-6)


def test_outside_box_fill_zero_matches_gridded():
    _, td = _both("test_lens")
    s0 = np.array(_beam(16))
    s0[0] += 1.0  # 1 m off-axis: far outside the 1 cm box
    sf = solve_zscan_analytic(_t(s0), td).sf.numpy()
    np.testing.assert_allclose(sf[3], s0[3], rtol=1e-7)
    np.testing.assert_allclose(sf[4], s0[4], rtol=1e-7)


def test_ray_chunking_bit_identical():
    _, td = _both("test_lens")
    s0 = _t(_beam(1000))
    r1 = solve_zscan_analytic(s0, td)
    r2 = solve_zscan_analytic(s0, td, ray_chunk=256)
    assert torch.equal(r1.sf, r2.sf)


def test_pipeline_run_analytic_image_matches_jax_and_gridded():
    jd, td = _both("test_lens", 65)
    s0 = _beam(20000)
    Ha = tpipe.run(td, _t(s0), solver="analytic", bins=(61, 41))
    Hg = tpipe.run(td, _t(s0), solver="zscan_seg", bins=(61, 41))
    assert float(Ha.sum()) == pytest.approx(float(Hg.sum()))
    assert float((Ha - Hg).abs().sum() / Hg.sum()) < 0.06
    Hj = np.asarray(jpipe.run(jd, s0, solver="analytic", bins=(61, 41)))
    assert Ha.numpy().sum() == Hj.sum() > 0
    assert np.abs(Ha.numpy() - Hj).sum() <= 0.002 * Hj.sum()
    # rk4 and a step count through run, as the JAX package takes them
    kw = dict(solver="analytic", bins=(61, 41), integrator="rk4",
              n_steps=40, critical_guard=None)
    H4 = tpipe.run(td, _t(s0), **kw)
    Hj4 = np.asarray(jpipe.run(jd, s0, **kw))
    assert np.abs(H4.numpy() - Hj4).sum() <= 0.002 * Hj4.sum()


def test_pipeline_run_analytic_requires_closures():
    td = ScalarDomain(2 * EXT, 17, device="cpu")
    td.external_ne(np.zeros((17, 17, 17), np.float32))
    with pytest.raises(ValueError, match="analytic"):
        tpipe.run(td, _t(_beam(16)), solver="analytic", critical_guard=None,
                  bins=(8, 8))
    # a form carries no Te / Z: inv_brems raises as in the JAX package
    td = ScalarDomain(2 * EXT, 17, inv_brems=True, device="cpu").test_lens()
    with pytest.raises(ValueError, match="inv_brems needs 'Te' and 'Z'"):
        solve_zscan_analytic(_t(_beam(16)), td)


def test_external_fields_clear_analytic():
    for load in ("external_ne", "external_B", "external_Te", "external_Z"):
        td = ScalarDomain(2 * EXT, 17, device="cpu").test_lens().test_B()
        assert set(td.analytic) == {"ne", "B"}
        shape = (17, 17, 17, 3) if load == "external_B" else (17,) * 3
        getattr(td, load)(np.ones(shape, np.float32))
        assert td.analytic is None


def test_rk4_matches_rk2_on_smooth_lens():
    _, td = _both("test_lens", 65)
    s0 = _t(_beam(256))
    r2 = solve_zscan_analytic(s0, td, integrator="rk2")
    r4 = solve_zscan_analytic(s0, td, integrator="rk4")
    vscale = float(r4.sf[3].abs().max())
    assert float((r2.sf[3] - r4.sf[3]).abs().max()) < 1e-4 * vscale


def test_last_stage_box_test_rounds_as_jax():
    """rk4's last stage sits at fma(n - 1, h, p0) + h, which rounds past
    the box's far face at 32 steps across 33 planes: a field linear in the
    probing coordinate then gives its last-stage kick to JAX's rays and
    the port's alike (p0 + (n - 1) h rounded twice would drop it)."""
    spec_t = {"ne": lambda x, y, z: 5e24 * (1.0 + z / EXT) + 0.0 * (x + y)}
    spec_j = {"ne": lambda x, y, z: 5e24 * (1.0 + z / EXT) + 0.0 * (x + y)}
    td = ScalarDomain(2 * EXT, 33, device="cpu")
    td.analytic = spec_t
    jd = JDomain(2 * EXT, 33)
    jd.analytic = spec_j
    s0 = _beam(1024, size=2e-3, div=5e-3)
    steps = k7.Steps.of(float(np.asarray(jd.z)[0]),
                        (float(np.asarray(jd.z)[-1])
                         - float(np.asarray(jd.z)[0])) / 32)
    assert k7.f32(steps.p(31) + steps.h) <= float(np.asarray(jd.z)[-1])
    a = solve_zscan_analytic(_t(s0), td, n_steps=32, integrator="rk4").sf
    b = jsolve(s0, jd, n_steps=32, integrator="rk4").sf
    _close_rows(a, b, tol=1e-6)


def test_trace_domain_exit_plane():
    _, td = _both("test_lens", (9, 11, 13), "x")
    uf, p_end = trace_domain_analytic(_t(_beam(64, probe="x")), td,
                                      n_steps=4)
    assert uf.shape == (64, 8) and p_end == float(td.x[-1])
