"""Proton radiography (``synthpy_tpu_torch.tracer.particles``) against the
JAX package on the same inputs, on the CPU (the kernels K13 and K14 run
their plain versions here).

Tolerances, each from what the two sides compute:
* beams from the same key: positions equal; velocities within 1e-6 of
  the speed (XLA's cos / sin and the port's differ in the last place on
  ~5% of the draws; observed <= 2.4e-7);
* the march (``trace_protons``, 120-250 steps at 32-33^3): each exit
  column within 1e-5 of its largest |value|. The port repeats the fused
  multiply-adds of XLA's compiled scan body (bit-equal over 2 steps); over
  the whole march a few rows drift by ulps (observed <= 5.3e-6 of the
  position columns, <= 2.4e-7 of the velocity columns);
* B tables: bf16 and int8 codes bit-equal to JAX's device route, dithered
  too (the same threefry stream, and XLA's arithmetic: the product with
  the scale's float32 reciprocal, fused with the dither's add), also on
  values planted at code boundaries; the host route bit-equal to JAX's
  host route (the same numpy Philox stream, a true division); scales
  equal;
* radiograph counts equal on the same exit states.
The JAX package's own physics gates run on the port as ``test_port_*``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import constants as jc
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields.grf import grf_vector_solenoidal as jsolenoidal
from synthpy_tpu.fields.grf import power_law as jpower_law
from synthpy_tpu.ops.interp import grid_geometry as jgrid_geometry
from synthpy_tpu.tracer import particles as jp
from synthpy_tpu_torch import constants, convert
from synthpy_tpu_torch import random as tr
from synthpy_tpu_torch.fields import ScalarDomain
from synthpy_tpu_torch.fields.grf import grf_vector_solenoidal, power_law
from synthpy_tpu_torch.kernels import boris
from synthpy_tpu_torch.ops.interp import grid_geometry
from synthpy_tpu_torch.tracer import particles as tp

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
NP = 1024
TIERS = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                        torch.bfloat16),
         "int8": (jnp.int8, torch.int8)}


def _codes_close(a, b):
    """int8 codes within one step, on at most 1e-4 of them."""
    d = (a.to(torch.int16) - b.to(torch.int16)).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-4


def _cols_close(j, t, rel):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape
    scale = np.abs(j).max(axis=0)
    err = (np.abs(j - t) / scale).max(axis=0)
    assert (err <= rel).all(), err


@pytest.fixture(scope="module")
def grf_B():
    """A 32^3 solenoidal GRF B field (JAX's, from key 5)."""
    _, B = jsolenoidal(jax.random.PRNGKey(5), jpower_law(3.667),
                       l_max=2e-3, l_min=0.5e-3, extent=EXT, res=16,
                       rms=5.0)
    return np.array(B, np.float32)


def _fields(name, grf_B, probe):
    """(JAX domain, port domain) of a named field on the CPU."""
    if name == "test_B":
        jd = JDomain(2 * EXT, 33, probing_direction=probe).test_B(Bmax=40.0)
        td = ScalarDomain(2 * EXT, 33, probing_direction=probe,
                          device="cpu").test_B(Bmax=40.0)
        return jd, td
    jd = JDomain(2 * EXT, 32, probing_direction=probe)
    jd.external_B(grf_B)
    td = ScalarDomain(2 * EXT, 32, probing_direction=probe, device="cpu")
    td.external_B(grf_B)
    return jd, td


def test_torch_constants_and_proton_speed():
    assert constants.M_PROTON == jc.M_PROTON
    assert constants.PROTON_REST_MEV == jc.PROTON_REST_MEV
    for E in (3.0, 14.7):
        assert tp.proton_speed(E) == jp.proton_speed(E)


@pytest.mark.parametrize("probe", ["z", "x"])
def test_torch_init_proton_beam_matches_jax(probe):
    j = np.asarray(jp.init_proton_beam(jax.random.PRNGKey(11), 4096, 14.7,
                                       source_distance=10e-3, extent=EXT,
                                       cone_radius=0.6 * EXT,
                                       probing_direction=probe))
    t = tp.init_proton_beam(tr.PRNGKey(11), 4096, 14.7,
                            source_distance=10e-3, extent=EXT,
                            cone_radius=0.6 * EXT, probing_direction=probe,
                            device="cpu").numpy()
    np.testing.assert_array_equal(t[:, :3], j[:, :3])
    v, _ = tp.proton_speed(14.7)
    assert np.abs(t[:, 3:] - j[:, 3:]).max() <= 1e-6 * v
    np.testing.assert_allclose(np.sqrt((t[:, 3:].astype(np.float64)**2)
                                       .sum(1)), v, rtol=1e-6)


def _beam(probe, n=NP, key=1):
    return np.array(jp.init_proton_beam(
        jax.random.PRNGKey(key), n, 14.7, source_distance=10e-3, extent=EXT,
        cone_radius=0.5 * EXT, probing_direction=probe))


@pytest.mark.parametrize("probe", ["z", "x"])
@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("field", ["test_B", "grf"])
def test_torch_trace_protons_matches_jax(grf_B, field, tier, probe):
    """Rows in, rows out, through the domain's grid (f32) or a device-route
    table (bf16, int8 dithered); the same exits within 1e-5 of a
    column."""
    jd, td = _fields(field, grf_B, probe)
    s0 = _beam(probe)
    jt = tt = None
    if tier != "f32":
        dither = 9 if tier == "int8" else None
        jt = jp.build_B_table(jd, dtype=TIERS[tier][0], plane_batch=7,
                              dither=dither, host_quantize=False)
        tt = tp.build_B_table(td, dtype=TIERS[tier][1], plane_batch=7,
                              dither=dither, host_quantize=False)
    j = jp.trace_protons(s0, jd, 14.7, B_table=jt)
    t = tp.trace_protons(s0, td, 14.7, B_table=tt)
    _cols_close(j, t, 1e-5)
    # the field deflects: transverse exit velocities change
    a_ax = [a for a in range(3) if a != "xyz".index(probe)][0]
    assert np.abs(np.asarray(j)[:, 3 + a_ax] - s0[:, 3 + a_ax]).max() > 0


@pytest.mark.parametrize("rows", [6, 9])
def test_torch_trace_protons_column_state(grf_B, rows):
    """A (6, N) or (9, N) column state gives (6, N) columns, the rows'
    march transposed, as in JAX."""
    jd, td = _fields("grf", grf_B, "z")
    s0 = _beam("z", 256)
    cols = np.zeros((rows, 256), np.float32)
    cols[:6] = s0.T
    j = np.asarray(jp.trace_protons(cols, jd, 14.7))
    t = tp.trace_protons(cols, td, 14.7)
    assert j.shape == tuple(t.shape) == (6, 256)
    _cols_close(j.T, t.T, 1e-5)
    torch.testing.assert_close(t.T, tp.trace_protons(s0, td, 14.7),
                               rtol=0, atol=0)


def test_torch_trace_protons_ray_chunk_is_ignored(grf_B):
    _, td = _fields("grf", grf_B, "z")
    s0 = _beam("z", 300)
    assert torch.equal(tp.trace_protons(s0, td, 14.7, ray_chunk=128),
                       tp.trace_protons(s0, td, 14.7))


def test_torch_boris_step_is_jax_compiled_step(grf_B):
    """Two steps of the plain K13 (at trace_protons' step for this grid)
    against JAX's compiled _push_boris on every table dtype: bit for bit
    on all but at most 0.5% of the values (the fused multiply-adds found
    by emulation; observed: 0-3 of the 12,288 values differ, by an ulp),
    the rest within 1e-6 of a column."""
    jd, td = _fields("grf", grf_B, "z")
    rows = _beam("z", 2048)
    rows[:, 2] = -EXT
    origin, inv = jgrid_geometry((jd.x, jd.y, jd.z))
    v, gamma = jp.proton_speed(14.7)
    n_steps = round(2.0 * 2 * EXT / (2 * EXT / 31) * 2.0)
    dt = jnp.float32(2.0 * 2 * EXT / v / n_steps)
    w = jc.E_CHARGE / (gamma * jc.M_PROTON)
    h = float(np.float32(0.5) * np.float32(dt))
    wdt = float(np.float32(np.float32(0.5 * w) * np.float32(dt)))
    o = [float(x) for x in np.asarray(origin)]
    i = [float(x) for x in np.asarray(inv)]
    for tier in ("f32", "bf16", "int8"):
        jt = jp.build_B_table(jd, dtype=TIERS[tier][0], host_quantize=False)
        tt = convert.b_table(jt, device="cpu")
        j = np.asarray(jp._push_boris(jnp.asarray(rows), jt.grid, origin,
                                      inv, dt, n_steps=2, gamma=gamma,
                                      B_scale=jt.scale))
        t = boris.push(torch.from_numpy(rows), tt.grid, tt.scale, o, i, h,
                       wdt, 2).numpy()
        assert (t != j).mean() <= 5e-3, (tier, (t != j).mean())
        _cols_close(j, t, 1e-6)


@pytest.mark.parametrize("tier,dither", [("bf16", None), ("int8", None),
                                         ("int8", 11)])
def test_torch_build_B_table_device_route_is_jaxs(grf_B, tier, dither):
    jd = JDomain(2 * EXT, 32)
    jd.external_B(grf_B, host=True)
    td = ScalarDomain(2 * EXT, 32, device="cpu")
    td.external_B(grf_B, host=True)
    jt = jp.build_B_table(jd, dtype=TIERS[tier][0], plane_batch=7,
                          dither=dither, host_quantize=False)
    tt = tp.build_B_table(td, dtype=TIERS[tier][1], plane_batch=7,
                          dither=dither, host_quantize=False)
    conv = convert.b_table(jt, device="cpu")
    assert tt.grid.dtype == conv.grid.dtype == TIERS[tier][1]
    assert torch.equal(tt.grid, conv.grid)
    if tier == "int8":
        assert torch.equal(tt.scale, conv.scale)
    else:
        assert tt.scale is None and conv.scale is None


@pytest.mark.parametrize("dither", [None, 11])
def test_torch_build_B_table_device_route_on_code_boundaries(dither):
    """The device route's quotient is XLA's: the product with the scale's
    float32 reciprocal (fused with the dither's add), not a true division.
    On B values planted at the code boundaries of that product (about a
    quarter of the grid), the port's codes are JAX's bit for bit."""
    n = 16
    rng = np.random.default_rng(1)
    B = (3 * rng.standard_normal((n, n, n, 3))).astype(np.float32)
    m = np.abs(B).max(axis=(0, 1, 2)).astype(np.float64)
    rcp = np.float32(1) / (np.maximum(m, 1e-30) / 127.0).astype(np.float32)
    flat = B.reshape(-1)
    mt, rc = np.tile(m, flat.size // 3), np.tile(rcp, flat.size // 3)
    u = np.zeros_like(flat)
    if dither is not None:
        u = np.concatenate([tr.uniform(tr.fold_in(tr.PRNGKey(dither), i0),
                                       (8 * n * n * 3,), minval=-0.5,
                                       maxval=0.5, device="cpu").numpy()
                            for i0 in (0, 8)])
    k = np.round(flat * rc + u)
    w = ((k - 0.5 - u).astype(np.float64) / rc).astype(np.float32)
    pick = np.where((np.abs(w) < 0.9 * mt) & (np.abs(flat) < 0.9 * mt))[0]
    for j, c in enumerate(pick):
        v = w[c]
        for _ in range(j % 5):
            v = np.nextafter(v, np.float32(np.inf if j % 2 else -np.inf))
        flat[c] = v
    assert np.array_equal(np.abs(B).max(axis=(0, 1, 2)), m)
    jd = JDomain(2 * EXT, n)
    jd.external_B(B, host=True)
    td = ScalarDomain(2 * EXT, n, device="cpu")
    td.external_B(B, host=True)
    jt = jp.build_B_table(jd, dtype=jnp.int8, plane_batch=8, dither=dither,
                          host_quantize=False)
    tt = tp.build_B_table(td, dtype=torch.int8, plane_batch=8,
                          dither=dither, host_quantize=False)
    np.testing.assert_array_equal(tt.grid.numpy(), np.asarray(jt.grid))
    # a true division gives other codes on these values
    assert (np.round(flat / np.tile((np.maximum(m, 1e-30) / 127.0).astype(
        np.float32), flat.size // 3) + u) != np.round(flat * rc + u)).any()


@pytest.mark.parametrize("dither", [None, 11])
def test_torch_build_B_table_host_route_is_jaxs(grf_B, dither):
    """numpy host grids take the host-quantise route: JAX's codes bit for
    bit (numpy's true division), dithered by the same numpy Philox stream.
    Undithered they are the device route's up to the device route's
    reciprocal product: within one step, on at most 1e-4 of the codes (as
    in the JAX package)."""
    jd = JDomain(2 * EXT, 32)
    jd.external_B(grf_B, host=True)
    td = ScalarDomain(2 * EXT, 32, device="cpu")
    td.B = grf_B
    jt = jp.build_B_table(jd, dtype=jnp.int8, plane_batch=7, dither=dither)
    tt = tp.build_B_table(td, dtype=torch.int8, plane_batch=7,
                          dither=dither)
    np.testing.assert_array_equal(tt.grid.numpy(), np.asarray(jt.grid))
    np.testing.assert_array_equal(tt.scale.numpy(), np.asarray(jt.scale))
    if dither is None:
        dev_route = tp.build_B_table(td, dtype=torch.int8, plane_batch=7,
                                     host_quantize=False)
        _codes_close(dev_route.grid, tt.grid)


def test_torch_b_table_f32_is_the_grid(grf_B):
    _, td = _fields("grf", grf_B, "z")
    t32 = tp.build_B_table(td, dtype=torch.float32, plane_batch=5)
    assert torch.equal(t32.grid, td.B) and t32.scale is None
    s0 = _beam("z", 256)
    assert torch.equal(tp.trace_protons(s0, td, 14.7, B_table=t32),
                       tp.trace_protons(s0, td, 14.7))


@pytest.mark.parametrize("probe", ["z", "y"])
def test_torch_proton_radiograph_counts_equal(grf_B, probe):
    jd, _ = _fields("grf", grf_B, probe)
    sf = np.array(jp.trace_protons(_beam(probe), jd, 14.7))
    sf[:7, 3 + "xyz".index(probe)] *= -1.0     # mirrored protons weigh 0
    j = np.asarray(jp.proton_radiograph(sf, 100e-3, EXT, bins=(64, 48),
                                        Lx=70.0, Ly=70.0,
                                        probing_direction=probe))
    t = tp.proton_radiograph(torch.from_numpy(sf), 100e-3, EXT,
                             bins=(64, 48), Lx=70.0, Ly=70.0,
                             probing_direction=probe)
    np.testing.assert_array_equal(t.numpy(), j)
    assert j.sum() == NP - 7


def test_torch_entry_points_refuse_a_missing_field():
    td = ScalarDomain(2 * EXT, 9, device="cpu")
    with pytest.raises(RuntimeError, match="external_B"):
        tp.trace_protons(np.zeros((4, 6), np.float32), td, 14.7)
    with pytest.raises(RuntimeError, match="external_B"):
        tp.build_B_table(td)
    with pytest.raises(ValueError, match="2-D"):
        tp.trace_protons(np.zeros(6, np.float32), td, 14.7)


@pytest.mark.parametrize("as_array", [False, True])
def test_torch_host_B_goes_to_the_domain_device(monkeypatch, grf_B,
                                                as_array):
    """Without a ``B_table``, a host-resident ``domain.B`` (a CPU tensor
    of a card's domain, or a numpy array) goes to the domain's device, as
    the JAX package's ``jnp.asarray(domain.B)`` does, and K13 marches
    there: no plain march runs on the host. The "meta" device stands in
    for the card, and K13's launch is recorded instead of run."""
    from synthpy_tpu_torch.kernels import _build

    td = ScalarDomain(2 * EXT, 32, device="cpu").external_B(grf_B,
                                                            host=True)
    if as_array:
        td.B = grf_B
    td.device = torch.device("meta")   # a card's domain, B on the host
    seen = []
    monkeypatch.setattr(
        _build.Kernel, "launch",
        lambda self, name, device, *args: seen.append(
            (name, torch.device(device).type)))

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain march ran")

    monkeypatch.setattr(boris, "push_plain", no_plain)
    out = tp.trace_protons(_beam("z", n=64), td, 14.7)
    assert out.device.type == "meta" and tuple(out.shape) == (64, 6)
    assert seen == [("boris_push", "meta")]


# -- the JAX package's physics gates (tests/test_particles.py) on the port

def test_port_boris_uniform_bz_gyration_and_speed_invariance():
    B0 = 20.0
    v, gamma = tp.proton_speed(3.0)
    r_g = gamma * constants.M_PROTON * v / (constants.E_CHARGE * B0)
    L, n = 6 * r_g, 9
    grid = torch.zeros((n, n, n, 3))
    grid[..., 2] = B0
    coords = [torch.linspace(-L, L, n) for _ in range(3)]
    origin, inv = grid_geometry(coords)
    o, i = origin.tolist(), inv.tolist()
    s = torch.tensor([[r_g, 0.0, 0.0, 0.0, -v, 0.0]], dtype=torch.float32)
    period = 2 * math.pi * gamma * constants.M_PROTON / (
        constants.E_CHARGE * B0)
    n_steps = 1024
    dt = np.float32(period / n_steps)
    w = constants.E_CHARGE / (gamma * constants.M_PROTON)
    h = float(np.float32(0.5) * dt)
    wdt = float(np.float32(np.float32(0.5 * w) * dt))
    out = boris.push(s, grid, None, o, i, h, wdt, n_steps).numpy()
    np.testing.assert_allclose(np.sqrt((out[0, 3:] ** 2).sum()), v,
                               rtol=1e-6)
    np.testing.assert_allclose(out[0, 0], r_g, rtol=2e-3)
    assert abs(out[0, 1]) < 5e-3 * r_g
    mid = boris.push(s, grid, None, o, i, h, wdt, n_steps // 2).numpy()
    np.testing.assert_allclose(np.hypot(mid[0, 0], mid[0, 1]), r_g,
                               rtol=2e-3)


def test_port_slab_deflection_matches_analytic():
    Bx, n = 5.0, 33
    d = ScalarDomain(2 * EXT, n, device="cpu")
    B = np.zeros((n, n, n, 3), np.float32)
    B[..., 0] = Bx
    d.external_B(B)
    v, gamma = tp.proton_speed(14.7)
    s0 = torch.tensor([[0.0, 0.0, -2 * EXT, 0.0, 0.0, v]])
    sf = tp.trace_protons(s0, d, 14.7, steps_per_cell=8.0).numpy()
    theta_ref = constants.E_CHARGE * Bx * (2 * EXT) / (
        gamma * constants.M_PROTON * v)
    np.testing.assert_allclose(sf[0, 4] / sf[0, 5], theta_ref, rtol=5e-3)
    np.testing.assert_allclose(np.sqrt((sf[0, 3:].astype(np.float64) ** 2)
                                       .sum()), v, rtol=1e-6)


def test_port_point_projection_radiograph_conservation_and_structure():
    n, Np = 32, 20000
    d0 = ScalarDomain(2 * EXT, n, device="cpu")
    d0.external_B(np.zeros((n, n, n, 3), np.float32))
    s0 = tp.init_proton_beam(tr.PRNGKey(3), Np, 14.7, source_distance=10e-3,
                             extent=EXT, cone_radius=0.5 * EXT,
                             device="cpu")
    kw = dict(detector_distance=100e-3, extent=EXT, bins=(64, 48), Lx=70.0,
              Ly=70.0)
    H0 = tp.proton_radiograph(tp.trace_protons(s0, d0, 14.7,
                                               ray_chunk=8192), **kw)
    assert float(H0.sum()) == Np
    dB = ScalarDomain(2 * EXT, n, device="cpu")
    _, Bf = grf_vector_solenoidal(tr.PRNGKey(5), power_law(3.667),
                                  l_max=2e-3, l_min=0.5e-3, extent=EXT,
                                  res=n // 2, rms=5.0, device="cpu")
    dB.external_B(Bf)
    HB = tp.proton_radiograph(tp.trace_protons(s0, dB, 14.7,
                                               ray_chunk=8192), **kw)
    assert Np * 0.95 <= float(HB.sum()) <= Np
    assert float((HB - H0).abs().sum() / H0.sum()) > 0.05


def test_port_b_table_tiers_accuracy_and_host_build(grf_B):
    """bf16 within 0.6% and dithered int8 within 2% RMS transverse exit
    velocity of the f32 trace, from a host-resident grid; |v| kept to
    1e-6; the undithered host route equals the device route."""
    n, Np = 32, 4000
    d = ScalarDomain(2 * EXT, n, device="cpu")
    d.B = grf_B
    s0 = tp.init_proton_beam(tr.PRNGKey(1), Np, 14.7, source_distance=10e-3,
                             extent=EXT, cone_radius=0.5 * EXT,
                             device="cpu")
    v, _ = tp.proton_speed(14.7)
    t32 = tp.build_B_table(d, dtype=torch.float32, plane_batch=7)
    sf_ref = tp.trace_protons(s0, d, 14.7, B_table=t32).numpy()
    d_dev = ScalarDomain(2 * EXT, n, device="cpu")
    d_dev.external_B(grf_B)
    np.testing.assert_allclose(
        sf_ref, tp.trace_protons(s0, d_dev, 14.7).numpy(), rtol=1e-6)
    sig = np.sqrt(np.mean(sf_ref[:, 3] ** 2 + sf_ref[:, 4] ** 2))
    for dtype, dither, tol in ((torch.bfloat16, None, 0.006),
                               (torch.int8, 11, 0.02)):
        tab = tp.build_B_table(d, dtype=dtype, plane_batch=7, dither=dither)
        assert tab.grid.dtype == dtype
        sf = tp.trace_protons(s0, d, 14.7, B_table=tab).numpy()
        err = np.sqrt(np.mean((sf[:, 3] - sf_ref[:, 3]) ** 2
                              + (sf[:, 4] - sf_ref[:, 4]) ** 2))
        assert err / sig < tol, (dtype, err / sig)
        np.testing.assert_allclose(np.sqrt((sf[:, 3:].astype(np.float64)
                                            ** 2).sum(axis=1)), v,
                                   rtol=1e-6)
    # the JAX gate holds the routes bit-equal on its field; the device
    # route multiplies by the scale's reciprocal where the host route
    # divides, so a value on a code boundary may differ by one step
    t_host = tp.build_B_table(d, dtype=torch.int8, plane_batch=7)
    t_dev = tp.build_B_table(d, dtype=torch.int8, plane_batch=7,
                             host_quantize=False)
    _codes_close(t_host.grid, t_dev.grid)
    assert torch.equal(t_host.scale, t_dev.scale)


@pytest.mark.parametrize("field", ["test_B", "grf"])
def test_torch_convert_domain_carries_B(grf_B, field):
    """``convert.domain`` copies a JAX domain's B grid bit for bit (the
    port's own test_B sits on its grid, which differs from JAX's in the
    last place, tests/test_torch_domain.py), and the converted domain
    traces as JAX's within 1e-5 of a column."""
    jd, _ = _fields(field, grf_B, "z")
    cd = convert.domain(jd, device="cpu")
    assert cd.B_on
    np.testing.assert_array_equal(cd.B.numpy(), np.asarray(jd.B))
    s0 = _beam("z", 256)
    _cols_close(jp.trace_protons(s0, jd, 14.7),
                tp.trace_protons(s0, cd, 14.7), 1e-5)
