"""Port ScalarDomain, build_pack and init_beam vs the JAX package.

Grids to 1e-6 of the half-length (XLA folds linspace's division into a
reciprocal and reassociates it: a last-place difference, and 6e-11 m in
place of the exact 0 at the midpoint); analytic fields to 1e-5 of their
peak.
Beams: the generators differ, so random beams are held to their
distribution (bounds, moments) and the deterministic 'even' layout to
rtol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields import build_pack as jbuild_pack
from synthpy_tpu.fields import peak_ne_over_nc as jpeak
from synthpy_tpu.tracer.beam import init_beam as jinit
from synthpy_tpu_torch import convert
from synthpy_tpu_torch.fields import ScalarDomain, build_pack, peak_ne_over_nc
from synthpy_tpu_torch.tracer.beam import init_beam

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

FIELDS = {
    "test_null": {},
    "test_slab": {"s": 0.5, "ne_0": 2e23},
    "test_linear_cos": {"Ly": 2e-3},
    "test_exponential_cos": {"s": 4e-3},
    "test_lens": {"ne_0": 5e24, "LR": 1.5e-3},
    "test_liner": {"LR": 2e-3},
}


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_analytic_fields_match_jax(field):
    dims, L = (9, 11, 13), (1e-2, 8e-3, 6e-3)
    jd = getattr(JDomain(L, dims), field)(**FIELDS[field])
    td = getattr(ScalarDomain(L, dims, device="cpu"), field)(**FIELDS[field])
    for a, b in zip((jd.x, jd.y, jd.z), (td.x, td.y, td.z)):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-6 * np.abs(a).max())
    assert td.extent == pytest.approx(jd.extent, rel=1e-6)
    want = np.asarray(jd.ne)
    np.testing.assert_allclose(td.ne.numpy(), want, rtol=0,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))
    assert td.ne.shape == dims and td.ne.dtype == torch.float32


def test_test_B_and_external_fields():
    jd = JDomain(1e-2, 9).test_lens().test_B(Bmax=3.0)
    td = ScalarDomain(1e-2, 9, device="cpu").test_lens().test_B(Bmax=3.0)
    np.testing.assert_allclose(td.B.numpy(), np.asarray(jd.B), rtol=1e-6,
                               atol=1e-9)
    assert td.B_on
    Te = np.linspace(0.1, 5, 729).reshape(9, 9, 9)
    td.external_Te(Te, Te_min=1.0)
    jd.external_Te(Te, Te_min=1.0)
    np.testing.assert_array_equal(td.Te.numpy(), np.asarray(jd.Te))
    B = np.random.default_rng(5).normal(size=(9, 9, 9, 3))
    Z = np.full((9, 9, 9), 2.0)
    td.B_on = jd.B_on = False
    td.external_B(B).external_Z(Z)
    jd.external_B(B)
    jd.external_Z(Z)
    assert td.B_on and jd.B_on
    np.testing.assert_array_equal(td.B.numpy(), np.asarray(jd.B))
    np.testing.assert_array_equal(td.Z.numpy(), np.asarray(jd.Z))
    with pytest.raises(ValueError):
        td.external_ne(np.zeros((9, 9, 8)))


def test_build_pack_and_peak_match_jax():
    jd = JDomain(1e-2, 13).test_lens(ne_0=1e25, LR=2e-3)
    jd.external_Te(50.0 * np.ones(jd.dims))
    jd.external_Z(2.0 * np.ones(jd.dims))
    jd.inv_brems = jd.phaseshift = True
    jd.test_B(Bmax=10.0)
    td = convert.domain(jd, "cpu")
    jp, tp = jbuild_pack(jd), build_pack(td)
    want = np.asarray(jp.channels)
    for c in range(want.shape[-1]):
        scale = np.abs(want[..., c]).max()
        np.testing.assert_allclose(tp.channels[..., c].numpy(),
                                   want[..., c], rtol=0, atol=1e-6 * scale)
    np.testing.assert_array_equal(tp.origin, jp.origin)
    np.testing.assert_array_equal(tp.inv_spacing, jp.inv_spacing)
    assert peak_ne_over_nc(td) == pytest.approx(jpeak(jd), rel=1e-6)


@pytest.mark.parametrize("beam_type", ["circular", "square", "rectangular",
                                       "linear"])
@pytest.mark.parametrize("direction", ["x", "y", "z"])
def test_random_beams_distribution(beam_type, direction):
    size = (1e-3, 2e-3) if beam_type == "rectangular" else 1.5e-3
    s0 = init_beam(torch.Generator().manual_seed(4), 20000, size, 1e-3,
                   5e-3, beam_type, probing_direction=direction,
                   device="cpu")
    assert s0.shape == (9, 20000) and s0.dtype == torch.float32
    p = {"x": 0, "y": 1, "z": 2}[direction if beam_type != "linear"
                                 else "z"]
    a, b = [s0[i] for i in range(3) if i != p]
    assert torch.all(s0[p] == -5e-3)
    assert torch.all(s0[6] == 1) and torch.all(s0[7:] == 0)
    speed = torch.sqrt((s0[3:6].double() ** 2).sum(0))
    assert torch.allclose(speed, torch.full_like(speed, 2.99792458e8),
                          rtol=1e-6)
    lim = max(size) if isinstance(size, tuple) else size
    assert a.abs().max() <= lim and b.abs().max() <= lim
    assert abs(float(a.mean())) < 0.05 * lim
    if beam_type == "circular":
        assert float((a**2 + b**2).sqrt().max()) <= size * (1 + 1e-6)
        # uniform disc: <r^2> = R^2 / 2
        assert float((a**2 + b**2).mean()) == pytest.approx(size**2 / 2,
                                                            rel=0.03)
    if beam_type == "linear":
        assert torch.all(b == 0)
    # polar angle chi ~ N(0, divergence): <|sin chi|> = div * sqrt(2/pi)
    vt = torch.sqrt(sum(s0[3 + i].double() ** 2 for i in range(3) if i != p))
    assert float((vt / 2.99792458e8).mean()) == pytest.approx(
        1e-3 * np.sqrt(2 / np.pi), rel=0.03)


def test_even_beam_matches_jax_and_seed_reproducible():
    want = np.asarray(jinit(jax.random.PRNGKey(0), 400, 2e-3, 0.0, 5e-3,
                            "even"))
    got = init_beam(0, 400, 2e-3, 0.0, 5e-3, "even", device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:2].numpy(), want[:2], rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_array_equal(got[2:].numpy(), want[2:])
    again = init_beam(0, 400, 2e-3, 1e-3, 5e-3, "circular", device="cpu")
    assert torch.equal(again, init_beam(0, 400, 2e-3, 1e-3, 5e-3,
                                        "circular", device="cpu"))
    # rect_trackers is ported: from a port key, JAX's beam and JAX's
    # tracker indices (jax.random.choice without replacement)
    from synthpy_tpu_torch import random as trandom

    want, want_idx = jinit(jax.random.PRNGKey(4), 3000, (2e-3, 2e-3), 0.0,
                           5e-3, "rect_trackers", n_trackers=50)
    got, idx = init_beam(trandom.PRNGKey(4), 3000, (2e-3, 2e-3), 0.0, 5e-3,
                         "rect_trackers", device="cpu", n_trackers=50)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got[8].numpy(), np.asarray(want)[8])
    np.testing.assert_array_equal(got[:2].numpy(), np.asarray(want)[:2])
    with pytest.raises(ValueError, match="tracker region"):
        init_beam(trandom.PRNGKey(4), 10, (1e-3, 1e-3), 0.0, 5e-3,
                  "rect_trackers", device="cpu", n_trackers=50,
                  tracker_region=1e-5)


@pytest.mark.parametrize("beam_type,size", [
    ("circular", 2e-3), ("square", 2e-3), ("rectangular", (2e-3, 1e-3)),
    ("linear", 2e-3), ("even", 2e-3)])
def test_beam_from_a_key_draws_jax_stream(beam_type, size):
    """A port key (or a JAX key through convert.key) draws JAX's stream:
    positions to 1e-6 of the largest (the circle's cos / sin), velocities
    to 1e-6 (normals within a few ulp), the rest exactly."""
    from synthpy_tpu_torch import convert
    from synthpy_tpu_torch import random as trandom

    want = np.asarray(jinit(jax.random.PRNGKey(4), 500, size, 1e-3, 5e-3,
                            beam_type))
    for key in (trandom.PRNGKey(4), convert.key(jax.random.PRNGKey(4))):
        got = init_beam(key, 500, size, 1e-3, 5e-3, beam_type,
                        device="cpu").numpy()
        assert got.shape == want.shape
        scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-30)
        assert (np.abs(got - want) <= 1e-6 * scale).all()
    # a torch.Generator still draws PyTorch's stream
    g = torch.Generator().manual_seed(4)
    other = init_beam(g, 500, size, 1e-3, 5e-3, beam_type, device="cpu")
    assert other.shape == want.shape
