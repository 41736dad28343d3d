"""Port segment march (kernel K1's plain version) vs the JAX package, on
float tables.

The same (N, 8) state and the same pack (built by JAX, carried across) go
through JAX ``trace_zscan_segments`` and the port's. Tolerance per exit
column: atol = 2e-6 * max|column| (float order differs: XLA folds
constants and fuses; observed <= 3e-7 at these sizes), with identical
NaN patterns. The rk2s2-on-stride-2 == rk2s4-on-full identity must hold
bit for bit inside the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields import layout_of
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu.tracer.beam import init_beam
from synthpy_tpu_torch import convert
from synthpy_tpu_torch.tracer import zscan as tz

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
TOL = 2e-6
INTEGRATORS = ("rk4", "rk2", "rk2s2", "rk2s4")


@pytest.fixture(scope="module")
def lens():
    """JAX lens domain, its f32 packs at K = 8 and 9, and an (N, 8) state."""
    jd = JDomain(2 * EXT, 17).test_lens(ne_0=5e24, LR=1.5e-3)
    s0 = init_beam(jax.random.PRNGKey(3), 2048, 2.2e-3, 2e-3, EXT,
                   "circular")
    u = jnp.stack([s0[0], s0[1], s0[3], s0[4], s0[5], s0[6], s0[7], s0[8]],
                  axis=1)
    packs = {K: jz.build_segment_pack_device(jd, K=K, dtype=jnp.float32)
             for K in (8, 9)}
    return jd, packs, u


def _tier(jpack, tier):
    if tier == "bf16":
        return jpack._replace(seg_planes=jpack.seg_planes.astype(
            jnp.bfloat16))
    if tier in ("int8", "int4"):
        return jz.quantize_segment_pack(jpack,
                                        bits=8 if tier == "int8" else 4)
    return jpack


def march_both(jd, jpack, u, integrator, weights):
    """Exit states (jax, port) of one march of ``u`` through ``jpack``."""
    layout = layout_of(jd)
    n_seg = jpack.seg_planes.shape[0]
    want = np.asarray(jz.trace_zscan_segments(
        u, jpack.seg_planes, jpack.origin_ab, jpack.inv_spacing_ab,
        jnp.asarray(jpack.dp, jnp.float32), shape_ab=jpack.shape_ab,
        layout=layout, K=jpack.K, n_seg=n_seg, integrator=integrator,
        weights=weights, seg_scales=jpack.scales, qbits=jpack.qbits))
    tp = convert.segment_pack(jpack, "cpu")
    got = tz.trace_zscan_segments(
        convert.tensor(u, "cpu"), tp.seg_planes, tp.origin_ab,
        tp.inv_spacing_ab, tp.dp, shape_ab=tp.shape_ab, layout=layout,
        K=tp.K, n_seg=n_seg, integrator=integrator, weights=weights,
        seg_scales=tp.scales, qbits=tp.qbits).numpy()
    return want, got


def assert_columns_close(got, want, tol=TOL):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    for c in range(want.shape[1]):
        scale = np.nanmax(np.abs(want[:, c])) if want.size else 0.0
        np.testing.assert_allclose(got[:, c], want[:, c], rtol=0,
                                   atol=tol * max(scale, 1e-30),
                                   err_msg=f"column {c}")


@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("K", [8, 9])
@pytest.mark.parametrize("weights", ["stage", "slab"])
@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_march_matches_jax_float(lens, integrator, weights, K, tier):
    jd, packs, u = lens
    want, got = march_both(jd, _tier(packs[K], tier), u, integrator,
                           weights)
    assert np.abs(got[:, 2] - np.asarray(u)[:, 2]).max() > 0  # deflected
    assert_columns_close(got, want)


@pytest.mark.parametrize("tier", ["f32", "int8", "int4"])
@pytest.mark.parametrize("weights", ["stage", "slab"])
def test_rk2s2_on_stride2_is_rk2s4_bitwise(lens, tier, weights):
    jd, packs, u = lens
    full = convert.segment_pack(_tier(packs[8], tier), "cpu")
    half = tz.decimate_segment_pack(full, 2)
    layout = layout_of(jd)
    uu = convert.tensor(u, "cpu")

    def run(sp, integrator):
        return tz.trace_zscan_segments(
            uu, sp.seg_planes, sp.origin_ab, sp.inv_spacing_ab, sp.dp,
            shape_ab=sp.shape_ab, layout=layout, K=sp.K,
            n_seg=sp.seg_planes.shape[0], integrator=integrator,
            weights=weights, seg_scales=sp.scales, qbits=sp.qbits)

    assert torch.equal(run(half, "rk2s2"), run(full, "rk2s4"))


def test_unported_and_invalid_options_raise(lens):
    jd, packs, u = lens
    tp = convert.segment_pack(packs[8], "cpu")
    uu = convert.tensor(u, "cpu")
    kw = dict(shape_ab=tp.shape_ab, layout=layout_of(jd), K=tp.K,
              n_seg=tp.seg_planes.shape[0])
    args = (uu, tp.seg_planes, tp.origin_ab, tp.inv_spacing_ab, tp.dp)
    for bad in ({"substeps": 2}, {"block": 4}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tz.trace_zscan_segments(*args, **kw, **bad)
    with pytest.raises(ValueError):
        tz.trace_zscan_segments(*args, **kw, integrator="rk3")
    q4 = tz.quantize_segment_pack(tp, bits=4)
    with pytest.raises(ValueError, match="even-stride"):
        tz.trace_zscan_segments(uu, q4.seg_planes, q4.origin_ab,
                                q4.inv_spacing_ab, q4.dp, **kw,
                                integrator="rk4", seg_scales=q4.scales,
                                qbits=4)
