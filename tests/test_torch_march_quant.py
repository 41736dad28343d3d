"""Port segment march vs the JAX package on quantised tables (int8, int4
nibble pairs) and on the full-physics channel layout (C = 8: kappa, phase
and the three Faraday channels). Same contract and tolerance as
test_torch_march.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu.tracer.beam import init_beam
from test_torch_march import (EXT, INTEGRATORS, _tier, assert_columns_close,
                              march_both)

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def packs():
    """{name: (jax domain, {K: f32 pack}, (N, 8) state)}."""
    s0 = init_beam(jax.random.PRNGKey(5), 2048, 2.2e-3, 2e-3, EXT,
                   "circular")
    u = jnp.stack([s0[0], s0[1], s0[3], s0[4], s0[5], s0[6], s0[7], s0[8]],
                  axis=1)
    lens = JDomain(2 * EXT, 17).test_lens(ne_0=5e24, LR=1.5e-3)
    full = JDomain(2 * EXT, 17).test_lens(ne_0=1e25, LR=2e-3)
    full.external_Te(50.0 * np.ones(full.dims))
    full.external_Z(2.0 * np.ones(full.dims))
    full.inv_brems = True
    full.phaseshift = True
    full.test_B(Bmax=10.0)
    out = {}
    for name, d in (("lens", lens), ("full", full)):
        out[name] = (d, {K: jz.build_segment_pack_device(
            d, K=K, dtype=jnp.float32) for K in (8, 9)}, u)
    return out


@pytest.mark.parametrize("K", [8, 9])
@pytest.mark.parametrize("weights", ["stage", "slab"])
@pytest.mark.parametrize("integrator", INTEGRATORS)
def test_march_matches_jax_int8(packs, integrator, weights, K):
    jd, by_K, u = packs["lens"]
    want, got = march_both(jd, _tier(by_K[K], "int8"), u, integrator,
                           weights)
    assert_columns_close(got, want)


@pytest.mark.parametrize("weights", ["stage", "slab"])
@pytest.mark.parametrize("integrator", ["rk2s2", "rk2s4"])
def test_march_matches_jax_int4(packs, integrator, weights):
    jd, by_K, u = packs["lens"]
    want, got = march_both(jd, _tier(by_K[8], "int4"), u, integrator,
                           weights)
    assert_columns_close(got, want)


@pytest.mark.parametrize("tier,integrator,weights,K", [
    ("f32", "rk4", "stage", 9),
    ("f32", "rk2s4", "slab", 9),
    ("bf16", "rk2", "slab", 8),
    ("int8", "rk2s2", "stage", 9),
    ("int4", "rk2s4", "slab", 8),
])
def test_march_matches_jax_full_physics(packs, tier, integrator, weights,
                                        K):
    jd, by_K, u = packs["full"]
    want, got = march_both(jd, _tier(by_K[K], tier), u, integrator,
                           weights)
    for c in (5, 6, 7):     # amp, phase and pol all move
        assert np.abs(got[:, c] - np.asarray(u)[:, c]).max() > 0
    assert_columns_close(got, want)
