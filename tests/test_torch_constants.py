"""Port constants vs the JAX package: forward values and gradients.

Grids include vacuum (ne = 0) and overdense cells (ne > n_c), where the
double-``where`` keeps both gradients finite. Tolerance rtol 1e-6: single
float32 formulas, a few ulps apart between XLA and PyTorch on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import constants as jc
from synthpy_tpu_torch import constants as tc

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

LWL = 1064e-9
OMEGA = tc.omega_from_lwl(LWL)
NC = tc.critical_density(OMEGA)


def _grids():
    rng = np.random.default_rng(7)
    ne = (rng.random(64) * 2.0 * NC).astype(np.float32)
    ne[:4] = (0.0, NC * 0.999, NC * 1.001, 3.0 * NC)
    Te = (1.0 + rng.random(64) * 500.0).astype(np.float32)
    Z = (1.0 + rng.random(64) * 9.0).astype(np.float32)
    return ne, Te, Z


def test_scalar_helpers_match():
    assert tc.omega_from_lwl(LWL) == float(jc.omega_from_lwl(LWL))
    assert tc.critical_density(OMEGA) == float(jc.critical_density(OMEGA))
    assert tc.verdet_constant(LWL) == float(jc.verdet_constant(LWL))
    for name in ("C", "E_CHARGE", "N_C_COEFF", "OMEGA_PE_COEFF",
                 "V_THE_COEFF", "L_QUANTUM_COEFF", "KAPPA_COEFF",
                 "VERDET_COEFF", "DEFAULT_LWL"):
        assert getattr(tc, name) == getattr(jc, name), name


FORWARD = {
    "omega_pe": (lambda m, ne, Te, Z: m.omega_pe(ne * 1e-6)),
    "v_the": (lambda m, ne, Te, Z: m.v_the(Te)),
    "n_refrac": (lambda m, ne, Te, Z: m.n_refrac(ne, OMEGA)),
    "coulomb_log": (lambda m, ne, Te, Z: m.coulomb_log(ne * 1e-6, Te, Z,
                                                        OMEGA)),
    "kappa": (lambda m, ne, Te, Z: m.kappa(ne, Te, Z, OMEGA)),
}


@pytest.mark.parametrize("name", sorted(FORWARD))
def test_forward_matches_jax(name):
    ne, Te, Z = _grids()
    f = FORWARD[name]
    want = np.asarray(f(jc, jnp.asarray(ne), jnp.asarray(Te),
                        jnp.asarray(Z)))
    got = f(tc, *(torch.from_numpy(a) for a in (ne, Te, Z))).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("name,arg", [("n_refrac", 0), ("kappa", 0),
                                      ("kappa", 1), ("kappa", 2)])
def test_gradients_match_jax(name, arg):
    ne, Te, Z = _grids()
    f = FORWARD[name]

    def jfun(*xs):
        return jnp.sum(f(jc, *xs))

    want = np.asarray(jax.grad(jfun, argnums=arg)(
        jnp.asarray(ne), jnp.asarray(Te), jnp.asarray(Z)))
    xs = [torch.from_numpy(a.copy()).requires_grad_(i == arg)
          for i, a in enumerate((ne, Te, Z))]
    (g,) = torch.autograd.grad(f(tc, *xs).sum(), xs[arg])
    got = g.numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-6 * np.abs(want[fin]).max())
    if name == "n_refrac":
        # finite at vacuum and constant (zero gradient) beyond critical
        assert np.isfinite(got).all()
        assert (got[ne > NC] == 0).all()
