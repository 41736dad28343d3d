"""The port's multi-slice wave propagation (``ops.multislice``) against the
JAX package, on a small plasma lens.

Tolerances. Each slab is a phase screen and a pocketfft (here) or XLA
(JAX) FFT pair, whose roundings differ: after ~30 slabs the exit field is
held to 1e-4 of its largest |value| (each pass adds ~1e-6 relative). The
phases the JAX package rounds to float32 (f32(k) dz of the screens, the
transfer function's kz dz, the removed carrier's ~6e4 rad argument) are
rounded at the same places, so the complex field ``U`` is compared, not
only |U|^2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.ops import multislice as jms
from synthpy_tpu_torch.ops import multislice as tms

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)


def _lens(dims=(24, 20, 33), ne_0=2e25):
    d = JDomain((1e-2, 1e-2, 1e-2), dims).test_lens(ne_0=ne_0, LR=2e-3)
    ne = np.array(d.ne)
    coords = [np.array(c) for c in (d.x, d.y, d.z)]
    return ne, coords


def _close_rel(got, want, tol=1e-4):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("remove_carrier", [True, False])
@pytest.mark.parametrize("probe", ["z", "x"])
def test_multislice_matches_jax(probe, remove_carrier):
    ne, coords = _lens()
    want = jms.multislice_propagate(
        jnp.asarray(ne), tuple(jnp.asarray(c) for c in coords), 1064e-9,
        probing_direction=probe, remove_carrier=remove_carrier)
    got = tms.multislice_propagate(
        torch.from_numpy(ne), tuple(torch.from_numpy(c) for c in coords),
        1064e-9, probing_direction=probe, remove_carrier=remove_carrier)
    assert got.dtype == torch.complex64
    _close_rel(got, want)
    _close_rel(tms.exit_intensity(got), jms.exit_intensity(want))
    # the wrapped phase, where the field is not near a zero
    w = np.asarray(want)
    keep = np.abs(w) > 0.1 * np.abs(w).max()
    dphi = np.angle(np.exp(1j * (tms.exit_phase(got).numpy()
                                 - np.asarray(jms.exit_phase(want)))))
    assert np.abs(dphi[keep]).max() < 1e-3


def test_multislice_input_field():
    ne, coords = _lens(dims=(16, 16, 17))
    rng = np.random.default_rng(0)
    U0 = np.exp(1j * rng.uniform(0, 0.5, (16, 16))).astype(np.complex64)
    want = jms.multislice_propagate(jnp.asarray(ne),
                                    tuple(jnp.asarray(c) for c in coords),
                                    input_field=jnp.asarray(U0))
    got = tms.multislice_propagate(torch.from_numpy(ne),
                                   tuple(torch.from_numpy(c) for c in coords),
                                   input_field=torch.from_numpy(U0))
    _close_rel(got, want)


def test_angular_spectrum_step_matches_jax():
    rng = np.random.default_rng(2)
    U = (rng.normal(size=(20, 24))
         + 1j * rng.normal(size=(20, 24))).astype(np.complex64)
    c = jnp.linspace(-5e-3, 5e-3, 33)
    d = c[1] - c[0]
    want = jms.angular_spectrum_step(jnp.asarray(U), d, 1064e-9, d, d)
    tc = torch.linspace(-5e-3, 5e-3, 33)
    td = tc[1] - tc[0]
    got = tms.angular_spectrum_step(torch.from_numpy(U), td, 1064e-9, td, td)
    _close_rel(got, want, 2e-5)


def test_vacuum_is_identity():
    """An empty volume leaves the unit plane wave unchanged once the
    carrier is removed (the JAX package's tests/test_multislice.py:27)."""
    ne, coords = _lens(dims=(16, 16, 17), ne_0=0.0)
    U = tms.multislice_propagate(torch.from_numpy(ne),
                                 tuple(torch.from_numpy(c) for c in coords))
    np.testing.assert_allclose(U.numpy(), np.ones((16, 16)), atol=1e-5)
