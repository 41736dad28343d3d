"""Port adaptive DP5(4) tracer (kernel K6's plain version) vs the JAX
package, on the cases of tests/test_adaptive.py and a few more.

The same domain and the same JAX-drawn rays go through JAX
``solve_adaptive`` / ``trace_rk45`` and the port's. The accepted and
rejected step counts must be equal; exit columns within atol = 1e-6 *
max|column| with the same NaN pattern (the port fuses the multiply-adds
XLA's CPU compiler fuses: observed bit-equal on the capped cases).

The port sums the error norm in float64 where JAX sums in float32, so
where the controller and not the half-cell cap sets the step, the two
step sizes part in the last place; over a whole trace at a tight
tolerance that can move the last step across t_end (one more accepted
step). The "rejections" case therefore stops at max_steps = 54, after 11
rejected steps, where both agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.constants import C
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields.domain import build_pack as jbuild_pack
from synthpy_tpu.fields.domain import layout_of
from synthpy_tpu.tracer import init_beam
from synthpy_tpu.tracer.adaptive import solve_adaptive as jsolve_adaptive
from synthpy_tpu.tracer.adaptive import trace_rk45 as jtrace_rk45
from synthpy_tpu_torch import convert
from synthpy_tpu_torch.tracer import adaptive as tadaptive

torch.set_num_threads(1)

EXT = 5e-3
TOL = 1e-6


def assert_columns_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    for c in range(want.shape[0]):
        scale = np.nanmax(np.abs(want[c])) if want.size else 0.0
        np.testing.assert_allclose(got[c], want[c], rtol=0,
                                   atol=tol * max(scale, 1e-30),
                                   err_msg=f"column {c}")


def filament(n=41):
    """A strong lens confined to |z| < ~0.4 mm (tests/test_adaptive.py's
    local-cap case)."""
    d = JDomain(2 * EXT, n)
    x = np.asarray(d.x)[:, None, None]
    y = np.asarray(d.y)[None, :, None]
    z = np.asarray(d.z)[None, None, :]
    return d.external_ne(5e24 * np.exp(-(x**2 + y**2) / 1.5e-3**2
                                       - z**2 / 0.4e-3**2))


def physics(n=25):
    d = JDomain(2 * EXT, n, inv_brems=True, phaseshift=True)
    d.test_lens(ne_0=1e25, LR=2e-3)
    rng = np.random.default_rng(4)
    d.external_Te(50.0 + 10.0 * rng.random(d.dims))
    d.external_Z(2.0 * np.ones(d.dims))
    return d.test_B(Bmax=10.0)


def phase_lens(n=33):
    d = JDomain(2 * EXT, n).test_lens(ne_0=5e24, LR=1.5e-3)
    d.phaseshift = True
    return d


# (name, domain, rays (seed, N, radius, offset), solve_adaptive kwargs)
CASES = {
    "null": (lambda: JDomain(2 * EXT, 21).test_null(), (0, 32, 1e-3, 0.0),
             {}),
    "oracle_lens": (lambda: JDomain(2 * EXT, 41).test_lens(5e24, 1.5e-3),
                    (1, 24, 1.5e-3, 0.0), dict(rtol=1e-6)),
    "three_solvers": (phase_lens, (2, 32, 1.5e-3, 1e-3), dict(rtol=1e-7)),
    "filament_global": (filament, (60, 64, 1.5e-3, 0.0),
                        dict(local_cap=False)),
    "filament_local": (filament, (60, 64, 1.5e-3, 0.0),
                       dict(local_cap=True)),
    "physics": (physics, (7, 256, 2e-3, 1e-3), {}),
    "rejections": (lambda: JDomain(2 * EXT, 21).test_lens(5e24, 1.5e-3),
                   (8, 64, 1.5e-3, 0.0),
                   dict(rtol=1e-9, atol=1e-8, max_steps=54)),
    "max_steps": (filament, (9, 64, 1.5e-3, 0.0), dict(max_steps=10)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_adaptive_matches_jax(case):
    make, (seed, n, radius, offset), kw = CASES[case]
    jd = make()
    s0 = init_beam(jax.random.PRNGKey(seed), n, radius, offset, EXT,
                   "circular")
    want, steps_j = jsolve_adaptive(s0, jd, return_E=True, return_steps=True,
                                    **kw)
    got, steps_t = tadaptive.solve_adaptive(
        convert.tensor(s0, "cpu"), convert.domain(jd, "cpu"), return_E=True,
        return_steps=True, **kw)
    assert steps_t == steps_j
    if case == "rejections":
        assert steps_j == (43, 11)
    if case == "max_steps":
        assert sum(steps_j) == 10
    assert_columns_close(got.sf.numpy(), want.sf)
    assert_columns_close(got.rf.numpy(), want.rf, tol=2 * TOL)
    phase = np.abs(np.asarray(want.sf)[7]).max()
    np.testing.assert_allclose(got.Jf.numpy(), np.asarray(want.Jf), rtol=0,
                               atol=2 * TOL * max(phase, 1.0))


def test_vacuum_strides_cells_like_jax():
    """With a_max = 0 the half-cell kink cap is lifted (tests/test_adaptive
    .py's vacuum case), through trace_rk45 on a carried pack."""
    jd = JDomain(2 * EXT, 21).test_null()
    jp = jbuild_pack(jd)
    tp = convert.trace_pack(jp, "cpu")
    s0 = init_beam(jax.random.PRNGKey(0), 32, 1e-3, 0.0, EXT, "circular")
    t_end = jnp.asarray(np.sqrt(8.0) * EXT / C, jnp.float32)
    sf_j, acc_j, rej_j = jtrace_rk45(jnp.asarray(s0).T, jp.channels,
                                     jp.origin, jp.inv_spacing, t_end,
                                     layout=layout_of(jd))
    sf_t, acc_t, rej_t = tadaptive.trace_rk45(
        convert.tensor(s0, "cpu").T, tp.channels, tp.origin, tp.inv_spacing,
        float(t_end), layout=layout_of(jd))
    assert (acc_t, rej_t) == (int(acc_j), int(rej_j))
    assert acc_t <= 8
    assert_columns_close(sf_t.numpy().T, np.asarray(sf_j).T)
    import synthpy_tpu_torch
    assert synthpy_tpu_torch.solve_adaptive is tadaptive.solve_adaptive


def test_empty_bundle_rejects_every_step_like_jax():
    """No rays: the error norm is 0/0 = NaN, so the controller rejects
    every step up to the budget and returns the empty state."""
    jd = JDomain(2 * EXT, 21).test_lens(5e24, 1.5e-3)
    jp = jbuild_pack(jd)
    tp = convert.trace_pack(jp, "cpu")
    t_end = jnp.asarray(np.sqrt(8.0) * EXT / C, jnp.float32)
    rows = np.zeros((0, 9), np.float32)
    sf_j, acc_j, rej_j = jtrace_rk45(jnp.asarray(rows), jp.channels,
                                     jp.origin, jp.inv_spacing, t_end,
                                     layout=layout_of(jd), max_steps=20)
    sf_t, acc_t, rej_t = tadaptive.trace_rk45(
        torch.from_numpy(rows), tp.channels, tp.origin, tp.inv_spacing,
        float(t_end), layout=layout_of(jd), max_steps=20)
    assert (acc_t, rej_t) == (int(acc_j), int(rej_j)) == (0, 20)
    assert tuple(sf_t.shape) == tuple(sf_j.shape) == (0, 9)
