"""The port's cloud-in-cell deposit (``ops.histogram.deposit_cic``, kernel
K8's plain version on the CPU) against the JAX package's ``deposit_cic``.

Tolerance: the deposits are float32 scatter-adds whose summation order
differs between XLA and ``index_add_``, so a node's weighted sum moves by a
few float32 ulps of the sum of its (up to a few hundred) contributions:
nodes are held to 2e-6 of the largest |value| plus 1e-5 relative. Which
nodes are NaN (a NaN ray position spreads NaN to its four corners in the
JAX program) and which are exactly 0 (no ray) must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.ops import histogram as jhist
from synthpy_tpu_torch.kernels import deposit as kdeposit
from synthpy_tpu_torch.ops import histogram as thist

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)


def _rays(n=6000, seed=0, nan=True):
    """(x, y) positions over a grid of [-1, 1] x [-0.5, 0.75]: most inside,
    some outside, some exactly on nodes and edges, a few NaN and inf."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.2, 1.2, n).astype(np.float32)
    y = rng.uniform(-0.7, 0.9, n).astype(np.float32)
    x[:40] = np.linspace(-1, 1, 33, dtype=np.float32)[rng.integers(0, 33, 40)]
    y[:20] = np.float32(0.75)
    y[20:40] = np.float32(-0.5)
    x[40] = np.float32(1.0)
    y[40] = np.float32(0.75)
    if nan:
        x[50], y[51] = np.nan, np.nan
        x[52], y[53] = np.inf, -np.inf
    return x, y


def _grid():
    return (np.linspace(-1, 1, 33, dtype=np.float32),
            np.linspace(-0.5, 0.75, 17, dtype=np.float32))


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    for part in ((np.real, np.imag) if np.iscomplexobj(want) else (np.real,)):
        g, w = part(got), part(want)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_array_equal(g == 0, w == 0)
        scale = np.nanmax(np.abs(w))
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=2e-6 * scale,
                                   equal_nan=True)


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan_rays"])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_deposit_cic_matches_jax(kind, nan):
    x, y = _rays(nan=nan)
    xc, yc = _grid()
    rng = np.random.default_rng(1)
    w = rng.normal(size=x.shape).astype(np.float32)
    if kind == "complex":
        w = (w + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    want = jhist.deposit_cic(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                             jnp.asarray(xc), jnp.asarray(yc))
    got = thist.deposit_cic(*(torch.from_numpy(a) for a in (x, y, w, xc,
                                                             yc)))
    assert got.dtype == (torch.complex64 if kind == "complex"
                         else torch.float32)
    _close(got, want)
    if nan:
        assert np.isnan(np.asarray(want)).any()


def test_deposit_cic_edges_and_outside():
    """Rays exactly on the last node (t = n - 1) are inside and land on the
    corner node with fraction 1; rays just outside deposit nothing."""
    xc, yc = _grid()
    x = np.array([1.0, -1.0, 1.001, -1.001, 0.0], np.float32)
    y = np.array([0.75, -0.5, 0.0, 0.0, 0.751], np.float32)
    w = np.array([2.0, 3.0, 5.0, 7.0, 11.0], np.float32)
    want = np.asarray(jhist.deposit_cic(*(jnp.asarray(a)
                                          for a in (x, y, w, xc, yc))))
    got = thist.deposit_cic(*(torch.from_numpy(a)
                              for a in (x, y, w, xc, yc))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[32, 16] == 2.0 and got[0, 0] == 3.0
    assert np.count_nonzero(got) == 2


def test_fused_channels_equal_separate_deposits():
    """Two values in one deposit (one pass, one weight channel, as
    ``fresnel.propagate`` deposits amplitude and phase) equal a deposit of
    each value."""
    x, y = _rays()
    xc, yc = _grid()
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.uniform(0, 1, x.shape).astype(np.float32))
    p = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    t = [torch.from_numpy(v) for v in (x, y, xc, yc)]
    g = kdeposit.deposit(t[0], t[1], torch.stack([a, p], 1), t[2], t[3])
    for c, v in enumerate((a, p)):
        want = thist.deposit_cic(t[0], t[1], v, t[2], t[3])
        np.testing.assert_allclose(g[..., c].numpy(), want.numpy(),
                                   rtol=1e-6, atol=1e-7, equal_nan=True)
        np.testing.assert_array_equal(torch.isnan(g[..., c]).numpy(),
                                      torch.isnan(want).numpy())


def test_deposit_reproduces_a_smooth_field():
    """A dense bundle sampling a smooth field deposits back to it (the
    JAX package's tests/test_ops.py:122 check, on the port)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, 200_000).astype(np.float32)
    y = rng.uniform(-1, 1, 200_000).astype(np.float32)
    f = np.sin(2 * x) * np.cos(3 * y)
    c = np.linspace(-1, 1, 21, dtype=np.float32)
    g = thist.deposit_cic(*(torch.from_numpy(v) for v in (x, y, f, c, c)))
    X, Y = np.meshgrid(c, c, indexing="ij")
    np.testing.assert_allclose(g.numpy()[2:-2, 2:-2],
                               (np.sin(2 * X) * np.cos(3 * Y))[2:-2, 2:-2],
                               atol=0.02)


def test_deposit_takes_one_or_two_channels():
    """The wrapper takes (N, V) values for V = 1 or 2 on every device, and
    refuses more channels on the CPU as on the card."""
    x, y = _rays(n=3000, nan=False)
    xc, yc = _grid()
    rng = np.random.default_rng(4)
    vals = torch.from_numpy(rng.normal(size=(x.size, 3)).astype(np.float32))
    t = [torch.from_numpy(v) for v in (x, y, xc, yc)]
    assert kdeposit.deposit(t[0], t[1], vals[:, :1], t[2], t[3]).shape == (
        33, 17, 1)
    assert kdeposit.deposit(t[0], t[1], vals[:, :2], t[2], t[3]).shape == (
        33, 17, 2)
    with pytest.raises(ValueError, match="1-2 channels"):
        kdeposit.deposit(t[0], t[1], vals, t[2], t[3])
