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


# -- K8's tile buckets (tiles_plain: the plain form of deposit.cu's sort) ---

def _tiles_of_each_ray(x, y, xc, yc, tile):
    """{ray: set of tiles} by the deposit's rule, one ray at a time: the
    tiles of its four corner nodes, none for a ray outside with finite
    positions, index 0 along a NaN coordinate."""
    nx, ny = xc.size, yc.size
    nty = -(-ny // tile)
    out = {}
    for i in range(x.size):
        tx = np.float32((x[i] - xc[0]) / np.float32(xc[1] - xc[0]))
        ty = np.float32((y[i] - yc[0]) / np.float32(yc[1] - yc[0]))
        inside = (np.isfinite(tx) and np.isfinite(ty) and 0 <= tx <= nx - 1
                  and 0 <= ty <= ny - 1)
        if not inside and not (np.isnan(tx) or np.isnan(ty)):
            continue
        ix = 0 if np.isnan(tx) else int(min(max(np.floor(tx), 0), nx - 2))
        iy = 0 if np.isnan(ty) else int(min(max(np.floor(ty), 0), ny - 2))
        out[i] = {((ix + a) // tile) * nty + (iy + b) // tile
                  for a in (0, 1) for b in (0, 1)}
    return out


@pytest.mark.parametrize("tile", [2, 4, 32])
@pytest.mark.parametrize("grid", [(33, 17), (2, 2), (1000, 3), (70, 45)],
                         ids=str)
def test_tiles_plain_puts_each_ray_once_in_each_tile_it_touches(grid, tile):
    """Every ray that adds anything lands once in each tile its four
    corners touch (rays on a tile's last row and column, at n - 1 and
    outside included), and nowhere else."""
    nx, ny = grid
    rng = np.random.default_rng(nx * ny + tile)
    xc = np.linspace(-1, 1, nx, dtype=np.float32)
    yc = np.linspace(-0.5, 0.75, ny, dtype=np.float32)
    n = 3000
    x = rng.uniform(-1.2, 1.2, n).astype(np.float32)
    y = rng.uniform(-0.7, 0.9, n).astype(np.float32)
    x[:40] = xc[rng.integers(0, nx, 40)]     # on nodes, tile edges among them
    y[:40] = yc[rng.integers(0, ny, 40)]
    x[40:60], y[60:80] = xc[-1], yc[-1]      # at n - 1
    x[80], y[81] = np.nan, np.nan
    x[82], y[82] = np.nan, np.float32(0.75)
    x[83], y[84] = np.inf, -np.inf
    rays, tiles = kdeposit.tiles_plain(
        *(torch.from_numpy(a) for a in (x, y, xc, yc)), tile=tile)
    got = {}
    for r, t in zip(rays.tolist(), tiles.tolist()):
        assert t not in got.setdefault(r, set())
        got[r].add(t)
    assert got == _tiles_of_each_ray(x, y, xc, yc, tile)


def test_tiles_plain_nan_rays_go_to_index_zero():
    """A NaN x puts the ray in the tiles of corner index 0 along x; a NaN y
    likewise along y (the JAX program's float-to-int of NaN)."""
    xc = np.linspace(0, 99, 100, dtype=np.float32)
    x = np.array([np.nan, 50.5, np.nan], np.float32)
    y = np.array([70.5, np.nan, np.nan], np.float32)
    rays, tiles = kdeposit.tiles_plain(
        *(torch.from_numpy(a) for a in (x, y, xc, xc)), tile=32)
    by = {}
    for r, t in zip(rays.tolist(), tiles.tolist()):
        by.setdefault(r, set()).add(t)
    nty = 4
    assert by[0] == {0 * nty + 2}
    assert by[1] == {1 * nty + 0}
    assert by[2] == {0}


def test_tiled_walk_equals_the_deposit():
    """A walk of the kernel's design on the CPU: the rays bucketed by
    tiles_plain, each bucket cut into items of at most 500 entries, each
    item adding only the corners its tile owns into a partial tile, the
    partials summed in item order; equal to deposit_plain's sums within
    float32 summation order, NaN nodes the same."""
    x, y = _rays(n=6000)
    xc, yc = _grid()
    rng = np.random.default_rng(9)
    vals = torch.from_numpy(rng.normal(size=(x.size, 2)).astype(np.float32))
    t = [torch.from_numpy(a) for a in (x, y, xc, yc)]
    want = kdeposit.deposit_plain(t[0], t[1], vals, t[2], t[3],
                                  return_acc=True)
    tile = 8
    rays, tiles = kdeposit.tiles_plain(*t, tile=tile)
    nx, ny = xc.size, yc.size
    nty = -(-ny // tile)
    acc = torch.zeros((nx, ny, 3))
    for k in torch.unique(tiles).tolist():
        mine = rays[tiles == k]
        x0, y0 = (k // nty) * tile, (k % nty) * tile
        for i0 in range(0, mine.numel(), 500):
            r = mine[i0:i0 + 500]
            part = kdeposit.deposit_plain(t[0][r], t[1][r], vals[r], t[2],
                                          t[3], return_acc=True)
            own = torch.zeros((nx, ny, 1), dtype=torch.bool)
            own[x0:x0 + tile, y0:y0 + tile] = True
            acc += torch.where(own, part, torch.zeros_like(part))
    assert torch.equal(acc.isnan(), want.isnan())
    scale = want.nan_to_num(0).abs().amax((0, 1))
    assert bool(((acc - want).nan_to_num(0).abs().amax((0, 1))
                 <= 1e-5 * scale).all())


@pytest.mark.parametrize("node", [10, 32, 63], ids=["one_node", "tile_corner",
                                                   "last_node"])
@pytest.mark.parametrize("V", [1, 2])
def test_inexact_pile_within_1e5_of_float64(V, node):
    """6,000 rays with random values in [0, 1) at random positions within
    0.4 of one node (the piles K8's card tests hold; node 32 is the corner of four
    32-node tiles, 63 the last node): the plain version's sums within 1e-5
    of each channel's largest from the float64 deposit of the same float32
    inputs, the reference the card's kernel is held to on such piles."""
    rng = np.random.default_rng(10 + node)
    n = 6000
    grid = torch.linspace(-3.0, 3.0, 64)
    lo, hi = max(node - 0.4, 0.0), min(node + 0.4, 63.0)
    d = float(grid[1] - grid[0])
    x, y = (torch.from_numpy((-3.0 + rng.uniform(lo, hi, n) * d)
                             .astype(np.float32)) for _ in range(2))
    vals = torch.from_numpy(rng.uniform(0.0, 1.0, (n, V)).astype(np.float32))
    want = kdeposit.deposit_plain(x.double(), y.double(), vals.double(),
                                  grid.double(), grid.double(),
                                  return_acc=True)
    got = kdeposit.deposit(x, y, vals, grid, grid, return_acc=True)
    err = (got.double() - want).abs().amax((0, 1)) / want.abs().amax((0, 1))
    assert bool((err <= 1e-5).all()), err
