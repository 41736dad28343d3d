"""The host side of K13's design (kernels/boris.py), on the CPU.

The kernel carries each proton's 8 x 3 corner values across steps and
reads only the nodes outside its last cell (``profiling.corners_to_read``),
each from the cell's first node at a 32-bit offset
(``profiling.node_offsets``), and takes a step whose midpoint is outside
the grid as its two drifts when its velocity and wdt are finite.
``_shift_corners`` and ``_drift_step`` below are Python copies of the
kernel's shift and drift step, so the tests that use them hold the design,
not the kernel. These tests emulate the node reads on a table's bytes at
an odd element offset, walk the carry through moves along every axis and
jumps, hold the drift step to ``push_plain`` on a zero table, and check
the offsets' refusal and ``walk_model``'s counts against a lane-by-lane
walk. The kernel itself is held to ``push_plain`` on the card
(``tests/test_torch_cuda.py``).
"""

import itertools

import numpy as np
import pytest
import torch

from synthpy_tpu_torch.kernels import boris
from synthpy_tpu_torch.kernels.profiling import (CORNERS, corners_to_read,
                                                 node_offsets, walk_model)
from synthpy_tpu_torch.ops.interp import fma

DTYPES = (torch.float32, torch.bfloat16, torch.int8)
EXT = 5e-3


def _shift_corners(c, old, new):
    """Move the carried corner values ``c`` (8 entries, q order) in place
    from cell ``old`` to ``new`` as the kernel's ``shift`` does (z, then
    y, then x); the corners ``corners_to_read`` names are stale."""
    for axis, bit in ((2, 1), (1, 2), (0, 4)):
        d = new[axis] - old[axis]
        for q in range(8):
            if q & bit:
                continue
            lo, hi = c[q], c[q | bit]
            c[q] = hi if d == 1 else lo
            c[q | bit] = lo if d == -1 else hi


def _drift_step(rows, h):
    """The kernel's step of (N, 6) rows whose midpoint is outside the grid
    (B = 0): x' = fma(h, v, fma(h, v, x)) for x and y, z' = fma(h, vz, z +
    h vz); v unchanged."""
    x, v = rows[:, :3], rows[:, 3:]
    h_t = torch.tensor(h, dtype=torch.float32, device=rows.device)
    pz = x[:, 2:] + h_t * v[:, 2:]
    return torch.cat([fma(h_t, v[:, :2], fma(h_t, v[:, :2], x[:, :2])),
                      fma(h_t, v[:, 2:], pz), v], 1)


def _table_at(dtype, shape, offset, rng):
    """A table of ``shape`` whose first element lies ``offset`` elements
    past the start of its buffer, and the buffer."""
    n = int(np.prod(shape))
    vals = torch.from_numpy(rng.integers(-100, 100, n).astype(np.float32))
    buf = torch.zeros(n + offset + 4, dtype=dtype)
    buf[offset:offset + n] = vals.to(dtype)
    return buf[offset:offset + n].view(shape), buf


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 2, 2, 3), (3, 5, 7, 3),
                                   (4, 4, 5, 3)])
def test_node_reads_on_the_table_bytes(dtype, shape):
    """The kernel's reads of every cell's eight corners, emulated on the
    buffer's bytes: the cell's first node 3 ((i ny + j) nz + k) plus
    ``node_offsets``, three single values a node, for a table at an odd
    element offset into its buffer and every cell up to the table's
    edges: each read lies inside the table's bytes and gives the corner's
    values by direct indexing."""
    offset = 1
    rng = np.random.default_rng(offset)
    tab, buf = _table_at(dtype, shape, offset, rng)
    es = tab.element_size()
    raw = buf.view(torch.uint8).numpy()
    base = tab.data_ptr() - buf.data_ptr()
    nx, ny, nz = shape[:3]
    offs = node_offsets(shape)
    for i, j, k in itertools.product(range(nx - 1), range(ny - 1),
                                     range(nz - 1)):
        first = 3 * ((i * ny + j) * nz + k)
        for q, (a, b, c) in enumerate(CORNERS):
            got = []
            for m in range(3):
                lo = base + (first + offs[q] + m) * es
                assert base <= lo and lo + es <= base + tab.numel() * es
                got += torch.from_numpy(raw[lo:lo + es].copy()).view(
                    dtype).tolist()
            assert got == tab[i + a, j + b, k + c].tolist(), (i, j, k, q)


def test_node_offsets_refuse_planes_too_wide_for_32_bits():
    """3 ny nz + 3 nz + 3 elements must fit an int: the kernel's offsets
    are 32-bit. push and launch raise before any build (the meta device
    stands in for the card)."""
    assert node_offsets((2, 1024, 1024, 3))[-1] == \
        3 * 1024 * 1024 + 3 * 1024 + 3
    wide = torch.empty((2, 30000, 30000, 3), dtype=torch.int8,
                       device="meta")
    rows = torch.zeros((4, 6), device="meta")
    n = boris.KERNEL.launches
    args = (wide, torch.ones(3, device="meta"), [0.0] * 3, [1.0] * 3,
            1e-12, 1e-4, 2)
    with pytest.raises(ValueError, match="32-bit"):
        boris.push(rows, *args)
    with pytest.raises(ValueError, match="32-bit"):
        boris.launch(boris.KERNEL, rows, *args, None)
    assert boris.KERNEL.launches == n


def _corners(vals, cell):
    i, j, k = cell
    return [vals[i + a, j + b, k + c] for a, b, c in CORNERS]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_carried_corners_follow_every_move(seed):
    """A walk of cells with moves of one along x, y, z, two axes and all
    three at once, standing still and jumps: after ``shift_corners`` and
    the reads ``corners_to_read`` names, the carried corners are the
    cell's own. Moves of one read only the side that came in."""
    rng = np.random.default_rng(seed)
    n = 9
    vals = np.arange(n ** 3).reshape(n, n, n)
    old, c = (-2, -2, -2), [None] * 8
    cell = (4, 4, 4)
    for step in range(400):
        need = corners_to_read(old, cell)
        _shift_corners(c, old, cell)
        want = _corners(vals, cell)
        for q in range(8):
            if need >> q & 1:
                c[q] = want[q]
        assert c == want, (step, old, cell)
        moved = [cell[a] - old[a] for a in range(3)]
        if step and all(abs(m) <= 1 for m in moved):
            kept = sum(1 for m in moved if m == 0)
            assert bin(need).count("1") == 8 - 2 ** kept
        old = cell
        if rng.random() < 0.05:
            cell = tuple(int(v) for v in rng.integers(0, n - 1, 3))
        else:
            d = rng.integers(-1, 2, 3)
            cell = tuple(int(min(max(a + b, 0), n - 2))
                         for a, b in zip(cell, d))


def test_corners_to_read_by_move():
    assert corners_to_read((-2, -2, -2), (0, 0, 0)) == 0xFF
    assert corners_to_read((3, 3, 3), (3, 3, 3)) == 0
    assert corners_to_read((3, 3, 3), (3, 3, 4)) == 0xAA   # upper z
    assert corners_to_read((3, 3, 3), (3, 3, 2)) == 0x55
    assert corners_to_read((3, 3, 3), (4, 3, 3)) == 0xF0   # upper x
    assert corners_to_read((3, 3, 3), (3, 2, 3)) == 0x33   # lower y
    assert corners_to_read((3, 3, 3), (4, 4, 4)) == 0xFE
    assert corners_to_read((3, 3, 3), (3, 5, 3)) == 0xFF


def _zero_table(dtype, n=4):
    grid = torch.zeros((n, n, n, 3), dtype=dtype)
    scale = (torch.tensor([0.3, 1.7, 0.05]) if dtype == torch.int8
             else None)
    return grid, scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("wdt", [1e-4, -1e-4, 3.0, -0.0])
def test_drift_step_is_the_full_step_where_B_is_zero(dtype, wdt):
    """On a zero table (every midpoint has B = 0, inside the grid or out)
    the drift step equals push_plain's full step under IEEE comparison,
    step after step, with signed-zero velocity components, either charge
    sign and the int8 scale."""
    grid, scale = _zero_table(dtype)
    rng = np.random.default_rng(5)
    n = 64
    rows = np.zeros((n, 6), np.float32)
    rows[:, :3] = rng.uniform(-2 * EXT, 2 * EXT, (n, 3))
    rows[:, 3:] = rng.normal(0, 3e7, (n, 3))
    for r, comps in enumerate(itertools.product([0.0, -0.0, 2e7], repeat=3)):
        rows[r, 3:] = comps
    rows[30, :3] = [0.0, -0.0, 0.0]
    rows[31, :3] = -0.0
    u = torch.from_numpy(rows)
    o, inv = [-EXT] * 3, [float(np.float32(3 / (2 * EXT)))] * 3
    h = 1e-11
    want, got = u, u
    for _ in range(6):
        want = boris.push_plain(want, grid, scale, o, inv, h, wdt, 1)
        got = _drift_step(got, h)
        assert torch.equal(got, want)
    assert torch.equal(boris.push_plain(u, grid, scale, o, inv, h, wdt, 6),
                       got)


def test_drift_skips_refuses_non_finite_values():
    """Why the kernel takes a non-finite velocity component through the
    full step: there inf * 0 gives NaN, which the drift alone would
    not."""
    v = torch.tensor([[1.0, 2.0, 3.0], [np.inf, 0.0, 1.0], [0.0, np.nan, 1.0],
                      [0.0, 0.0, -np.inf], [-0.0, 0.0, 5.0]])
    grid, scale = _zero_table(torch.float32)
    rows = torch.cat([torch.full((5, 3), 3 * EXT), v], 1)   # outside
    full = boris.push_plain(rows, grid, scale, [-EXT] * 3,
                            [float(np.float32(3 / (2 * EXT)))] * 3, 1e-11,
                            1e-4, 1)
    drift = _drift_step(rows, 1e-11)
    assert full[1:4].isnan().any(dim=1).all()
    # each refused row's NaNs differ between the two steps
    assert bool((full[1:4].isnan() != drift[1:4].isnan()).any(dim=1).all())
    assert torch.equal(full[[0, 4]], drift[[0, 4]])


def _lane_walk(rows, shape, origin, inv, h, n_steps):
    """walk_model's in-grid lane-steps and node reads, lane by lane in
    Python with corners_to_read."""
    in_grid = reads = 0
    o = np.array(origin)
    iv = np.array(inv)
    dims = np.array(shape)
    for r in rows.double().numpy():
        key = (-2, -2, -2)
        for s in range(n_steps):
            t = (r[:3] + (2 * s + 1) * h * r[3:] - o) * iv
            if not ((t >= 0) & (t <= dims - 1)).all():
                continue
            cell = tuple(int(min(max(np.floor(a), 0), n - 2))
                         for a, n in zip(t, shape))
            reads += bin(corners_to_read(key, cell)).count("1")
            key = cell
            in_grid += 1
    return in_grid, reads


def test_walk_model_counts_a_lane_walk():
    """The model's in-grid lane-steps and node reads equal a lane-by-lane
    walk; its sectors lie between one a warp load and one a lane; the
    first design's loads are 24 an in-grid step and this design's fewer."""
    rng = np.random.default_rng(9)
    n = 64
    rows = np.zeros((n, 6), np.float32)
    rows[:, :2] = rng.uniform(-0.8 * EXT, 0.8 * EXT, (n, 2))
    rows[:, 2] = -EXT - 1e-4
    rows[:, 3:5] = rng.uniform(-0.3, 0.3, (n, 2)) * 5e7
    rows[:, 5] = 5e7
    u = torch.from_numpy(rows)
    shape = (9, 9, 9)
    o, inv = [-EXT] * 3, [float(np.float32(8 / (2 * EXT)))] * 3
    h, steps = 6e-12, 40
    m = walk_model(u, shape, o, inv, h, steps, 2, every=1)
    assert (m["in_grid_lane_steps"], m["node_reads"]) == _lane_walk(
        u, shape, o, inv, h, steps)
    assert m["protons"] == n
    for k in ("design", "first"):
        assert 1.0 <= m[f"{k}_sectors_per_warp_load"] <= 32.0
    assert m["loads_per_in_grid_step"] < m["first_loads_per_in_grid_step"]
    assert m["design_sectors_per_warp_step"] < \
        m["first_sectors_per_warp_step"]
    order = torch.randperm(n, generator=torch.Generator().manual_seed(1))
    mo = walk_model(u, shape, o, inv, h, steps, 2, order=order,
                          every=1)
    assert mo["node_reads"] == m["node_reads"]
