"""The host side of K5's carried corners (kernels/time_march.py), on the CPU.

The kernel keeps each ray's 8 x C corner values across stages and steps
and reads only the nodes outside its last cell (``time_rhs.cuh``
``trilinear_carried``). ``profiling.CornerWalk`` is a Python copy of that
bookkeeping (the cell, the inside mask, the corners to read) and
``profiling.time_walk_model`` counts the reads along the plain march's
stage points. These tests walk it by hand through every kind of move
(none, one cell along each axis, jumps, leaving and re-entering the box,
NaN, the grid's last node), hold the carried blend (shift, read what the
walk names, blend in the JAX order) to ``ops.interp.trilinear`` bit for
bit, and check the model's counts. The kernel itself is held to
``march_plain`` on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels import time_march
from synthpy_tpu_torch.kernels.profiling import (CORNERS, CornerWalk,
                                                 corners_to_read,
                                                 time_walk_model)
from synthpy_tpu_torch.ops.interp import fma, trilinear

SHAPE = (9, 8, 10)
NAN = float("nan")

# (point, corners read, inside) along one walk on a unit grid at the
# origin: a cell is floor(point), clipped to n - 2
WALK = [
    ((2.5, 3.5, 4.5), 0xFF, True),    # first in-grid point: all 8
    ((2.6, 3.2, 4.9), 0x00, True),    # the same cell
    ((2.6, 3.2, 5.1), 0xAA, True),    # z + 1: the upper z face
    ((2.6, 3.2, 4.1), 0x55, True),    # z - 1: the lower z face
    ((2.6, 4.2, 4.1), 0xCC, True),    # y + 1
    ((2.6, 3.2, 4.1), 0x33, True),    # y - 1
    ((3.6, 3.2, 4.1), 0xF0, True),    # x + 1
    ((2.6, 3.2, 4.1), 0x0F, True),    # x - 1
    ((3.6, 4.2, 5.1), 0xFE, True),    # one along every axis: 7 nodes
    ((3.6, 4.2, 7.1), 0xFF, True),    # a jump of two along z
    ((3.6, 4.2, -0.5), 0x00, False),  # outside: nothing, the carry kept
    ((3.9, 4.9, 7.9), 0x00, True),    # back into the carried cell
    ((3.9, 4.9, 10.5), 0x00, False),  # out through the top
    ((4.1, 4.9, 7.9), 0xF0, True),    # back, one along x from the carry
    ((NAN, 4.9, 7.9), 0x00, False),   # NaN: outside
    ((8.0, 4.9, 7.9), 0xFF, True),    # x = nx - 1: the cell clipped to 7
    ((7.5, 4.9, 7.9), 0x00, True),    # still cell 7
    ((1.0, 1.0, 1.0), 0xFF, True),    # a long jump
]


def test_corner_walk_reads_by_move():
    """One lane through every kind of move: the corners it reads and its
    inside mask at each point."""
    walk = CornerWalk(1, SHAPE, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    for n, (pos, want, inside) in enumerate(WALK):
        need, ins = walk.visit(torch.tensor([pos]))
        assert (int(need[0]), bool(ins[0])) == (want, inside), (n, pos)


def test_corner_walk_lanes_are_independent():
    """Lanes walk on their own: the walk's points spread over lanes that
    start at different steps give each lane its own reads."""
    n = len(WALK)
    walk = CornerWalk(n, SHAPE, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    got = [[] for _ in range(n)]
    for step in range(2 * n):
        # lane l visits WALK[step - l], or a far-off point before its start
        pts = [WALK[step - l][0] if 0 <= step - l < n else (-5.0, 0.0, 0.0)
               for l in range(n)]
        need, _ = walk.visit(torch.tensor(pts))
        for l in range(n):
            if 0 <= step - l < n:
                got[l].append(int(need[l]))
    assert all(g == [w for _, w, _ in WALK] for g in got)


def test_corner_walk_matches_corners_to_read_on_a_scaled_grid():
    """On a grid with an origin and spacing: the cell of each point is
    floor((pos - origin) * inv) in float32, and the reads are
    ``corners_to_read`` of the previous in-grid cell."""
    rng = np.random.default_rng(0)
    o, inv = (-1.0, -0.5, -0.7), (4.0, 5.0, 6.0)
    walk = CornerWalk(64, SHAPE, o, inv)
    key = [(-2, -2, -2)] * 64
    pos = rng.uniform(-0.9, 0.9, (64, 3)).astype(np.float32)
    for _ in range(40):
        pos += rng.normal(0, 0.15, (64, 3)).astype(np.float32)
        need, inside = walk.visit(torch.tensor(pos))
        t = (pos - np.float32(o)) * np.float32(inv)
        for l in range(64):
            ins = bool(((t[l] >= 0) & (t[l] <= np.float32(SHAPE) - 1)).all())
            assert bool(inside[l]) == ins
            if not ins:
                assert int(need[l]) == 0
                continue
            cell = tuple(int(min(np.floor(t[l, a]), SHAPE[a] - 2))
                         for a in range(3))
            assert int(need[l]) == corners_to_read(key[l], cell)
            key[l] = cell


def _shift(c, old, new):
    """The kernel's ``carry_shift`` along z, then y, then x: move the
    carried corner values (8 entries, q order) from cell ``old`` to
    ``new``; the corners read anew are stale."""
    for axis, bit in ((2, 1), (1, 2), (0, 4)):
        d = new[axis] - old[axis]
        if d == 0:
            continue
        for q in range(8):
            if q & bit:
                continue
            lo, hi = c[q], c[q | bit]
            c[q] = hi if d == 1 else lo
            c[q | bit] = lo if d == -1 else hi


@pytest.mark.parametrize("C", [3, 5, 8])
def test_carried_blend_equals_trilinear(C):
    """Random walks of slow and fast lanes, in and out of the box: shifting
    the carried values, reading the corners the walk names and blending as
    the kernel does (fma(w0, c0, w1 c1), then a fused multiply-add a
    corner) gives ``trilinear(contract=True)`` bit for bit."""
    rng = np.random.default_rng(C)
    grid = torch.tensor(rng.normal(size=SHAPE + (C,)) * 30,
                        dtype=torch.float32)
    o, inv = (-1.0, -0.5, -0.7), (4.0, 5.0, 6.0)
    n = 48
    walk = CornerWalk(n, SHAPE, o, inv)
    carry = [[None] * 8 for _ in range(n)]
    key = [(-2, -2, -2)] * n
    pos = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    step = np.where(rng.random(n) < 0.7, 0.05, 0.6).astype(np.float32)
    for _ in range(60):
        pos += (rng.normal(0, 1, (n, 3)) * step[:, None]).astype(np.float32)
        p = torch.tensor(pos)
        need, inside = walk.visit(p)
        want = trilinear(grid, p, o, inv, contract=True)
        t = (p - torch.tensor(o)) * torch.tensor(inv)
        for l in range(n):
            if not inside[l]:
                assert torch.equal(want[l], torch.zeros(C))
                continue
            cell = tuple(int(min(np.floor(float(t[l, a])), SHAPE[a] - 2))
                         for a in range(3))
            _shift(carry[l], key[l], cell)
            for q, (a, b, c) in enumerate(CORNERS):
                if int(need[l]) >> q & 1:
                    carry[l][q] = grid[cell[0] + a, cell[1] + b, cell[2] + c]
            key[l] = cell
            f = torch.clamp(t[l] - torch.tensor(cell, dtype=torch.float32),
                            0.0, 1.0)
            g = 1.0 - f
            w = [(g[0] if a == 0 else f[0]) * (g[1] if b == 0 else f[1])
                 * (g[2] if c == 0 else f[2]) for a, b, c in CORNERS]
            acc = fma(w[0], carry[l][0], w[1] * carry[l][1])
            for q in range(2, 8):
                acc = fma(w[q], carry[l][q], acc)
            assert torch.equal(acc.view(torch.int32),
                               want[l].view(torch.int32)), l


def _lens_grid(C=3, n=12):
    """A smooth (n, n, n, C) field on [-1, 1]^3."""
    x = torch.linspace(-1, 1, n)
    X, Y, Z = torch.meshgrid(x, x, x, indexing="ij")
    base = torch.exp(-(X ** 2 + Y ** 2) * 2) * (1 + 0.1 * Z)
    ch = torch.stack([base * (c + 1) for c in range(C)], -1)
    return ch.contiguous(), (-1.0, -1.0, -1.0), (
        (n - 1) / 2.0, (n - 1) / 2.0, (n - 1) / 2.0)


def test_time_walk_model_counts():
    """Rays standing still read their 8 nodes once; rays outside read
    nothing; a ray crossing the grid along z reads the upper z face at
    each new cell; the counts do not depend on the rays' order, the warp
    shares do."""
    ch, o, inv = _lens_grid()
    zero = torch.zeros_like(ch)
    lay = ChannelLayout(False, False, False)
    n_steps, dt = 5, 0.1
    rows = torch.zeros((64, 9))
    rows[:, 6] = 1.0
    rows[:32, 0:3] = torch.rand(
        32, 3, generator=torch.Generator().manual_seed(0)) * 1.6 - 0.8
    rows[32:, 0] = 3.0                      # outside, moving away
    rows[32:, 3] = 1.0
    m = time_walk_model(rows, zero, o, inv, dt, layout=lay,
                        n_steps=n_steps)
    assert m["rays"] == 64 and m["in_grid_lane_stages"] == 32 * 4 * n_steps
    assert m["node_reads"] == 32 * 8
    assert m["first_loads_per_in_grid_stage"] == 24
    # one ray along z from the bottom face: 11 cells over 2 units
    z = torch.zeros((32, 9))
    z[:, 2] = -1.0
    z[:, 5] = 1.0
    z[:, 6] = 1.0
    m = time_walk_model(z, zero, o, inv, 0.05, layout=lay, n_steps=40)
    # cells 0..10 entered in turn: 8 nodes, then 4 for each of 10 moves
    assert m["node_reads"] == 32 * (8 + 4 * 10)
    # x and y shift only on entering (from the carry's (-2, -2, -2)), z
    # then and at each of the 10 moves
    z_share, y_share, x_share = m["warp_stages_shifting_zyx"]
    assert x_share == y_share and z_share == pytest.approx(11 * y_share)
    # order
    mixed = torch.cat([rows[:32], z])
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(1))
    a = time_walk_model(mixed, ch, o, inv, 0.05, layout=lay, n_steps=40)
    b = time_walk_model(mixed, ch, o, inv, 0.05, layout=lay, n_steps=40,
                        order=perm)
    assert a["node_reads"] == b["node_reads"]
    assert a["warp_stages_reading"] <= b["warp_stages_reading"]


def test_time_walk_model_marches_as_the_plain_version():
    """The model's stage points are the plain march's: the node reads it
    counts come from the same states (a march whose result the model's
    own loop reproduces on the lens)."""
    ch, o, inv = _lens_grid(C=4)
    lay = ChannelLayout(True, False, False)
    rng = np.random.default_rng(3)
    rows = torch.tensor(rng.uniform(-0.8, 0.8, (64, 9)), dtype=torch.float32)
    rows[:, 3:6] *= 2.0
    rows[:, 6] = 1.0
    seen = []
    real = CornerWalk.visit

    def record(self, pos):
        seen.append(pos.clone())
        return real(self, pos)

    CornerWalk.visit = record
    try:
        time_walk_model(rows, ch, o, inv, 0.03, layout=lay, n_steps=6)
    finally:
        CornerWalk.visit = real
    assert len(seen) == 4 * 6
    end = time_march.march_plain(rows, ch, o, inv, 0.03, layout=lay,
                                 n_steps=5)
    # the sixth step's first stage point is the fifth step's result
    assert torch.equal(seen[20], end[:, 0:3])
