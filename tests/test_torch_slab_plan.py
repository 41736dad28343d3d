"""K4's carried corners (``csrc/slab_march.cu``) as the host models them,
on the CPU.

The kernel keeps two planes' corner values in registers, X (plane k) and
Y (plane k + 1), each at its transverse cell: at a new slab X takes Y's
cell and Y is empty; a stage brings the planes it blends to its cell,
reading a plane's four corners where its cell moved and nothing where it
did not. ``profiling.SlabWalk`` is the
host's copy of that carry and ``profiling.slab_walk_model`` counts its
reads along the plain march's stage points (the kernel runs only on a
card, where chip_smoke prints the model beside the first design's 24C
loads a slab). Here the walk is held to a lane-by-lane reference on
random stage points, and the model to hand-counted reads on straight
walks across zero planes: no move, one cell a slab along a and along b
(both signs), a jump, a ray at exactly na - 1, a ray that leaves the box
within a slab and for a whole slab, and substeps 1 and 2.
"""

import numpy as np
import pytest
import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels import profiling as pr

torch.set_num_threads(1)

NA, NB = 12, 10
LAY = ChannelLayout(False, False, False)


def reference_reads(cells, modes):
    """Lane by lane: cells[k][s] the (ia, ib) of stage s of slab k (None
    outside), modes[s] its mode; the nodes read a slab for X and Y (four
    where a plane's carried cell is not the stage's)."""
    x = y = (-2, -2)
    out = []
    for slab in cells:
        x, y = y, (-2, -2)
        nx = ny = 0
        for cell, mode in zip(slab, modes):
            if cell is None:
                continue
            if mode != pr.PLANE1:
                nx += 4 * (x != cell)
                x = cell
            if mode != pr.PLANE0:
                ny += 4 * (y != cell)
                y = cell
        out.append((nx, ny))
    return out


@pytest.mark.parametrize("modes", [(pr.PLANE0, pr.MID, pr.MID, pr.PLANE1),
                                   (pr.LERP,) * 8])
def test_slab_walk_matches_a_lane_by_lane_reference(modes):
    """SlabWalk's reads on random stage points (small moves, jumps, points
    outside, NaN) equal the reference's, lane by lane, slab by slab."""
    rng = np.random.default_rng(len(modes))
    n, slabs = 64, 12
    pos = np.cumsum(rng.choice([0.0, 0.0, 0.4, -0.4, 1.0, 2.5],
                               (slabs * len(modes), n, 2)), axis=0) + 5.3
    pos[rng.random(pos.shape[:2]) < 0.05] = -1.0
    pos[7, 3] = np.nan
    walk = pr.SlabWalk(n, NA, NB, [0.0, 0.0], [1.0, 1.0])
    got = np.zeros((slabs, n, 2), np.int64)
    for k in range(slabs):
        walk.new_slab()
        for s, mode in enumerate(modes):
            u = torch.zeros(n, 8)
            u[:, :2] = torch.tensor(pos[k * len(modes) + s],
                                    dtype=torch.float32)
            nx, ny, _ = walk.visit(u, mode)
            got[k, :, 0] += nx.numpy()
            got[k, :, 1] += ny.numpy()

    def cell(p):
        t = np.float32(p)
        inside = (t >= 0).all() and t[0] <= NA - 1 and t[1] <= NB - 1
        return (min(int(np.floor(t[0])), NA - 2),
                min(int(np.floor(t[1])), NB - 2)) if inside else None

    for lane in range(n):
        cells = [[cell(pos[k * len(modes) + s, lane])
                  for s in range(len(modes))] for k in range(slabs)]
        assert [tuple(v) for v in got[:, lane]] == reference_reads(cells,
                                                                  modes)


def straight(a0, b0, va, vb, substeps=1, n_slabs=6):
    """slab_walk_model of one warp of identical rays from (a0, b0) at
    (va, vb) cells a slab across zero planes (straight lines)."""
    planes = torch.zeros((n_slabs + 1, NA, NB, 3))
    u = torch.zeros(32, 8)
    u[:, 0], u[:, 1] = a0, b0
    u[:, 2], u[:, 3], u[:, 4] = va, vb, 1.0
    return pr.slab_walk_model(u, planes, [0.0, 0.0], [1.0, 1.0], 1.0,
                              layout=LAY, n_slabs=n_slabs,
                              substeps=substeps)


@pytest.mark.parametrize("a0,b0,va,vb,first,steady", [
    (5.25, 4.25, 0.0, 0.0, 8, 4),      # no move: plane k + 1 once a slab
    (11.0, 4.25, 0.0, 0.0, 8, 4),      # exactly na - 1: cell na - 2
    (2.25, 4.25, 1.0, 0.0, 12, 8),     # +1 along a: the stage-4 move reads 4
    (8.75, 4.25, -1.0, 0.0, 12, 8),    # -1 along a
    (5.25, 1.25, 0.0, 1.0, 12, 8),     # +1 along b
    (5.25, 7.75, 0.0, -1.0, 12, 8),    # -1 along b
    (0.25, 4.25, 3.0, 0.0, 16, 12),    # three a slab: X and Y both move
])
def test_slab_walk_model_on_straight_walks(a0, b0, va, vb, first, steady):
    """Nodes read a slab, counted by hand from the stage points (k1 at u,
    k2 and k3 half a slab on, k4 a slab on): the first slab reads X and Y
    anew; then X is the last slab's Y."""
    n_slabs = 3 if va == 3.0 else 6
    m = straight(a0, b0, va, vb, n_slabs=n_slabs)
    assert m["in_grid_lane_slabs"] == 32 * n_slabs
    assert m["node_reads"] == 32 * (first + (n_slabs - 1) * steady)
    assert m["first_loads_per_in_grid_slab"] == 24 * 3
    assert m["warp_slabs_beyond_plane_k1"] == (1 / n_slabs if steady == 4
                                              else 1.0)


def test_slab_walk_model_at_the_box_edge():
    """A ray at exactly na - 1 is inside (its cell clamped to na - 2); one
    a hair beyond it is outside and reads nothing."""
    inside = straight(11.0, 9.0, 0.0, 0.0)
    assert inside["in_grid_lane_slabs"] == 32 * 6
    out = straight(float(np.nextafter(np.float32(11.0), np.float32(12.0))),
                   4.25, 0.0, 0.0)
    assert out["in_grid_lane_slabs"] == 0 and out["node_reads"] == 0


def test_slab_walk_keeps_the_carry_outside_within_a_slab():
    """Outside within a slab a stage reads nothing and keeps the carry; a
    whole slab outside empties it (the next slab's X is that slab's Y)."""
    walk = pr.SlabWalk(1, NA, NB, [0.0, 0.0], [1.0, 1.0])
    u_in = torch.zeros(1, 8)
    u_in[0, :2] = torch.tensor([5.5, 5.5])
    u_out = u_in.clone()
    u_out[0, 0] = -3.0
    modes = (pr.PLANE0, pr.MID, pr.MID, pr.PLANE1)

    def slab(points):
        walk.new_slab()
        n = 0
        for p, mode in zip(points, modes):
            nx, ny, _ = walk.visit(p, mode)
            n += int(nx + ny)
        return n

    assert slab([u_in] * 4) == 8
    assert slab([u_in, u_out, u_out, u_in]) == 4
    assert slab([u_out, u_in, u_out, u_out]) == 4
    assert slab([u_out] * 4) == 0
    assert slab([u_in] * 4) == 8


@pytest.mark.parametrize("va,first,steady", [(0.0, 8, 4), (1.0, 16, 12)])
def test_slab_walk_model_with_two_substeps(va, first, steady):
    """Two substeps a slab: every stage blends both planes (LERP), so Y is
    read at the first stage of a slab and carried through both RK4 steps
    of it; one cell a slab is crossed at the second substep's midpoint,
    where both planes read their four corners anew."""
    m = straight(5.25 if va == 0 else 2.25, 4.25, va, 0.0, substeps=2)
    assert m["substeps"] == 2
    assert m["first_loads_per_slab_inside"] == 64 * 3
    assert m["node_reads"] == 32 * (first + (m["slabs"] - 1) * steady)
