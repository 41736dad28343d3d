"""The launch plan of K2's build (``kernels.pack.build_plan``), on the CPU.

``csrc/pack.cu`` ``pack_build`` takes its plan from the host: both passes
stage CB cells of a segment between two barriers, the kept planes in
chunks of KB; the amax pass gives each thread a (plane slot, cell lane)
pair and meets the lanes' maxima in shared memory; the row pass walks
(cell, output block) items by additions. The kernel runs only on a card;
here PyTorch / numpy walks of both passes' loops, as the kernel steps
them, must cover every (cell, kept plane) of a segment exactly once and
give the amax of the values they visit, for K = 64 and 512, every probing
axis, windows with and without halo rows and int4's plane pairs; every
tile must fit its budget and hold the planes it stages; at K = 512 the
plan must be the one the kernel used before the plan (CB = 8 cells, the
same KB, runs and grids); and the wrapper must hand ``pack_build`` the
plan (the "meta" device standing in for the card).
"""

import re

import numpy as np
import pytest
import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels import _build, pack

THREADS = pack.BUILD_THREADS


def old_plan(C, n_seg, K, S, cells, pc, n_sm=132):
    """The plan pack.cu computed itself before: CB = 8 cells, KB kept
    planes as a tile of 8 cells holds, pass A in runs for ~2 waves of 8
    blocks an SM, each thread owning planes t + j * 256."""
    CB = 8
    per_row = 24 * 1024 // 4 // pack.tile_rows(CB, pc)
    KB = (per_row - 9) // S + 1
    KB = 2 if KB < 2 else KB & ~1
    KB = min(KB, K // S + 1, 3 * THREADS)
    n_chunk = (K // S + KB) // KB
    runs = max(1, n_sm * 8 * 2 // (n_chunk * n_seg))
    CR = -(-(-(-cells // runs)) // CB) * CB
    return dict(CB_a=CB, CB_b=CB, KB=KB, n_chunk=n_chunk, CR=CR,
                blocks_a=-(-cells // CR), blocks_b=-(-cells // CB),
                pitch=pack.tile_pitch(KB, S, pc),
                smem_b=pack.tile_bytes(CB, pack.tile_pitch(KB, S, pc), pc)
                + pack.meta_bytes(CB) + 4 * KB * C)


def amax_walk(plan, values):
    """pack.cu amax_pass over one segment's (cells, Ko + 1, C) |values|:
    (the amax its lane-0 threads send, the visits of each (cell, plane))."""
    cells, n_planes, C = values.shape
    L = plan
    visits = np.zeros((cells, n_planes), np.int64)
    amax = np.zeros((n_planes, C), np.float32)
    t = np.arange(THREADS)
    slot, lane = t % L.slots, t // L.slots
    act = lane < L.lanes
    for chunk in range(L.n_chunk):
        k0 = chunk * L.KB
        k1 = min(k0 + L.KB, n_planes)
        for bx in range(L.blocks_a):
            cend = min((bx + 1) * L.CR, cells)
            m = np.zeros((THREADS, pack.AMAX_COLS, C), np.float32)
            for c0 in range(bx * L.CR, cend, L.CB_a):
                ncell = min(L.CB_a, cend - c0)
                i = lane[:, None] + L.lanes * np.arange(
                    -(-L.CB_a // L.lanes))[None, :]
                ok_i = (i < ncell) & act[:, None]
                for j in range(pack.AMAX_COLS):
                    ko = k0 + slot + j * L.slots
                    ok = ok_i & (ko < k1)[:, None]
                    cell = np.where(ok, c0 + i, 0)
                    kk = np.where(ok, ko[:, None], 0)
                    np.add.at(visits, (cell[ok], kk[ok]), 1)
                    v = np.where(ok[..., None], values[cell, kk], 0.0)
                    m[:, j] = np.maximum(m[:, j], v.max(axis=1))
            if L.lanes > 1:
                red = {(lane[x], slot[x]): m[x, 0].copy()
                       for x in range(THREADS) if 1 <= lane[x] < L.lanes}
                for x in range(THREADS):
                    if lane[x] == 0:
                        for ll in range(1, L.lanes):
                            m[x, 0] = np.maximum(m[x, 0], red[(ll, slot[x])])
            for x in range(THREADS):
                if lane[x] != 0:
                    continue
                for j in range(pack.AMAX_COLS):
                    ko = k0 + slot[x] + j * L.slots
                    if ko < k1:
                        amax[ko] = np.maximum(amax[ko], m[x, j])
    return amax, visits


def rows_walk(plan, cells, Ko, int4):
    """pack.cu rows_pass over one segment: the visits of each (cell,
    output block), an output block being a plane or, for int4, the plane
    pair 2q, 2q + 1, as its threads step items (i, q) by additions."""
    L = plan
    n_blk = Ko // 2 + 1 if int4 else Ko + 1
    visits = np.zeros((cells, n_blk), np.int64)
    for bx in range(L.blocks_b):
        c0 = bx * L.CB_b
        ncell = min(L.CB_b, cells - c0)
        for k0 in range(0, Ko + 1, L.KB):
            k1 = min(k0 + L.KB, Ko + 1)
            q0 = k0 // 2 if int4 else k0
            nq = (k1 - k0 + 1) // 2 if int4 else k1 - k0
            di, dq = THREADS // nq, THREADS - (THREADS // nq) * nq
            for t in range(THREADS):
                i, q = t // nq, q0 + t - (t // nq) * nq
                while i < ncell:
                    if q >= q0 + nq:
                        q -= nq
                        i += 1
                        if i >= ncell:
                            break
                    visits[c0 + i, q] += 1
                    i, q = i + di, q + dq
    return visits


PROBES = {"z": True, "x": False, "y": False}


def test_plan_constants_are_the_kernels():
    """BUILD_THREADS and AMAX_COLS are pack.cu's THREADS and AMAX_COLS."""
    src = (_build.CSRC / "pack.cu").read_text()
    assert int(re.search(r"constexpr int THREADS = (\d+);", src).group(1)) \
        == pack.BUILD_THREADS
    assert int(re.search(r"constexpr int AMAX_COLS = (\d+);",
                         src).group(1)) == pack.AMAX_COLS


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("probe", sorted(PROBES))
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("C", [3, 8])
def test_plan_at_k512_is_the_old_plan(probe, S, C, mode):
    """At K = 512 on the bench's 512^3 grid the plan stages 8 cells a
    barrier with the KB, runs and grids the kernel used before; where KB
    is above half a block (every z-probing stride here) each amax thread
    does the work it did (one lane; planes t + j * 256), and below it the
    block's threads form 256 // KB lanes."""
    pc = PROBES[probe]
    plan = pack.build_plan(C, 1, 512, S, 512 * 512, pc, mode)
    old = old_plan(C, 1, 512, S, 512 * 512, pc)
    assert {k: getattr(plan, k) for k in old} == old
    assert plan.CB_a == plan.CB_b == pack.CB_ROWS == 8
    assert plan.lanes == THREADS // plan.slots
    if plan.KB > THREADS // 2:
        assert (plan.lanes, plan.slots) == (1, THREADS)
    else:
        assert plan.slots == plan.KB
    if pc:
        assert plan.lanes == 1
    if pc and S == 1:
        assert (plan.KB, plan.slots) == (513, 256)


# cells of a segment: a whole 36 x 29 field, and windows of it with both
# halo rows (rows 7..13) and with one (rows 30..35), as Window cuts them
WINDOWS = {"whole": 36 * 29, "both_halos": 7 * 29, "one_halo": 6 * 29}


@pytest.mark.parametrize("mode", [0, 2])
@pytest.mark.parametrize("window", sorted(WINDOWS))
@pytest.mark.parametrize("probe", sorted(PROBES))
@pytest.mark.parametrize("K,S,n_sm", [(64, 1, 1), (64, 1, 132), (64, 2, 1),
                                      (512, 1, 1), (512, 4, 132)])
def test_plan_covers_every_cell_and_plane_once(window, probe, K, S, n_sm,
                                               mode):
    """Both passes' walks visit every (cell, kept plane) of a segment
    exactly once, int4's pairs included; the amax walk gives the values'
    max |v| over cells per plane and channel."""
    cells, pc, C = WINDOWS[window], PROBES[probe], 3
    Ko = K // S
    plan = pack.build_plan(C, 2, K, S, cells, pc, mode, n_sm=n_sm)
    rng = np.random.default_rng(K + S + cells)
    values = np.abs(rng.standard_normal((cells, Ko + 1, C))).astype(
        np.float32)
    amax, visits = amax_walk(plan, values)
    assert (visits == 1).all()
    np.testing.assert_array_equal(amax, values.max(axis=0))
    assert (rows_walk(plan, cells, Ko, False) == 1).all()
    if Ko % 2 == 0:
        pairs = rows_walk(plan, cells, Ko, True)
        assert (pairs == 1).all()
        # plane p is in pair p // 2: each plane written once
        assert pairs.shape[1] * 2 - 1 == Ko + 1


@pytest.mark.parametrize("probe", sorted(PROBES))
@pytest.mark.parametrize("K,S", [(64, 1), (64, 2), (512, 1), (512, 2),
                                 (512, 4), (256, 1)])
@pytest.mark.parametrize("C", [3, 8])
@pytest.mark.parametrize("cells,n_seg", [(256 * 1024, 16), (512 * 512, 1),
                                         (37 * 41, 3)])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_plan_tiles_fit_their_budget(probe, K, S, C, cells, n_seg, mode):
    """Every tile fits TILE_BUDGET and holds the planes a chunk stages
    (g - 1 .. g + 1, 16-byte aligned down along contiguous planes); CB is
    a multiple of 8, fills the budget unless two waves cap it, and the
    shared bytes are the kernel's layout: the tile, its metadata and the
    amax lanes' maxima (pass A) or a chunk's scales (pass B)."""
    pc = PROBES[probe]
    n_p = n_seg * K + 1
    plan = pack.build_plan(C, n_seg, K, S, cells, pc, mode)
    L = plan
    waves = 2 * 132 * pack.WAVE_BLOCKS_PER_SM
    for cb in (L.CB_a, L.CB_b):
        assert cb % pack.CB_ROWS == 0
        assert pack.tile_bytes(cb, L.pitch, pc) <= pack.TILE_BUDGET
    bigger = pack.tile_bytes(L.CB_a + 8, L.pitch, pc)
    assert (bigger > pack.TILE_BUDGET
            or -(-cells // (L.CB_a + 8)) * n_seg < waves)
    assert L.CR % L.CB_a == 0
    assert L.CB_b == (min(L.CB_a, pack.FLOAT_ROWS_CB) if mode < 2
                      else L.CB_a)
    assert L.n_chunk * L.KB >= K // S + 1 > (L.n_chunk - 1) * L.KB
    assert L.lanes * L.slots <= THREADS and L.KB <= pack.AMAX_COLS * L.slots
    assert L.slots == THREADS if L.lanes == 1 else L.KB <= L.slots
    if L.KB < THREADS // 2:
        assert L.lanes == THREADS // L.KB
    for s in range(n_seg):
        for k0 in range(0, K // S + 1, L.KB):
            k1 = min(k0 + L.KB, K // S + 1)
            glo, ghi = s * K + k0 * S, s * K + (k1 - 1) * S
            P0, P1 = max(glo - 1, 0), min(ghi + 1, n_p - 1)
            if pc:
                P0 &= ~3
                assert 4 * ((P1 - P0 + 4) // 4) <= L.pitch
            else:
                assert P1 - P0 + 1 <= L.pitch
    def tile(cb):
        return pack.tile_bytes(cb, L.pitch, pc) + pack.meta_bytes(cb)

    assert L.smem_a == tile(L.CB_a) + 4 * (L.lanes - 1) * L.slots * C
    assert L.smem_b == tile(L.CB_b) + 4 * L.KB * C
    assert max(L.smem_a, L.smem_b) <= pack.H100_SMEM_OPTIN
    assert L.blocks_a * L.CR >= cells > (L.blocks_a - 1) * L.CR
    assert L.blocks_b * L.CB_b >= cells > (L.blocks_b - 1) * L.CB_b


def test_plan_at_the_sharded_paths_shapes():
    """A shard of the 1024^3 field at K = 64 (z-probing): the amax pass
    and the codes stage 80 cells a barrier (8 before), a float table's
    rows 32; 3 amax lanes of 65 planes (195 threads at work, 65 before),
    and pass A in 132 runs of 2,000 cells a segment."""
    for mode, cb_b in ((0, 32), (1, 32), (2, 80), (3, 80)):
        plan = pack.build_plan(3, 16, 64, 1, 256 * 1024, True, mode)
        assert (plan.CB_a, plan.CB_b, plan.KB, plan.slots,
                plan.lanes) == (80, cb_b, 65, 65, 3)
        assert (plan.blocks_a, plan.CR) == (132, 2000)
        assert plan.lanes * plan.slots == 195
    x = pack.build_plan(3, 16, 64, 1, 256 * 1024, False, 2)
    assert (x.CB_a, x.CB_b, x.lanes) == (24, 24, 3)


@pytest.mark.parametrize("mode,phase", [(0, 0), (1, 0), (2, 0), (3, 0),
                                        (2, 1), (3, 2)])
@pytest.mark.parametrize("probe", sorted(PROBES))
def test_build_hands_pack_build_its_plan(monkeypatch, mode, phase, probe):
    """On the card's branch (the "meta" device standing in) the wrapper
    launches ``pack_build`` once with the plan of its shape as the last
    arguments before the stream."""
    seen = []
    monkeypatch.setattr(_build.Kernel, "launch",
                        lambda self, name, device, *args:
                        seen.append((name, args)))
    dims = (20, 22, 65)
    p_ax = "xyz".index(probe)
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    ne = torch.empty(dims, device="meta")
    lay = ChannelLayout(False, True, False)
    K = 16
    kw = dict(p_ax=p_ax, layout=lay, K=K, n_seg=-(-(dims[p_ax] - 1) // K),
              pref=-3e-10, da=1e-4, db=1e-4, dp=1e-4, omega=1.77e15,
              verdet=0.0, plane_stride=1)
    amax = torch.empty((kw["n_seg"], K + 1, lay.n_channels),
                       dtype=torch.int32, device="meta")
    pack._build({"ne": ne}, mode=mode, dither=None, phase=phase,
                amax=amax if phase == 2 else None, **kw)
    ((name, args),) = seen
    assert name == "pack_build"
    assert len(args) + 1 == len(pack.KERNEL.functions[name])
    plan = pack.build_plan(lay.n_channels, kw["n_seg"], K, 1,
                           dims[a_ax] * dims[b_ax], ne.stride(p_ax) == 1,
                           mode)
    assert args[-13] == phase
    assert tuple(args[-12:]) == tuple(plan)
