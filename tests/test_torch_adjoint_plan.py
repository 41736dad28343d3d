"""The host side of K11's design (kernels/march_adjoint.py), on the CPU.

The kernel sums a plane's corner cotangents over each warp's runs of equal
corner cell by at most ``MAX_STEPS`` shuffle steps, in blocks of 2^S lanes
whose first lanes add vectors of ``vector_width(C)`` floats into the
table's cotangent. These tests hold ``atomics_per_launch`` to a lane-by-lane
walk of the kernel's ``warp_run`` (the same ballot, head, end, steps and
adds), hold the walk's block sums to the plain per-cell sums, and check the
vector widths, the scratch bytes and the refusals. The kernel itself is
held to ``march_vjp_plain`` on the card (``tests/test_torch_cuda.py``).
"""

import math
import os
import shutil

import numpy as np
import pytest
import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels import march_adjoint as ma

WARP = 32


def _walk(cells, S, values=None):
    """The kernel's warp_run and flush, lane by lane: the adding lanes
    (their cells) and, for ``values``, the sums they add."""
    cells = [int(c) for c in cells]
    n = len(cells)
    key = cells + [-1] * (-n % WARP)
    vals = (list(values) + [0.0] * (-n % WARP)) if values is not None \
        else None
    adders, sums = [], []
    for w0 in range(0, len(key), WARP):
        k = key[w0:w0 + WARP]
        first = [lane == 0 or k[lane] != k[lane - 1] for lane in range(WARP)]
        end, head = [0] * WARP, [0] * WARP
        for lane in range(WARP):
            e = lane
            while e + 1 < WARP and not first[e + 1]:
                e += 1
            end[lane] = e
            h = lane
            while not first[h]:
                h -= 1
            head[lane] = h
        longest = max(end[lane] - lane + 1 for lane in range(WARP)
                      if first[lane])
        steps = min(math.ceil(math.log2(longest)), S)
        v = list(vals[w0:w0 + WARP]) if vals is not None else None
        for st in range(steps):
            off = 1 << st
            if v is not None:
                # every lane reads the values before the step (a shuffle)
                v = [v[lane] + v[lane + off] if lane + off <= end[lane]
                     else v[lane] for lane in range(WARP)]
        for lane in range(WARP):
            real = w0 + lane < n
            if real and ((lane - head[lane]) & ((1 << steps) - 1)) == 0:
                adders.append(k[lane])
                if v is not None:
                    sums.append(v[lane])
    return adders, sums


def _sequences():
    g = np.random.default_rng(14)
    return {
        "empty": [],
        "one_ray": [7],
        "one_cell": [5] * 100,
        "own_cells": list(range(77)),
        "runs_of_20": list(np.repeat(np.arange(9), 20)),
        "runs_of_32": list(np.repeat(np.arange(4), 32)),
        "sorted_random": sorted(g.integers(0, 40, 333)),
        "unsorted_random": list(g.integers(0, 6, 150)),
        "tail_of_5": list(np.repeat(np.arange(3), 12)) + [9] * 5,
    }


SEQ = _sequences()


@pytest.mark.parametrize("S", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("name", sorted(SEQ))
def test_atomics_per_launch_counts_the_kernels_adding_lanes(name, S):
    cells = torch.tensor(SEQ[name], dtype=torch.int32)
    adders, _ = _walk(SEQ[name], S)
    for C, K in ((3, 6), (4, 64), (6, 5), (8, 1)):
        per = 4 * (C // ma.vector_width(C)) * (K + 1)
        assert ma.atomics_per_launch(cells, K=K, C=C, max_steps=S) == \
            len(adders) * per, (C, K)


def test_atomics_per_launch_uses_the_kernels_step_cap():
    import re

    from synthpy_tpu_torch.kernels import _build

    src = (_build.CSRC / ma.KERNEL.source).read_text()
    cap = re.search(r"constexpr int MAX_STEPS = (\d+);", src)
    assert cap and int(cap.group(1)) == ma.MAX_STEPS == 2
    cells = torch.tensor(SEQ["runs_of_20"], dtype=torch.int32)
    assert ma.atomics_per_launch(cells, K=64, C=4) == ma.atomics_per_launch(
        cells, K=64, C=4, max_steps=ma.MAX_STEPS)
    # runs of 20 in blocks of 4 lanes; whole runs would add once a run,
    # each lane alone once a ray
    whole = ma.atomics_per_launch(cells, K=64, C=4, max_steps=5)
    alone = ma.atomics_per_launch(cells, K=64, C=4, max_steps=0)
    assert whole < ma.atomics_per_launch(cells, K=64, C=4) < alone
    assert alone == len(SEQ["runs_of_20"]) * 4 * 65


@pytest.mark.parametrize("S", [0, 1, 2, 5])
@pytest.mark.parametrize("name", ["one_cell", "runs_of_20", "sorted_random",
                                  "unsorted_random", "tail_of_5"])
def test_block_sums_add_up_to_each_cells_sum(name, S):
    """Every ray's value reaches the table once: the adding lanes' sums,
    gathered by cell, equal the plain per-cell sums (integers, exact)."""
    cells = SEQ[name]
    g = np.random.default_rng(len(cells) + S)
    values = [float(v) for v in g.integers(-50, 50, len(cells))]
    adders, sums = _walk(cells, S, values)
    got, want = {}, {}
    for c, v in zip(adders, sums):
        got[c] = got.get(c, 0.0) + v
    for c, v in zip(cells, values):
        want[int(c)] = want.get(int(c), 0.0) + v
    assert got == want


@pytest.mark.parametrize("C,width", [(3, 1), (4, 4), (5, 1), (6, 2),
                                     (7, 1), (8, 4)])
def test_vector_width_by_channels(C, width):
    assert ma.vector_width(C) == width
    # a corner's C values of plane k start (cell (K+1) C + k C) floats in:
    # a multiple of the width for every cell, plane and K
    for K in (1, 6, 64):
        for cell in (0, 1, 7):
            for k in (0, 1, K):
                assert (cell * (K + 1) * C + k * C) % width == 0


@pytest.mark.parametrize("C", [0, 2, 9])
def test_vector_width_refuses_other_layouts(C):
    with pytest.raises(ValueError, match="3-8 channels"):
        ma.vector_width(C)


def test_scratch_bytes():
    assert ma.scratch_bytes(1_000_000, 64) == 2_048_000_000
    assert ma.scratch_bytes(3000, 6) == 6 * 3000 * 8 * 4
    assert ma.scratch_bytes(0, 64) == 0


@pytest.mark.parametrize("C,offset,aligned", [
    (4, 1, False), (4, 2, False), (4, 4, True), (8, 3, False),
    (6, 1, False), (6, 2, True), (3, 1, True), (5, 3, True)])
def test_a_misaligned_cotangent_is_refused(C, offset, aligned):
    """On a tensor off the CPU (here the meta device) the wrapper refuses a
    dseg that the kernel's vector adds cannot take, before any build or
    launch; an aligned one goes on to the build."""
    if aligned and (shutil.which("nvcc")
                    or os.path.exists("/usr/local/cuda/bin/nvcc")):
        pytest.skip("nvcc is present: the wrapper would build and launch")
    meta = torch.device("meta")
    ib, ps, bon = {3: (0, 0, 0), 4: (0, 1, 0), 5: (1, 1, 0), 6: (0, 0, 1),
                   8: (1, 1, 1)}[C]
    lay = ChannelLayout(bool(ib), bool(ps), bool(bon))
    assert lay.n_channels == C
    K, na, nb = 6, 3, 3
    seg = torch.empty((na * nb, (K + 1) * C), device=meta)
    flat = torch.empty(seg.numel() + offset, device=meta)
    dseg = flat[offset:].view(seg.shape)
    u = torch.empty((8, 8), device=meta)
    n0 = ma.KERNEL.launches
    call = (lambda: ma.march_adjoint(
        u, seg, u, shape_ab=(na, nb), origin_ab=(0.0, 0.0),
        inv_ab=(1.0, 1.0), dp=1.0, layout=lay, K=K, dseg=dseg))
    if aligned:
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    else:
        with pytest.raises(ValueError,
                           match=f"{4 * ma.vector_width(C)}-byte aligned"):
            call()
    assert ma.KERNEL.launches == n0
