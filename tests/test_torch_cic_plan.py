"""K12's launch plan on the CPU: what the wrappers ask ``csrc/cic.cu`` for
(``cic_grid``, ``cic_pitch``) and pass its kernels, and the work each block
and thread of the shared forms takes, walked in numpy as ``csrc/cic.cu``
walks it (its constants read from the source). The wrappers' launches are
recorded on the "meta" device, which stands in for the card, with the
source's helpers answered by a stand-in; the card's own answers are held in
``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from synthpy_tpu_torch.kernels import cic

CU = (Path(cic.__file__).parent / "csrc" / "cic.cu").read_text()


def _const(name: str) -> int:
    text = re.search(rf"constexpr int {name} = ([^;]+);", CU).group(1)
    if text == "THREADS / 32":
        return _const("THREADS") // 32
    return int(text)


SM_THREADS, RAYS, SUM_SPLIT = (_const(n) for n in ("SM_THREADS", "RAYS",
                                                   "SUM_SPLIT"))


@pytest.mark.parametrize("N,grid", [(1, 1), (1023, 3), (4096, 1),
                                    (300_001, 7), (1_000_000, 132)])
def test_shared_forward_takes_each_ray_once(N, grid):
    """The shared forward's walk: block b takes rays [b per, (b + 1) per)
    with per = ceil(N / grid), each thread RAYS of them a trip, SM_THREADS
    apart: every ray exactly once."""
    seen = np.zeros(N, np.int64)
    per = -(-N // grid)
    t = np.arange(SM_THREADS)
    for b in range(grid):
        r0, r1 = b * per, min(N, (b + 1) * per)
        for i0 in range(r0, r1, RAYS * SM_THREADS):
            for r in range(RAYS):
                i = i0 + t + r * SM_THREADS
                np.add.at(seen, i[i < r1], 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("N,grid", [(1, 1), (5000, 2), (300_001, 7)])
def test_staged_adjoint_takes_each_ray_once(N, grid):
    """The staged adjoint's walk: a grid stride, RAYS rays a thread a trip:
    every ray exactly once."""
    seen = np.zeros(N, np.int64)
    stride = grid * SM_THREADS
    for b in range(grid):
        for t in range(SM_THREADS):
            for i0 in range(b * SM_THREADS + t, N, RAYS * stride):
                i = i0 + stride * np.arange(RAYS)
                np.add.at(seen, i[i < N], 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("n_partials", [1, 2, 7, 8, 9, 132, 264])
def test_sum_runs_cover_the_partials_once(n_partials):
    """The sum kernel's runs of partials (one warp each): consecutive, each
    partial in one run, and the runs it adds the ones that hold any."""
    per = -(-n_partials // SUM_SPLIT)
    runs = [(r * per, min(n_partials, (r + 1) * per))
            for r in range(SUM_SPLIT)]
    taken = [(p0, p1) for q, (p0, p1) in enumerate(runs)
             if q == 0 or q * per < n_partials]
    assert [p for p0, p1 in taken for p in range(p0, p1)] == list(
        range(n_partials))
    assert all(p0 < p1 for p0, p1 in taken)


@pytest.mark.parametrize("V", cic.CHANNELS)
@pytest.mark.parametrize("bins", [(96, 96), (95, 97), (1, 1), (3, 5)])
def test_partial_image_planes_are_whole_vectors(bins, V):
    """A partial image (``cic_pitch``: V planes of the pixels, each to a
    16-byte boundary, ``plane_of``) is whole float4 chunks, and the chunks
    the forward writes, chunk_of's four floats k = 4c .. 4c + 3 of the
    (nx, ny, V) image, cover the image's n = nx ny V floats once."""
    npix = bins[0] * bins[1]
    plane = -(-npix // 4) * 4
    assert "return (npix + 3) / 4 * 4;" in CU
    pitch = V * plane
    assert pitch % 4 == 0 and pitch >= npix * V
    # chunk k of the output holds floats 4k .. 4k + 3: pixel f // V,
    # channel f % V, read from plane (f % V) at pixel (f // V)
    f = np.arange(pitch)
    pix, ch = f // V, f % V
    src = ch * plane + pix
    ok = pix < plane
    assert len(np.unique(src[ok])) == ok.sum()
    assert ok[:npix * V].all()


def _stand_in(monkeypatch, grids, calls):
    """The source's helpers answered by ``grids[(kind, bins, V)]`` (and
    cic.cu's pitch), the launches recorded in ``calls``."""
    def cic_grid(dev, adjoint, V, nx, ny, N):
        calls.append(("cic_grid", (dev, adjoint, V, nx, ny, N)))
        return grids[("adjoint" if adjoint else "forward", (nx, ny), V)]

    lib = SimpleNamespace(
        cic_grid=cic_grid,
        cic_pitch=lambda V, nx, ny: V * (-(-nx * ny // 4) * 4))
    monkeypatch.setattr(cic.KERNEL, "load", lambda: lib)
    for kern in (cic.KERNEL, cic.BACKWARD_KERNEL):
        monkeypatch.setattr(kern, "launch",
                            lambda name, dev, *a: calls.append((name, a)))


@pytest.mark.parametrize("fwd,adj", [(132, 264), (132, 132), (1, 1),
                                     (0, 0), (7, 3)])
@pytest.mark.parametrize("V", cic.CHANNELS)
@pytest.mark.parametrize("bins", [(96, 96), (431, 321)])
def test_wrappers_launch_the_plan(monkeypatch, bins, V, fwd, adj):
    """On the meta device the wrappers ask ``cic_grid`` for each kernel's
    grid and pass it on as it is: the forward a scratch of that many
    partial images of ``cic_pitch`` floats and an image it writes whole,
    or, at grid 0, no scratch and a zeroed image; the adjoint its grid."""
    calls = []
    _stand_in(monkeypatch, {("forward", bins, V): fwd,
                            ("adjoint", bins, V): adj}, calls)
    meta = torch.device("meta")
    N = 1_000_000
    x = torch.empty(N, device=meta)
    vals = torch.empty((N, V), device=meta)
    acc = cic.deposit(x, x, vals, bins, 8.0, 8.0)
    assert tuple(acc.shape) == bins + (V,)
    assert calls[0] == ("cic_grid", (0, 0, V, *bins, N))
    name, a = calls[-1]
    assert name == "cic_deposit" and a[3] == V and a[4] == N
    assert a[5:7] == bins and a[11] == fwd
    assert (a[12] is None) == (fwd == 0)
    cic.adjoint(x, x, vals, torch.empty(bins + (V,), device=meta), bins,
                8.0, 8.0)
    assert calls[-2] == ("cic_grid", (0, 1, V, *bins, N))
    name, a = calls[-1]
    assert name == "cic_adjoint" and a[11] == adj


def test_forward_scratch_is_the_partials(monkeypatch):
    """The forward's scratch holds grid partial images of ``cic_pitch``
    floats, sized by what the source answers."""
    sizes = []
    real_empty = torch.empty

    def empty(shape, **kw):
        sizes.append(tuple(shape))
        return real_empty(shape, **kw)

    calls = []
    _stand_in(monkeypatch, {("forward", (95, 97), 4): 5}, calls)
    monkeypatch.setattr(cic.torch, "empty", empty)
    meta = torch.device("meta")
    cic.deposit(real_empty(10, device=meta), real_empty(10, device=meta),
                real_empty((10, 4), device=meta), (95, 97), 8.0, 8.0)
    assert (5 * 4 * 9216,) in sizes


@pytest.mark.parametrize("answer", [-1, -3])
def test_grid_refusal_raises(monkeypatch, answer):
    """A plan the source cannot make (its card's attributes unread) raises
    before any launch."""
    calls = []
    _stand_in(monkeypatch, {("forward", (96, 96), 1): answer}, calls)
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="cic_grid"):
        cic.deposit(torch.empty(4, device=meta), torch.empty(4, device=meta),
                    torch.empty((4, 1), device=meta), (96, 96), 8.0, 8.0)
    assert [c[0] for c in calls] == ["cic_grid"]


@pytest.mark.parametrize("kind", ["backward", "", "Forward"])
def test_plan_refuses(kind):
    with pytest.raises(ValueError):
        cic.grid(kind, (96, 96), 4, 1000, torch.device("meta"))
