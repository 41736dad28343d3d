"""K3's launch plan on the CPU: the cluster form of unweighted
``bin_image`` (``csrc/detector.cu``), walked in numpy as the source walks
it, its constants read from the source. A stand-in for the source's
``plan_of`` picks the cluster from the image's bytes and the card's
attributes; the wrappers' launches are recorded on the "meta" device, which
stands in for the card, with ``k3_plan`` answered by that stand-in. The
card's own plans are held in ``tests/test_torch_cuda.py``.
"""

import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from synthpy_tpu_torch.kernels import binning
from synthpy_tpu_torch.ops import histogram

CU = (Path(binning.__file__).parent / "csrc" / "detector.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", CU).group(1))


(CL_THREADS, CL_RAYS, RAYS_A_BLOCK, PORTABLE_CLUSTER, MAX_CLUSTER,
 SMEM_KEEP) = (_const(n) for n in ("CL_THREADS", "CL_RAYS", "RAYS_A_BLOCK",
                                   "PORTABLE_CLUSTER", "MAX_CLUSTER",
                                   "SMEM_KEEP"))
# an H100's shared memory a block (cudaDevAttrMaxSharedMemoryPerBlockOptin)
H100_OPTIN = 232_448


def plan_of(nx, ny, N, optin=H100_OPTIN, active=lambda c, smem: 132 // c,
            clusters_ok=True):
    """A stand-in for detector.cu's ``plan_of``: (cluster, lg, rows,
    clusters, smem, active) of N unweighted rays onto an nx x ny image,
    ``active(cluster, smem)`` the clusters the card holds at once (0 where
    it takes none of that size)."""
    if clusters_ok:
        for lg in range(MAX_CLUSTER.bit_length()):
            cluster = 1 << lg
            rows = -(-ny // cluster)
            smem = rows * nx * 4
            n = active(cluster, smem) if smem + SMEM_KEEP <= optin else 0
            if n >= 1:
                want = -(-N // (RAYS_A_BLOCK * cluster))
                return (cluster, lg, rows, min(max(want, 1), n), smem, n)
    return (0, 0, 0, 0, 0, 0)


def test_source_holds_the_modelled_plan():
    """The stand-in's rules are the source's: the smallest power-of-two
    cluster up to MAX_CLUSTER whose slices (ceil(ny / cluster) rows of nx
    int32 counts) leave SMEM_KEEP bytes of a block's shared memory, one
    cluster for each RAYS_A_BLOCK rays of its blocks, at most as many as the
    card holds; rows dealt out by rank (iy & mask), the slice's row
    iy >> lg; weighted rays never take it."""
    for text in ("for (int lg = 0; (1 << lg) <= MAX_CLUSTER; ++lg) {",
                 "const int rows = (ny + cluster - 1) / cluster;",
                 "const long long bytes = (long long)rows * nx * 4;",
                 "if (bytes + SMEM_KEEP > optin) continue;",
                 "const long long want = (N + (long long)RAYS_A_BLOCK * "
                 "cluster - 1) /",
                 "(int)(want < 1 ? 1 : want < active ? want : active),",
                 "atomicAdd(cl.map_shared_rank(img, iy[r] & mask) +",
                 "(iy[r] >> lg) * nx + ix[r], 1);",
                 "const int iy = ((k / nx) << lg) + rank;",
                 "if (img[k] && iy < ny) atomicAdd(H + iy * nx + k % nx, "
                 "(float)img[k]);",
                 "if (!w && p.cluster) {"):
        assert text in CU, text
    assert PORTABLE_CLUSTER == 8 and MAX_CLUSTER == 16


@pytest.mark.parametrize("bins,cluster,rows", [
    ((431, 321), 4, 81), ((96, 96), 1, 96), ((2000, 300), 16, 19),
    ((4000, 3000), 0, 0)])
def test_plan_of_images(bins, cluster, rows):
    """The diagnostics path's 431 x 321 counts take a cluster of 4 (81
    rows, 139,644 bytes a block), as many clusters as the card holds at 4 M
    rays; a small image one block; a 4000 x 3000 image the one-thread
    form."""
    p = plan_of(*bins, 4_000_000)
    assert p[0] == cluster and p[2] == rows
    if cluster:
        assert p[4] == rows * bins[0] * 4 <= H100_OPTIN - SMEM_KEEP
        assert p[3] == 132 // cluster
    # a card that takes no cluster past the portable size
    p8 = plan_of(*bins, 4_000_000,
                 active=lambda c, s: 0 if c > PORTABLE_CLUSTER else 132 // c)
    assert p8[0] == (cluster if cluster <= PORTABLE_CLUSTER else 0)


def _boundary_rows(nx, cluster):
    """The most image rows whose slices fit ``cluster`` blocks."""
    return (H100_OPTIN - SMEM_KEEP) // (nx * 4) * cluster


@pytest.mark.parametrize("nx", [431, 97, 2000, 56_000])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_forms_change_one_row_past_their_boundary(nx, cluster):
    """At the most rows a cluster's slices hold the plan takes that
    cluster (or a smaller one); one row more takes a larger one, and one
    row past the largest cluster the one-thread form."""
    ny = _boundary_rows(nx, cluster)
    if ny < 1:
        pytest.skip("one row passes a block")
    at, past = plan_of(nx, ny, 10**6), plan_of(nx, ny + 1, 10**6)
    assert 1 <= at[0] <= cluster and at[2] * at[0] >= ny
    assert at[4] + SMEM_KEEP <= H100_OPTIN
    if cluster == MAX_CLUSTER:
        assert past[0] == 0 and past[3] == 0
    else:
        assert past[0] > cluster or past[0] == 0


def test_plan_rays_and_refusals():
    """Few rays take one cluster; a card without cluster launches takes the
    one-thread form."""
    assert plan_of(431, 321, 1)[3] == 1
    assert plan_of(431, 321, 1003)[3] == 1
    assert plan_of(431, 321, RAYS_A_BLOCK * 4 + 1)[3] == 2
    assert plan_of(431, 321, 10**6, clusters_ok=False)[0] == 0


def _blocks_rays(N, grid):
    """Each ray's visits in the cluster form's walk: block b takes rays
    [b per, (b + 1) per), per = ceil(N / grid); thread t takes, a trip,
    CL_RAYS rays CL_THREADS apart."""
    seen = np.zeros(N, np.int64)
    per = -(-N // grid)
    t = np.arange(CL_THREADS)
    for b in range(grid):
        r0, r1 = b * per, min(N, (b + 1) * per)
        for i0 in range(r0 + 0, r1, CL_RAYS * CL_THREADS):
            for r in range(CL_RAYS):
                i = i0 + t + r * CL_THREADS
                np.add.at(seen, i[i < r1], 1)
    return seen, per


@pytest.mark.parametrize("bins,N", [
    ((431, 321), 4_000_000), ((431, 321), 1003), ((96, 96), 65_537),
    ((7, 5), 5000), ((2000, 300), 300_001)])
def test_cluster_walk_takes_each_ray_once(bins, N):
    """Every ray once, and a cluster's blocks one contiguous range."""
    p = plan_of(*bins, N)
    grid = p[3] * p[0]
    seen, per = _blocks_rays(N, grid)
    assert (seen == 1).all()
    for c in range(p[3]):
        blocks = range(c * p[0], (c + 1) * p[0])
        taken = [i for b in blocks for i in range(b * per,
                                                  min(N, (b + 1) * per))]
        assert taken == list(range(min(N, c * p[0] * per),
                                   min(N, (c + 1) * p[0] * per)))


@pytest.mark.parametrize("bins", [(431, 321), (7, 5), (2000, 13), (97, 1),
                                  (2000, 300), (56_000, 3)])
def test_row_split_holds_each_bin_once(bins):
    """Block rank r of a cluster of 2^lg holds the rows iy with iy & mask
    == r at slice row iy >> lg (within its ceil(ny / cluster) rows): every
    bin in exactly one slice word; and the write-back (word k of a slice
    at row ((k / nx) << lg) + rank, column k % nx, while that row is below
    ny) reaches each bin exactly once."""
    nx, ny = bins
    p = plan_of(nx, ny, 10**6)
    cluster, lg, rows = p[0], p[1], p[2]
    assert cluster
    mask = cluster - 1
    held = np.zeros((cluster, rows * nx), np.int64)
    iy, ix = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    assert (iy >> lg).max() < rows
    np.add.at(held, ((iy & mask).ravel(), ((iy >> lg) * nx + ix).ravel()),
              1)
    assert held.sum() == nx * ny and held.max() == 1
    written = np.zeros(nx * ny, np.int64)
    k = np.arange(rows * nx)
    for rank in range(cluster):
        row = ((k // nx) << lg) + rank
        ok = row < ny
        np.add.at(written, (row * nx + k % nx)[ok], 1)
    assert (written == 1).all()


def _stand_in(monkeypatch, calls, answer=0, **card):
    """``k3_plan`` answered by ``plan_of`` for unweighted bin_image and the
    one-thread form otherwise (or refused with ``answer``), the launches
    recorded in ``calls``."""
    def k3_plan(dev, entry, kind, nx, ny, N, addr):
        calls.append(("k3_plan", (dev, entry, kind, nx, ny, N)))
        if answer:
            return answer
        p = plan_of(nx, ny, N, **card) if (entry, kind) == (0, 0) else \
            (0,) * 6
        out = (ctypes.c_longlong * 5).from_address(addr)
        for j, v in enumerate((p[0], p[3], p[2], p[4], p[5])):
            out[j] = v
        return 0

    monkeypatch.setattr(binning.BIN_KERNEL, "load",
                        lambda: SimpleNamespace(k3_plan=k3_plan))
    for kern in (binning.BIN_KERNEL, binning.BIN_FIELD_KERNEL):
        monkeypatch.setattr(kern, "launch",
                            lambda name, dev, *a: calls.append((name, a)))


META = torch.device("meta")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("bins", [(431, 321), (4000, 3000)])
def test_bin_image_leaves_the_plan_to_the_source(monkeypatch, weighted,
                                                 bins):
    """bin_image passes the shape and a zeroed image whatever the form:
    the source derives the plan at the launch (one owner), and the wrapper
    asks no plan."""
    calls = []
    _stand_in(monkeypatch, calls)
    zeros = []
    real_zeros = torch.zeros

    def record(shape, **kw):
        zeros.append(tuple(shape))
        return real_zeros(shape, **kw)

    monkeypatch.setattr(binning.torch, "zeros", record)
    N = 4_000_000
    x = torch.empty(N, device=META)
    H = histogram.histogram2d(x, x, bins, ((-9.0, 9.0), (-6.75, 6.75)),
                              weights=x if weighted else None)[0]
    assert tuple(H.shape) == (bins[1], bins[0])
    assert zeros == [(bins[1], bins[0])]
    assert [c[0] for c in calls] == ["bin_image"]
    a = calls[0][1]
    assert a[4] == N and a[5:7] == bins and (a[2] is None) != weighted
    assert len(a) + 1 == len(binning.BIN_KERNEL.functions["bin_image"])


@pytest.mark.parametrize("entry,kind,bins,form", [
    ("bin_image", 0, (431, 321), "cluster"),
    ("bin_image", 0, (4000, 3000), "one_thread"),
    ("bin_image", 1, (431, 321), "one_thread"),
    ("bin_field", 2, (430, 320), "one_thread"),
    ("detect_field", 4, (431, 321), "one_thread")])
def test_plan_reports_the_sources_form(monkeypatch, entry, kind, bins, form):
    calls = []
    _stand_in(monkeypatch, calls)
    p = binning.plan(entry, kind, bins, 4_000_000, META)
    assert calls == [("k3_plan", (0, binning.ENTRIES[entry], kind, *bins,
                                  4_000_000))]
    assert p.form == form
    assert (p.cluster, p.rows) == ((4, 81) if form == "cluster" else (0, 0))


@pytest.mark.parametrize("answer", [1, 201])
def test_plan_refusal_raises(monkeypatch, answer):
    """A plan the source cannot make (an attribute unread, a kind it does
    not take) raises."""
    calls = []
    _stand_in(monkeypatch, calls, answer=answer)
    with pytest.raises(RuntimeError, match="k3_plan"):
        binning.plan("bin_image", 0, (4, 4), 8, META)
    assert [c[0] for c in calls] == ["k3_plan"]


@pytest.mark.parametrize("entry", ["detect_image", "bin", ""])
def test_plan_refuses_unknown_entries(entry):
    with pytest.raises(ValueError):
        binning.plan(entry, 0, (4, 4), 8, META)


def test_plan_form():
    assert binning.Plan(4, 30, 81, 139_644, 30).form == "cluster"
    assert binning.Plan(0, 0, 0, 0, 0).form == "one_thread"
