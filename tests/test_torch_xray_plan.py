"""K15's lookup and tiles (``csrc/xray.cu``), on the CPU.

The kernel finds each log axis' cell in O(1): a query's bucket indexes a
guide built on the host (``kernels.xray.axis_guide``), and a walk steps
forward from that guess. It then folds a tile of pixels over a chunk of
planes staged in shared memory. The kernel runs only on a card; here:

* the guide and a plain copy of the walk (``kernels.xray.walk_cell``) give
  ``clip(searchsorted(axis, q, side="right") - 1, 0, n - 2)``, as
  ``torch.searchsorted`` and as JAX's ``make_opacity_lookup`` (on its own
  float32 axes), on log-uniform axes (the X-ray path's 30 x 40 table), a
  non-uniform axis, nodes packed into one bucket and two-node axes, for
  every node, the floats on either side of it, one ulp below the first
  node, NaN, +inf, -inf and random queries, over 1 to 5 n buckets; the
  guide is never past the answer;
* the table's kernel forms (cells with their reciprocals, corners, the
  fullest bucket, the division's domain) hold the axes and values, and a
  regular table's division (the product with the reciprocal and one
  correction) is the IEEE quotient on the kernels' fractions;
* the kernel's staging (read from ``xray.cu``'s tile constants, for each
  contiguous axis b, the probing axis or a) puts every voxel of a chunk
  once where its pixel's sum reads it, and a PyTorch walk of the tiles
  (staged w and j, plane-ordered sums, the w scratch) is bit-equal to
  ``fold_plain`` in both modes, every output combination and every
  probing axis, with ragged tiles and several chunks;
* the wrappers refuse, before a launch, what the kernels cannot take (the
  "meta" device standing in for the card).
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.optics import xray as jx
from synthpy_tpu_torch.kernels import _build, btable
from synthpy_tpu_torch.kernels import xray as kx
from synthpy_tpu_torch.optics import xray as tx

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

F32 = np.float32
T_PATH = np.logspace(0, 3, 30)
RHO_PATH = np.logspace(-5, 1, 40)


def _axes():
    """Ascending float32 axes, by name."""
    rng = np.random.default_rng(3)
    packed = np.concatenate([[0.0], 1.0 + 1e-6 * np.arange(12), [2.0, 9.0]])
    return {
        "path_logT_30": np.log(T_PATH.astype(F32)).astype(F32),
        "path_logrho_40": np.log(RHO_PATH.astype(F32)).astype(F32),
        "log_uniform_130": np.log(np.logspace(-5, 1, 130).astype(F32)
                                  ).astype(F32),
        "non_uniform": np.sort(rng.standard_normal(57) * 3.0).astype(F32),
        "packed_in_one_bucket": packed.astype(F32),
        "two_nodes": np.array([-1.5, 4.0], F32),
    }


AXES = _axes()


def _queries(axis):
    """Every node, the floats on either side of each, one ulp below the
    first node, NaN, +inf, -inf, and random queries over and past the
    span."""
    up = np.nextafter(axis, F32(np.inf))
    down = np.nextafter(axis, F32(-np.inf))
    lo, hi = float(axis[0]), float(axis[-1])
    pad = hi - lo
    rng = np.random.default_rng(7)
    rand = rng.uniform(lo - pad, hi + pad, 2000).astype(F32)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], F32)
    return np.concatenate([axis, up, down, special, rand]).astype(F32)


def _searchsorted_cell(axis, q):
    n = axis.shape[0]
    i = torch.searchsorted(torch.from_numpy(axis), torch.from_numpy(q),
                           right=True).numpy()
    return np.clip(i - 1, 0, n - 2)


def _buckets(n):
    return sorted({1, max(1, n // 2), n, 2 * n, 5 * n})


@pytest.mark.parametrize("factor", ["1", "n/2", "n", "2n", "5n"])
@pytest.mark.parametrize("name", sorted(AXES))
def test_walk_equals_searchsorted(name, factor):
    """The guide's guess, walked forward, is the searchsorted cell of every
    query, and the guess is never past it."""
    axis = AXES[name]
    n = axis.shape[0]
    buckets = {"1": 1, "n/2": max(1, n // 2), "n": n, "2n": 2 * n,
               "5n": 5 * n}[factor]
    guide, a0, inv_h = kx.axis_guide(axis, buckets)
    assert guide.dtype == np.int32 and guide.shape == (buckets,)
    assert inv_h > 0 and a0 == axis[0]
    q = _queries(axis)
    want = _searchsorted_cell(axis, q)
    np.testing.assert_array_equal(kx.walk_cell(axis, guide, a0, inv_h, q),
                                  want)
    # as many predicated steps as the fullest bucket has nodes suffice
    steps = kx.make_axis(torch.from_numpy(axis), buckets).steps
    np.testing.assert_array_equal(
        kx.walk_cell(axis, guide, a0, inv_h, q, steps=steps), want)
    # the guess is never past the answer (before the clip)
    raw = torch.searchsorted(torch.from_numpy(axis), torch.from_numpy(q),
                             right=True).numpy() - 1
    guess = guide[kx.bucket_of(q, a0, inv_h, buckets)]
    assert (guess <= raw).all()


def test_bucket_is_monotone_and_sends_nan_to_the_last():
    """The bucket of sorted queries never decreases; NaN and +inf go to the
    last bucket, -inf to the first."""
    axis = AXES["path_logT_30"]
    _, a0, inv_h = kx.axis_guide(axis, 60)
    q = np.sort(_queries(axis)[~np.isnan(_queries(axis))])
    k = kx.bucket_of(q, a0, inv_h, 60)
    assert (np.diff(k) >= 0).all() and k.min() == 0 and k.max() == 59
    special = kx.bucket_of(np.array([np.nan, np.inf, -np.inf], F32), a0,
                           inv_h, 60)
    assert special.tolist() == [59, 59, 0]


def test_default_guide_walks_at_most_two_steps_on_the_path_table():
    """With the default 2 n buckets, the path's axes hold at most one node
    a bucket, so no query needs more than one step past its guess (a
    regular table walks two predicated steps), and the reciprocal division
    is exact on them; a packed axis holds more, as its ``steps`` says."""
    for name in ("path_logT_30", "path_logrho_40", "log_uniform_130"):
        axis = AXES[name]
        ax = kx.make_axis(torch.from_numpy(axis))
        assert ax.steps == 1 and ax.exact_div
        guide = ax.guide.numpy()
        q = _queries(axis)
        guess = guide[kx.bucket_of(q, F32(ax.a0), F32(ax.inv_h),
                                   guide.shape[0])]
        raw = torch.searchsorted(torch.from_numpy(axis), torch.from_numpy(q),
                                 right=True).numpy() - 1
        assert int((raw - guess).max()) <= ax.steps
    packed = kx.make_axis(torch.from_numpy(AXES["packed_in_one_bucket"]))
    assert packed.steps == 12


@pytest.mark.parametrize("case", ["path", "zero_node", "tiny_node",
                                  "tiny_width", "huge", "descending",
                                  "nan"])
def test_exact_div_domain(case):
    """``exact_div`` holds where every node is 0 or within [2^-40, 2^60] in
    magnitude and every width within [2^-60, 2^60], and nowhere else."""
    axes = {"path": (AXES["path_logT_30"], True),
            "zero_node": (np.array([-1.0, 0.0, 2.0], F32), True),
            "tiny_node": (np.array([-1.0, 2.0**-45, 2.0], F32), False),
            "tiny_width": (np.array([1.0, 1.0 + 2.0**-23], F32), True),
            "huge": (np.array([0.0, 2.0**61], F32), False),
            "descending": (np.array([2.0, 1.0], F32), False),
            "nan": (np.array([0.0, np.nan, 2.0], F32), False)}
    axis, want = axes[case]
    assert kx.exact_div(axis) is want


def _division_cases():
    """(x, w) pairs of the kernels' fractions: dividends q - node of log
    queries at and around every node of the test axes, widths of their
    cells."""
    xs, ws = [], []
    for name, axis in AXES.items():
        if not kx.exact_div(axis):
            continue
        q = _queries(axis)
        q = q[np.isfinite(q)]
        cell = _searchsorted_cell(axis, q)
        xs.append((q - axis[cell]).astype(F32))
        ws.append((axis[cell + 1] - axis[cell]).astype(F32))
    return np.concatenate(xs), np.concatenate(ws)


def _fma32(a, b, c):
    """RN32(a b + c) of float32 arrays, exactly: a b is exact in float64;
    the sum's rounding error (TwoSum) settles the one case float64 cannot,
    a sum exactly halfway between two float32 values."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(F32)
    up = np.nextafter(r, F32(np.inf))
    down = np.nextafter(r, F32(-np.inf))
    r = np.where((s == (r.astype(np.float64) + up) / 2) & (err > 0), up, r)
    return np.where((s == (r.astype(np.float64) + down) / 2) & (err < 0),
                    down, r).astype(F32)


def test_reciprocal_division_is_the_ieee_quotient():
    """A regular table's fraction, RN(x r) corrected once by the exact
    remainder with r = RN(1 / w) and given x's sign, is the IEEE quotient
    x / w on the kernels' fractions below the width (0 <= x < w, -0
    among them), and has its sign below 0 (both clip to 0); from x >= w
    the kernel takes 1."""
    x, w = _division_cases()
    keep = x < w
    x, w = x[keep], w[keep]
    r = (F32(1.0) / w).astype(F32)
    q0 = (x.astype(np.float64) * r).astype(F32)
    q = np.copysign(_fma32(_fma32(-w, q0, x), r, q0), x)
    want = (x / w).astype(F32)
    pos = x >= 0
    assert pos.sum() > 1000 and (~pos).sum() > 100
    assert np.array_equal(q[pos].view(np.int32), want[pos].view(np.int32))
    assert (q[~pos] < 0).all() and (want[~pos] < 0).all()


def test_table_forms_hold_the_axes_and_values():
    """``make_table``: each axis' cells are (node, next node - node) in
    float32 (0 at the last node), the corners each cell's four values in
    the kernel's order, the guides int32 over 2 n buckets by default."""
    kfn = tx.make_opacity_lookup(T_PATH, RHO_PATH, 5e3 * np.outer(
        T_PATH**-1.5, RHO_PATH**0.5), device="cpu")
    T = kfn.table("cpu")
    for ax, a in ((T.t_axis, T.lt), (T.r_axis, T.lr)):
        n = a.shape[0]
        assert ax.cell.shape == (n, 4) and ax.guide.shape == (2 * n,)
        assert ax.guide.dtype == torch.int32
        assert torch.equal(ax.cell[:, 0], a)
        assert torch.equal(ax.cell[:-1, 1], a[1:] - a[:-1])
        assert float(ax.cell[-1, 1]) == 0.0
        assert torch.equal(ax.cell[:-1, 2], torch.ones(n - 1)
                           / ax.cell[:-1, 1])
        assert not bool(ax.cell[:, 3].any())
        assert ax.a0 == float(a[0]) and ax.steps == 1 and ax.exact_div
    v = T.vals
    assert T.corners.shape == (29, 39, 4)
    assert torch.equal(T.corners[..., 0], v[:-1, :-1])
    assert torch.equal(T.corners[..., 1], v[:-1, 1:])
    assert torch.equal(T.corners[..., 2], v[1:, :-1])
    assert torch.equal(T.corners[..., 3], v[1:, 1:])


# -- the tiles ---------------------------------------------------------------

def _cu_constants():
    """THREADS, TILE_PIXELS and CHUNK_PLANES of xray.cu (each a number or
    an earlier one's name)."""
    text = (_build.CSRC / "xray.cu").read_text()
    out = {}
    for k in ("THREADS", "TILE_PIXELS", "CHUNK_PLANES"):
        v = re.search(rf"constexpr int {k} = (\w+);", text).group(1)
        out[k] = int(v) if v.isdigit() else out[v]
    return out


CU = _cu_constants()
FASTS = ("b", "p", "a")


def _tile(fast):
    """(TA, TB, DJ, DB) of ``Tile<FAST>`` in xray.cu."""
    th, tp, pc = CU["THREADS"], CU["TILE_PIXELS"], CU["CHUNK_PLANES"]
    ta = 32 if fast == "a" else 1
    return (ta, tp // ta, 0 if fast == "p" else th // tp,
            th // pc if fast == "p" else 0)


def _staging(fast):
    """For each thread and voxel k of a chunk: its (plane, tile row, tile
    column), as fold_kernel derives them."""
    th, tp, pc = CU["THREADS"], CU["TILE_PIXELS"], CU["CHUNK_PLANES"]
    TA, TB, DJ, DB = _tile(fast)
    tid = np.arange(th)
    if fast == "b":
        tb, ta, jt = tid % TB, 0 * tid, tid // TB
    elif fast == "p":
        jt, tb, ta = tid % pc, tid // pc, 0 * tid
    else:
        ta, tb, jt = tid % TA, (tid // TA) % TB, tid // tp
    k = np.arange(tp * pc // th)[:, None]
    return jt + k * DJ, ta + 0 * k, tb + k * DB


@pytest.mark.parametrize("fast", FASTS)
def test_staging_covers_a_chunk_once(fast):
    """Each voxel of a tile's chunk is copied by exactly one (thread, k), to
    the shared index its pixel's sum reads, and consecutive threads move
    along the contiguous axis."""
    TA, TB, _, _ = _tile(fast)
    pitch = CU["TILE_PIXELS"] + 1
    j, ta, tb = _staging(fast)
    assert TA * TB == CU["TILE_PIXELS"]
    assert j.min() == 0 and j.max() == CU["CHUNK_PLANES"] - 1
    at = j * pitch + ta * TB + tb
    assert np.unique(at).size == at.size == CU["TILE_PIXELS"] * CU[
        "CHUNK_PLANES"]
    want = {(jj, p) for jj in range(CU["CHUNK_PLANES"])
            for p in range(CU["TILE_PIXELS"])}
    assert {(int(a // pitch), int(a % pitch)) for a in at.ravel()} == want
    # a warp's first copy runs along the contiguous axis: runs of
    # consecutive elements as long as the tile allows (32, or a chunk's
    # planes)
    lane = {"b": tb, "p": j, "a": ta}[fast][0, :32]
    run = min(32, {"b": TB, "p": CU["CHUNK_PLANES"], "a": TA}[fast])
    assert (lane.reshape(-1, run) == np.arange(run)
            + lane.reshape(-1, run)[:, :1]).all()


def _tile_walk(a, b, *, mode, table, w0, wlast, tau, em, wout, fast):
    """A PyTorch walk of fold_kernel: tiles of (TA, TB) pixels, chunks of
    CHUNK_PLANES planes copied into [plane][pixel] stages as the kernel's
    threads copy them, each pixel's w (and j = w Te^4) looked up from its
    stage and summed in plane order into tau (and em), the w scratch
    written, tau / em added once a batch."""
    like = a if a is not None else b
    pb, na, nb = like.shape
    TA, TB, _, _ = _tile(fast)
    pc, pitch = CU["CHUNK_PLANES"], CU["TILE_PIXELS"] + 1
    js, tas, tbs = (x.ravel() for x in _staging(fast))
    half, one = torch.tensor(0.5), torch.tensor(1.0)
    for a0 in range(0, na, TA):
        for b0 in range(0, nb, TB):
            st = torch.zeros(CU["TILE_PIXELS"])
            se = torch.zeros(CU["TILE_PIXELS"])
            for j0 in range(0, pb, pc):
                sw = torch.full((pc * pitch,), float("nan"))
                sj = torch.full((pc * pitch,), float("nan"))
                for j, ta, tb in zip(js, tas, tbs):
                    ia, ib, jj = a0 + ta, b0 + tb, j0 + j
                    if ia >= na or ib >= nb or jj >= pb:
                        continue
                    at = j * pitch + ta * TB + tb
                    if mode == 0:
                        r, t = a[jj, ia, ib], b[jj, ia, ib]
                        w = kx.lookup_plain(table, t, r) * r
                        t2 = t * t
                        sw[at], sj[at] = w, w * (t2 * t2)
                    else:
                        if a is not None:
                            sw[at] = a[jj, ia, ib]
                        if b is not None:
                            sj[at] = b[jj, ia, ib]
                nj = min(pc, pb - j0)
                for p in range(CU["TILE_PIXELS"]):
                    ia, ib = a0 + p // TB, b0 + p % TB
                    if ia >= na or ib >= nb:
                        continue
                    for j in range(nj):
                        g = j0 + j
                        tr = half if ((g == 0 and w0) or (g == pb - 1
                                                          and wlast)) else one
                        if tau is not None:
                            st[p] = st[p] + tr * sw[j * pitch + p]
                        if em is not None:
                            se[p] = se[p] + tr * sj[j * pitch + p]
                        if wout is not None:
                            wout[g, ia, ib] = sw[j * pitch + p]
            for p in range(CU["TILE_PIXELS"]):
                ia, ib = a0 + p // TB, b0 + p % TB
                if ia < na and ib < nb:
                    if tau is not None:
                        tau[ia, ib] = tau[ia, ib] + st[p]
                    if em is not None:
                        em[ia, ib] = em[ia, ib] + se[p]


def _bits(t):
    return None if t is None else t.view(torch.int32)


@pytest.mark.parametrize("outputs", ["tau", "em", "wout", "tau_em_wout"])
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("probe", [0, 1, 2])
def test_tile_walk_bit_equal_fold_plain(probe, mode, outputs):
    """The kernel's tiles, chunks and plane-ordered sums, walked in PyTorch
    on the contiguous axis the kernel picks for each probing axis (x, y:
    b; z: the probing axis), are bit-equal to ``fold_plain`` (ragged tiles,
    two chunks of planes)."""
    rng = np.random.default_rng(probe)
    shape = (CU["CHUNK_PLANES"] + 5, 3, 7)
    rho = torch.from_numpy((1e-3 * (1 + rng.random(shape))).astype(F32))
    te = torch.from_numpy((40 * (1 + rng.random(shape))).astype(F32))
    kfn = tx.make_opacity_lookup(T_PATH, RHO_PATH, 5e3 * np.outer(
        T_PATH**-1.5, RHO_PATH**0.5), device="cpu")
    table = kfn.table("cpu")
    r, t = rho.movedim(probe, 0), te.movedim(probe, 0)
    if mode == 1:
        r, t = (kfn(t, r) * r).movedim(0, 0), t**4
    sp, sa, sb = r.stride()
    fast = "b" if sb == 1 else ("p" if sp == 1 else "a")
    assert fast == ("p" if probe == 2 else "b")
    want_w = outputs in ("tau", "wout", "tau_em_wout")
    a_in = r if (mode == 0 or want_w) else None
    b_in = t if (mode == 0 or "em" in outputs) else None
    res = {}
    for name, fn in (("walk", _tile_walk), ("plain", kx.fold_plain)):
        pb, na, nb = r.shape
        tau = torch.full((na, nb), 0.25) if "tau" in outputs else None
        em = torch.full((na, nb), 0.5) if "em" in outputs else None
        wout = (torch.full((pb, na, nb), -1.0) if "wout" in outputs
                else None)
        kw = dict(mode=mode, table=table, w0=True, wlast=probe != 1,
                  tau=tau, em=em, wout=wout)
        if fn is _tile_walk:
            fn(a_in, b_in, fast=fast, **kw)
        else:
            fn(a_in, b_in, **kw)
        res[name] = (tau, em, wout)
    for got, want in zip(res["walk"], res["plain"]):
        if want is None:
            assert got is None
        else:
            assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("stride", ["a", "none"])
def test_tile_walk_other_axes_bit_equal_fold_plain(stride):
    """Volumes whose contiguous axis is a, or none of the three, take the
    a-major tiles or b's: the walk is bit-equal to ``fold_plain``."""
    rng = np.random.default_rng(5)
    base = torch.from_numpy((1e-3 * (1 + rng.random((40, 6, 9)))).astype(
        F32))
    te = torch.from_numpy((40 * (1 + rng.random((40, 6, 9)))).astype(F32))
    if stride == "a":
        r = base.permute(1, 0, 2).contiguous().permute(1, 0, 2)
        r = r.transpose(1, 2).contiguous().transpose(1, 2)
        t = te.permute(1, 0, 2).contiguous().permute(1, 0, 2)
        t = t.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        r = torch.zeros((40, 6, 9, 2))[..., 0]
        t = torch.zeros((40, 6, 9, 2))[..., 0]
        r.copy_(base)
        t.copy_(te)
    sp, sa, sb = r.stride()
    fast = "b" if sb == 1 else ("p" if sp == 1 else ("a" if sa == 1
                                                    else "b"))
    assert fast == ("a" if stride == "a" else "b")
    table = tx.make_opacity_lookup(T_PATH, RHO_PATH, 5e3 * np.outer(
        T_PATH**-1.5, RHO_PATH**0.5), device="cpu").table("cpu")
    res = {}
    for name in ("walk", "plain"):
        tau, em = torch.zeros((6, 9)), torch.zeros((6, 9))
        wout = torch.zeros((40, 6, 9))
        kw = dict(mode=0, table=table, w0=False, wlast=True, tau=tau, em=em,
                  wout=wout)
        if name == "walk":
            _tile_walk(r, t, fast=fast, **kw)
        else:
            kx.fold_plain(r, t, **kw)
        res[name] = (tau, em, wout)
    for got, want in zip(res["walk"], res["plain"]):
        assert torch.equal(_bits(got), _bits(want))


# -- refusals before a launch --------------------------------------------------

def test_fold_refuses_a_batch_of_2_31_pixels():
    """A batch of 2^31 pixels or more is refused before any build or
    launch (the "meta" device stands in for the card)."""
    w = torch.empty((1, 2**16, 2**15), device="meta")
    tau = torch.empty((2**16, 2**15), device="meta")
    with pytest.raises(ValueError, match="fewer than 2\\^31"):
        kx.fold(w, None, mode=1, table=None, w0=True, wlast=True, tau=tau,
                em=None)


def test_kernels_refuse_a_table_of_one_node():
    """The kernels' table needs two nodes an axis: refused before a
    launch."""
    kfn = tx.make_opacity_lookup(np.array([1.0]), RHO_PATH,
                                 np.ones((1, 40)), device="cpu")
    tab = kfn.table("cpu")
    meta = kx.Table(*(t.to("meta") if isinstance(t, torch.Tensor) else t
                      for t in tab[:6]),
                    *(a._replace(cell=a.cell.to("meta"),
                                 guide=a.guide.to("meta"))
                      for a in (tab.t_axis, tab.r_axis)),
                    tab.corners.to("meta"))
    v = torch.empty((4, 5, 6), device="meta")
    with pytest.raises(ValueError, match="two nodes"):
        kx.fold(v, v, mode=0, table=meta, w0=True, wlast=True,
                tau=torch.empty((5, 6), device="meta"), em=None)


def test_btable_refuses_an_int8_batch_of_2_32_values():
    """K14's int8 write counts a value by its 32-bit index: a batch of 2^32
    values or more is refused before a launch."""
    shape = (1366, 1024, 1024, 3)
    tab = torch.empty(shape, dtype=torch.int8, device="meta")
    batch = torch.empty(shape, device="meta")
    scale = torch.empty((3,), device="meta")
    with pytest.raises(ValueError, match="fewer than 2\\^32"):
        btable.write(tab, batch, 0, scale, (1, 2))
