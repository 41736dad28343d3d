"""K15 and K16: X-ray radiography's opacity lookup, plane folds and
point-projection optical depth.

``fold`` (K15, ``xray_fold`` of ``csrc/xray.cu``) folds a batch of
probing-axis planes into the parallel-beam optical depth and emission
images: per voxel w = kappa(Te, rho) rho from an opacity table (mode 0) or
given w and j planes (mode 1), trapezoid sums over the planes in plane
order added to ``tau`` / ``em``, optionally w written to a scratch for
``pp_fold``. ``pp_fold`` (K16) adds a batch's plane-crossing bilinear
samples of w to the per-pixel point-projection depth; ``pp_chords`` (K16)
samples every detector chord through the volume (mode 0: the optical
depth; mode 1: the (rho, Te) samples and path lengths, for a kappa that
is not a table). Each launches its kernel on CUDA tensors and runs its
plain PyTorch version (``*_plain``) on CPU tensors. The arithmetic is the
JAX package's (``synthpy_tpu/optics/xray.py``): the plain versions and the
kernels round the same operations, so they agree to the order of the
library ``log`` / ``exp``. The kernels take the opacity table in the form
``make_table`` builds on the host: each log axis' guide over uniform
buckets (an O(1) cell: the guess, then a short walk), its nodes' widths
and their reciprocals, each cell's four corner values.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from synthpy_tpu_torch.kernels._build import (F, I, L, P, Kernel,
                                              refuse_grad)
from synthpy_tpu_torch.ops.interp import fma, trilinear

# the opacity table's arguments of xray_fold and pp_chords (``_table_args``)
_TABLE = [P, P, P, I, I, F, F, I, I, P, P, I, I, F, F, I, I, I, F, F]
FOLD_KERNEL = Kernel("xray.cu", {
    "xray_fold": [P, P, L, L, L, I, I, I, I, I, I, *_TABLE, P, P, P, P],
}, flags=["--fmad=false"])
PP_FOLD_KERNEL = Kernel("xray.cu", {
    "pp_fold": [P, I, I, I, P, P, L, P, P, F, F, F, F, P, P],
}, flags=["--fmad=false"])
PP_CHORDS_KERNEL = Kernel("xray.cu", {
    "pp_chords": [P, P, L, L, L, I, I, I, P, P, P, I, I, I, I, I, I, I,
                  *_TABLE, P, P, P, P, P],
}, flags=["--fmad=false"])


class Axis(NamedTuple):
    """One log axis of an opacity table as the kernels walk it: ``cell``
    (n, 4) float32, node i, node i+1 less node i (0 at the last node), the
    correctly rounded reciprocal of that width, 0; ``guide`` (buckets,)
    int32, the nodes whose bucket is below each bucket, less one; ``a0``
    node 0 and ``inv_h`` the buckets over the axis' span (float32 values)
    (``axis_guide``); ``steps`` the most nodes in one bucket (a walk from
    the guide takes at most that many steps); ``exact_div`` whether every
    node is 0 or within [2^-40, 2^60] in magnitude and every width within
    [2^-60, 2^60], where a product with the reciprocal and one correction
    give the IEEE quotient of any fraction the kernels form."""
    cell: torch.Tensor
    guide: torch.Tensor
    a0: float
    inv_h: float
    steps: int
    exact_div: bool


class Table(NamedTuple):
    """An opacity table on one device: the log axes ``lt`` (n_t,) and
    ``lr`` (n_r,), the values ``vals`` (n_t, n_r) (logs when
    ``log_space``), and the grids' first nodes (what the plain lookup
    reads); the kernels' forms of the same table: each axis' cells and
    guide (``t_axis``, ``r_axis``) and each cell's four corner values
    ``corners`` (n_t-1, n_r-1, 4) (``make_table``)."""
    lt: torch.Tensor
    lr: torch.Tensor
    vals: torch.Tensor
    log_space: bool
    t_min: float
    r_min: float
    t_axis: Axis
    r_axis: Axis
    corners: torch.Tensor


def bucket_of(q: np.ndarray, a0: np.float32, inv_h: np.float32,
              buckets: int) -> np.ndarray:
    """The kernels' bucket of float32 queries ``q``: floor((q - a0) inv_h)
    in float32 (each operation rounded), clamped to [0, buckets - 1], NaN
    to buckets - 1. Monotone in q."""
    q = np.asarray(q, np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        f = np.floor((q - np.float32(a0)) * np.float32(inv_h))
        top = ~(f < np.float32(buckets - 1))
        k = np.where(top, buckets - 1, np.where(f > 0, f, 0))
    return k.astype(np.int64)


def axis_guide(axis: np.ndarray, buckets: int
               ) -> Tuple[np.ndarray, np.float32, np.float32]:
    """(guide, a0, inv_h) of an ascending float32 axis over ``buckets``
    uniform buckets of its span: guide[k] counts the nodes whose bucket
    (``bucket_of``) is below k, less one, so that for any query q the
    guide of q's bucket is at most searchsorted(axis, q, side="right") - 1
    (nodes in lower buckets lie below q). A span that is not finite and
    positive gives inv_h 0: every finite query starts at the first node."""
    axis = np.asarray(axis, np.float32)
    a0 = np.float32(axis[0])
    span = float(axis[-1]) - float(axis[0])
    inv_h = (np.float32(buckets / span) if np.isfinite(span) and span > 0
             else np.float32(0.0))
    nodes = bucket_of(axis, a0, inv_h, buckets)
    guide = np.searchsorted(nodes, np.arange(buckets), side="left") - 1
    return guide.astype(np.int32), a0, inv_h


def walk_cell(axis: np.ndarray, guide: np.ndarray, a0: np.float32,
              inv_h: np.float32, q: np.ndarray,
              steps: Optional[int] = None) -> np.ndarray:
    """The kernels' cell of float32 queries ``q`` (a plain copy of
    ``cell`` in csrc/xray.cu): the guide's guess at q's bucket, then
    forward while the next node is not above q (a NaN query walks to the
    end), clipped to [0, n - 2]; with ``steps``, exactly that many
    predicated steps (a regular table's walk)."""
    axis = np.asarray(axis, np.float32)
    q = np.asarray(q, np.float32)
    n = axis.shape[0]
    g = guide[bucket_of(q, a0, inv_h, guide.shape[0])].astype(np.int64)
    s = 0
    while steps is None or s < steps:
        nxt = np.minimum(g + 1, n - 1)
        step = (g + 1 < n) & ~(axis[nxt] > q)
        if steps is None and not step.any():
            break
        g = g + step
        s += 1
    return np.clip(g, 0, n - 2)


def exact_div(axis: np.ndarray) -> bool:
    """Whether the kernels' reciprocal division is exact on a float32 axis:
    every node 0 or within [2^-40, 2^60] in magnitude, every width (next
    node less node) within [2^-60, 2^60]. A log query q (0, +inf, or
    within [2^-25, 104] in magnitude) less such a node is 0, +inf or
    within [2^-63, 2^61] in magnitude, where RN(x r) corrected once by the
    exact remainder, RN(q0 + r RN(x - w q0)) with r = RN(1 / w), is the
    IEEE quotient x / w (Markstein)."""
    axis = np.asarray(axis, np.float64)
    if axis.shape[0] < 2 or not np.isfinite(axis).all():
        return False
    mag = np.abs(axis)
    width = np.diff(np.asarray(axis, np.float32)).astype(np.float64)
    return bool(((mag == 0) | ((mag >= 2.0**-40) & (mag <= 2.0**60))).all()
                and ((width >= 2.0**-60) & (width <= 2.0**60)).all())


def make_axis(axis: torch.Tensor, buckets: Optional[int] = None) -> Axis:
    """An axis' kernel form (CPU tensors), over ``buckets`` (default 2 n)
    buckets."""
    ax = axis.detach().cpu().numpy().astype(np.float32)
    n = ax.shape[0]
    buckets = 2 * n if buckets is None else int(buckets)
    if buckets < 1:
        raise ValueError(f"buckets must be >= 1, got {buckets}")
    guide, a0, inv_h = axis_guide(ax, buckets)
    nxt = np.concatenate([ax[1:], ax[-1:]])
    width = (nxt - ax).astype(np.float32)
    with np.errstate(divide="ignore"):
        rcp = np.float32(1.0) / width
    cell = np.stack([ax, width, rcp, np.zeros_like(ax)], axis=1)
    steps = int(np.bincount(bucket_of(ax, a0, inv_h, buckets),
                            minlength=buckets).max()) if n else 0
    return Axis(torch.from_numpy(cell.astype(np.float32)),
                torch.from_numpy(guide), float(a0), float(inv_h), steps,
                exact_div(ax))


def make_table(lt: torch.Tensor, lr: torch.Tensor, vals: torch.Tensor,
               log_space: bool, t_min: float, r_min: float,
               device) -> Table:
    """A ``Table`` on ``device``: the axes, values and first nodes, and
    their kernel forms built on the host in float32 (each axis' cells and
    guide over 2 n buckets, the corner values)."""
    dev = torch.device(device)
    axes = [make_axis(ax) for ax in (lt, lr)]
    v = vals.detach().to("cpu", torch.float32)
    corners = torch.stack([v[:-1, :-1], v[:-1, 1:], v[1:, :-1], v[1:, 1:]],
                          dim=-1)

    def to(t):
        return t.to(dev).contiguous()

    return Table(to(lt), to(lr), to(vals), bool(log_space), float(t_min),
                 float(r_min),
                 *(a._replace(cell=to(a.cell), guide=to(a.guide))
                   for a in axes), to(corners))


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def lookup_plain(T: Table, te: torch.Tensor, rho: torch.Tensor
                 ) -> torch.Tensor:
    """kappa(Te, rho): bilinear in (log T, log rho) of the table, the cell
    ``searchsorted(side="right") - 1`` clipped to [0, n - 2] and the
    fractions to [0, 1] (queries outside the table clamp to its edge)."""
    te, rho = torch.broadcast_tensors(te, rho)
    qt = torch.log(torch.clamp_min(te, T.t_min))
    qr = torch.log(torch.clamp_min(rho, T.r_min))

    def cell(axis, q):
        i = torch.searchsorted(axis, q.reshape(-1).contiguous(), right=True)
        return torch.clamp(i - 1, 0, axis.shape[0] - 2).reshape(q.shape)

    it, ir = cell(T.lt, qt), cell(T.lr, qr)
    ft = torch.clamp((qt - T.lt[it]) / (T.lt[it + 1] - T.lt[it]), 0.0, 1.0)
    fr = torch.clamp((qr - T.lr[ir]) / (T.lr[ir + 1] - T.lr[ir]), 0.0, 1.0)
    v = T.vals
    out = ((1 - ft) * (1 - fr) * v[it, ir] + (1 - ft) * fr * v[it, ir + 1]
           + ft * (1 - fr) * v[it + 1, ir] + ft * fr * v[it + 1, ir + 1])
    return torch.exp(out) if T.log_space else out


def _trap(pb: int, w0: bool, wlast: bool, like: torch.Tensor):
    t = [1.0] * pb
    if w0:
        t[0] = 0.5
    if wlast:
        t[pb - 1] = 0.5
    return [_scalar(v, like) for v in t]


def fold_plain(a: Optional[torch.Tensor], b: Optional[torch.Tensor], *,
               mode: int, table: Optional[Table], w0: bool, wlast: bool,
               tau: Optional[torch.Tensor], em: Optional[torch.Tensor],
               wout: Optional[torch.Tensor] = None) -> None:
    """Plain version of ``fold``, in place."""
    like = a if a is not None else b
    pb = like.shape[0]
    trap = _trap(pb, w0, wlast, like)
    st = torch.zeros(like.shape[1:], dtype=torch.float32, device=like.device)
    se = torch.zeros_like(st)
    for j in range(pb):
        if mode == 0:
            rho, te = a[j], b[j]
            w = lookup_plain(table, te, rho) * rho
            t2 = te * te
            jv = w * (t2 * t2)
        else:
            w = None if a is None else a[j]
            jv = None if b is None else b[j]
        if w is not None:
            st = st + trap[j] * w
            if wout is not None:
                wout[j] = w
        if jv is not None:
            se = se + trap[j] * jv
    if tau is not None:
        tau.copy_(tau + st)
    if em is not None:
        em.copy_(em + se)


def _table_args(table: Optional[Table]):
    if table is None:
        return (None,) + (None, None, 0, 0, 0.0, 0.0, 0, 0) * 2 + (0, 0.0,
                                                                    0.0)
    out = [table.corners.data_ptr()]
    for a in (table.t_axis, table.r_axis):
        out += [a.cell.data_ptr(), a.guide.data_ptr(), a.cell.shape[0],
                a.guide.shape[0], a.a0, a.inv_h, a.steps, int(a.exact_div)]
    return (*out, int(table.log_space), float(table.t_min),
            float(table.r_min))


def _check_table(table: Table, dev) -> None:
    for name, t, dt in (
            ("lt", table.lt, torch.float32), ("lr", table.lr, torch.float32),
            ("vals", table.vals, torch.float32),
            ("corners", table.corners, torch.float32),
            ("t_axis.cell", table.t_axis.cell, torch.float32),
            ("t_axis.guide", table.t_axis.guide, torch.int32),
            ("r_axis.cell", table.r_axis.cell, torch.float32),
            ("r_axis.guide", table.r_axis.guide, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"the table's {name} must be contiguous {dt} "
                             f"on {dev}")
    n_t, n_r = table.lt.shape[0], table.lr.shape[0]
    if n_t < 2 or n_r < 2:
        raise ValueError("the kernels' opacity table needs two nodes or more "
                         f"on each axis, got ({n_t}, {n_r})")
    if (tuple(table.corners.shape) != (n_t - 1, n_r - 1, 4)
            or tuple(table.t_axis.cell.shape) != (n_t, 4)
            or tuple(table.r_axis.cell.shape) != (n_r, 4)):
        raise ValueError("the table's kernel forms do not match its axes "
                         "(build it with make_table)")


def _check_out(name: str, t: Optional[torch.Tensor], shape, dev) -> None:
    if t is not None and (t.device != dev or t.dtype != torch.float32
                          or not t.is_contiguous()
                          or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name} must be a contiguous float32 {shape} "
                         f"tensor on {dev}")


def fold(a: Optional[torch.Tensor], b: Optional[torch.Tensor], *,
         mode: int, table: Optional[Table], w0: bool, wlast: bool,
         tau: Optional[torch.Tensor], em: Optional[torch.Tensor],
         wout: Optional[torch.Tensor] = None) -> None:
    """Fold a batch of pb planes, (pb, na, nb) float32 views of any
    strides: mode 0, ``a`` rho and ``b`` Te with the opacity ``table``;
    mode 1, ``a`` the w planes and ``b`` the emission planes (either None
    where its output is). Adds the trapezoid sums (end weights 1/2 on the
    batch's first plane when ``w0``, its last when ``wlast``) to the (na,
    nb) images ``tau`` and ``em`` (None: not wanted) in place; ``wout``, a
    contiguous (pb, na, nb) scratch, receives w."""
    like = a if a is not None else b
    if like.device.type == "cpu":
        fold_plain(a, b, mode=mode, table=table, w0=w0, wlast=wlast,
                   tau=tau, em=em, wout=wout)
        return
    dev = like.device
    refuse_grad("xray.fold (K15)", a, b)
    pb, na, nb = like.shape
    for name, t in (("a", a), ("b", b)):
        if t is not None and (t.device != dev or t.dtype != torch.float32
                              or tuple(t.shape) != (pb, na, nb)):
            raise ValueError(f"{name} must be a float32 (pb, na, nb) tensor "
                             f"on {dev}")
    if mode == 0:
        if a is None or b is None or table is None:
            raise ValueError("mode 0 takes rho, Te and a table")
        _check_table(table, dev)
    elif (a is None and (tau is not None or wout is not None)) or (
            b is None and em is not None):
        raise ValueError("mode 1 takes the w planes for tau and wout, the "
                         "emission planes for em")
    if a is not None and b is not None and a.stride() != b.stride():
        raise ValueError("the two volumes must share their strides")
    _check_out("tau", tau, (na, nb), dev)
    _check_out("em", em, (na, nb), dev)
    _check_out("wout", wout, (pb, na, nb), dev)
    if na * nb >= 2**31:
        raise ValueError(f"a batch of {na} x {nb} pixels: K15 takes fewer "
                         "than 2^31")
    sp, sa, sb = like.stride()

    def ptr(t):
        return None if t is None else t.data_ptr()

    FOLD_KERNEL.launch("xray_fold", dev, ptr(a), ptr(b), sp, sa, sb, pb, na,
                       nb, int(w0), int(wlast), mode,
                       *_table_args(table if mode == 0 else None), ptr(tau),
                       ptr(em), ptr(wout))


def pp_fold_plain(w: torch.Tensor, da: torch.Tensor, db: torch.Tensor,
                  fracs: torch.Tensor, wts: torch.Tensor, ca0: float,
                  cb0: float, inv_sa: float, inv_sb: float,
                  tau: torch.Tensor) -> None:
    """Plain version of ``pp_fold``, in place."""
    pb, na, nb = w.shape
    flat = w.reshape(pb, -1)
    c_a, c_b, i_a, i_b = (_scalar(v, w) for v in (ca0, cb0, inv_sa, inv_sb))
    acc = torch.zeros_like(tau)
    for j in range(pb):
        qa = (da * fracs[j] + c_a) * i_a
        qb = (db * fracs[j] + c_b) * i_b
        inside = (qa >= 0) & (qa <= na - 1) & (qb >= 0) & (qb <= nb - 1)
        ia = torch.clamp(torch.floor(qa).nan_to_num(0.0), 0, na - 2)
        ib = torch.clamp(torch.floor(qb).nan_to_num(0.0), 0, nb - 2)
        fa = torch.clamp(qa - ia, 0.0, 1.0)
        fb = torch.clamp(qb - ib, 0.0, 1.0)
        base = ia.long() * nb + ib.long()
        v = ((1 - fa) * (1 - fb) * flat[j][base]
             + (1 - fa) * fb * flat[j][base + 1]
             + fa * (1 - fb) * flat[j][base + nb]
             + fa * fb * flat[j][base + nb + 1])
        v = torch.where(inside, v, torch.zeros_like(v))
        acc = acc + wts[j] * v
    tau.copy_(tau + acc)


def pp_fold(w: torch.Tensor, da: torch.Tensor, db: torch.Tensor,
            fracs: torch.Tensor, wts: torch.Tensor, ca0: float, cb0: float,
            inv_sa: float, inv_sb: float, tau: torch.Tensor) -> None:
    """Add the plane-crossing samples of a batch's contiguous (pb, na, nb)
    w planes to the (P,) point-projection depth ``tau``, in place: chord p
    crosses plane j at in-plane index ((da[p] fracs[j] + ca0) inv_sa,
    (db[p] fracs[j] + cb0) inv_sb), sampled bilinearly (zero outside) and
    weighted by ``wts[j]``. All float32 on one device."""
    if w.device.type == "cpu":
        pp_fold_plain(w, da, db, fracs, wts, ca0, cb0, inv_sa, inv_sb, tau)
        return
    dev = w.device
    refuse_grad("xray.pp_fold (K16)", w, da, db, fracs, wts)
    pb, na, nb = w.shape
    P = da.shape[0]
    _check_out("w", w, (pb, na, nb), dev)
    for name, t, n in (("da", da, P), ("db", db, P), ("fracs", fracs, pb),
                       ("wts", wts, pb), ("tau", tau, P)):
        _check_out(name, t, (n,), dev)
    PP_FOLD_KERNEL.launch("pp_fold", dev, w.data_ptr(), pb, na, nb,
                          da.data_ptr(), db.data_ptr(), P, fracs.data_ptr(),
                          wts.data_ptr(), float(ca0), float(cb0),
                          float(inv_sa), float(inv_sb), tau.data_ptr())


class ChordGeometry(NamedTuple):
    """The chord sampler's geometry, float32 values: the grid's origin and
    reciprocal spacings, the box corners ``lo`` / ``hi``, the source, the
    detector's transverse centre (ca, cb) and plane ``det_p``, the pixel
    offsets ``xa`` (na,) / ``xb`` (nb,) [m] and the axes (p, a, b)."""
    origin: Sequence[float]
    inv: Sequence[float]
    lo: Sequence[float]
    hi: Sequence[float]
    src: Sequence[float]
    ca: float
    cb: float
    det_p: float
    xa: torch.Tensor
    xb: torch.Tensor
    axes: Tuple[int, int, int]


def _chord_frame(g: ChordGeometry, dev):
    """(d, t_in, seg, path_cm) of every chord, (P, 3) and (P,), float32."""
    f32 = torch.float32
    p_ax, a_ax, b_ax = g.axes
    na, nb = g.xa.shape[0], g.xb.shape[0]
    A = (g.ca + g.xa.to(dev)).repeat_interleave(nb)
    B = (g.cb + g.xb.to(dev)).repeat(na)
    det = torch.empty((na * nb, 3), dtype=f32, device=dev)
    det[:, a_ax], det[:, b_ax], det[:, p_ax] = A, B, g.det_p
    src = torch.tensor(list(g.src), dtype=f32, device=dev)
    lo = torch.tensor(list(g.lo), dtype=f32, device=dev)
    hi = torch.tensor(list(g.hi), dtype=f32, device=dev)
    d = det - src
    safe = torch.where(d.abs() > 0, d, torch.full_like(d, 1e-30))
    t1 = (lo - src) / safe
    t2 = (hi - src) / safe
    t_in = torch.minimum(t1, t2).amax(dim=1)
    t_out = torch.maximum(t1, t2).amin(dim=1)
    seg = torch.clamp_min(t_out - t_in, 0.0)
    norm = torch.sqrt(fma(d[:, 2], d[:, 2], fma(d[:, 1], d[:, 1],
                                                d[:, 0] * d[:, 0])))
    return d, t_in, seg, seg * norm * 100.0, src


def pp_chords_plain(rho: torch.Tensor, te: torch.Tensor, g: ChordGeometry,
                    n_steps: int, mode: int, table: Optional[Table]):
    """Plain version of ``pp_chords``."""
    dev = rho.device
    d, t_in, seg, path100, src = _chord_frame(g, dev)
    rcp = _scalar(1.0, rho) / _scalar(float(n_steps - 1), rho)
    path = path100 * rcp
    fields = torch.stack([rho, te], -1)
    o = torch.tensor(list(g.origin), dtype=torch.float32, device=dev)
    inv = torch.tensor(list(g.inv), dtype=torch.float32, device=dev)
    acc = torch.zeros_like(seg)
    samples = []
    for k in range(n_steps):
        s = _scalar(1.0, rho) if k == n_steps - 1 else float(k) * rcp
        t = fma(seg, s, t_in)
        pos = fma(t[:, None], d, src)
        smp = trilinear(fields, pos, o, inv, contract=True)
        if mode == 0:
            trap = 0.5 if k in (0, n_steps - 1) else 1.0
            w = lookup_plain(table, smp[:, 1], smp[:, 0]) * smp[:, 0]
            acc = fma(w, _scalar(trap, rho), acc)
        else:
            samples.append(smp)
    if mode == 0:
        return acc * path
    smp = torch.stack(samples)
    return smp[..., 0].contiguous(), smp[..., 1].contiguous(), path


def pp_chords(rho: torch.Tensor, te: torch.Tensor, g: ChordGeometry,
              n_steps: int, mode: int = 0, table: Optional[Table] = None):
    """Sample every chord from the source to a detector pixel (P = na nb,
    row-major) at ``n_steps`` points of its in-box segment, trilinearly in
    the (nx, ny, nz) float32 volumes ``rho`` and ``te`` (any strides).
    Mode 0: the (P,) optical depth, the trapezoid sum of kappa(Te, rho) rho
    from ``table`` times the chord's step length in cm. Mode 1: the
    (n_steps, P) samples of rho and of Te, and the (P,) step lengths."""
    if rho.device.type == "cpu":
        return pp_chords_plain(rho, te, g, n_steps, mode, table)
    dev = rho.device
    refuse_grad("xray.pp_chords (K16)", rho, te)
    if (te.device != dev or rho.dtype != torch.float32
            or te.dtype != torch.float32 or rho.shape != te.shape
            or rho.dim() != 3 or rho.stride() != te.stride()):
        raise ValueError("rho and Te must be (nx, ny, nz) float32 tensors "
                         "of one device and the same strides")
    if n_steps < 2:
        raise ValueError(f"n_steps must be >= 2, got {n_steps}")
    na, nb = g.xa.shape[0], g.xb.shape[0]
    P = na * nb
    geo = torch.tensor([*g.origin, *g.inv, *g.lo, *g.hi, *g.src, g.ca, g.cb,
                        g.det_p], dtype=torch.float32)
    xa = g.xa.to(dev, torch.float32).contiguous()
    xb = g.xb.to(dev, torch.float32).contiguous()
    f32 = dict(dtype=torch.float32, device=dev)
    if mode == 0:
        _check_table(table, dev)
        tau = torch.empty((P,), **f32)
        rho_s = te_s = path = None
    else:
        tau = None
        rho_s = torch.empty((n_steps, P), **f32)
        te_s = torch.empty((n_steps, P), **f32)
        path = torch.empty((P,), **f32)

    def ptr(t):
        return None if t is None else t.data_ptr()

    PP_CHORDS_KERNEL.launch(
        "pp_chords", dev, rho.data_ptr(), te.data_ptr(), *rho.stride(),
        *rho.shape, geo.data_ptr(), xa.data_ptr(), xb.data_ptr(), na, nb,
        *g.axes, int(n_steps), mode, *_table_args(table if mode == 0
                                                  else None),
        ptr(tau), ptr(rho_s), ptr(te_s), ptr(path))
    return tau if mode == 0 else (rho_s, te_s, path)
