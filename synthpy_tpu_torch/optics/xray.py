"""Synthetic X-ray radiography and self-emission imaging (PyTorch port of
``synthpy_tpu.optics.xray``).

PROPACEOS-style (T, rho) opacity tables (``io.eos.read_propaceos``)
become log-bilinear lookups (``make_opacity_lookup``, an
``OpacityLookup``) that drive straight-line transport through (rho, Te)
grids: parallel-beam attenuation radiographs, grey-body self-emission
images and magnified point-projection radiographs, dense (volumes on the
device) or streamed from host volumes in probing-axis plane batches.

**Routes.** The kernels K15 (``kernels.xray.fold``) and K16
(``pp_fold``, ``pp_chords``) do the geometry and the sums. Each function
is routed by its own type: an ``OpacityLookup`` as ``kappa_fn``, and a
``grey_emissivity`` of an ``OpacityLookup`` as ``emiss_fn``, go to the
fused kernels, which evaluate the table per voxel or sample (one K15 pass
gives both when they share the lookup). Any other callable is evaluated
in PyTorch on the plane batch (or on the chord samples) and the kernels
fold what it gives. The route is chosen by the objects' types alone.

Units follow the PROPACEOS convention: kappa in cm^2/g, rho in g/cm^3, Te
in eV; grid coordinates in meters (path lengths become cm inside the
integrals). Entry points run on ``device`` when it is given. Without it
(``device=None``, the default) the dense ones run where tensor volumes
are, the streamed ones keep device volumes where they are and stream host
volumes (numpy arrays or CPU tensors) to the card, and arrays go to the
card.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from synthpy_tpu_torch import _device
from synthpy_tpu_torch.kernels import xray as kx
from synthpy_tpu_torch.ops.interp import grid_geometry

_AXIS_OF = {"x": 0, "y": 1, "z": 2}


def _f32(a, device=None) -> torch.Tensor:
    """A float32 tensor of ``a`` (numpy, scalars, tensors) on ``device``
    (a tensor's own device, or the CPU, when None)."""
    if isinstance(a, torch.Tensor):
        return a.to(device if device is not None else a.device,
                    torch.float32)
    return torch.from_numpy(np.array(a, np.float32)).to(
        device if device is not None else "cpu")


class OpacityLookup:
    """kappa(Te, rho) over a (n_T, n_rho) table sampled on log axes:
    bilinear in (log T, log rho) of log(table) (``log_space``) or of the
    table, clamped to the table's edges (``make_opacity_lookup``).

    Holds the log axes ``lt`` and ``lr``, ``vals`` and the grids' first
    nodes on ``device``. Calling it runs the plain PyTorch lookup on the
    inputs' device; the X-ray kernels K15 and K16 evaluate the same table
    inline when it is passed as ``kappa_fn``."""

    def __init__(self, lt: torch.Tensor, lr: torch.Tensor,
                 vals: torch.Tensor, log_space: bool, t_min: float,
                 r_min: float, device):
        self.device = torch.device(device)
        self.lt = lt.to(self.device)
        self.lr = lr.to(self.device)
        self.vals = vals.to(self.device)
        self.log_space = bool(log_space)
        self.t_min = float(t_min)
        self.r_min = float(r_min)
        self._tables = {}

    def table(self, device) -> kx.Table:
        """The table on ``device`` (copied there once)."""
        dev = torch.device(device)
        if dev not in self._tables:
            self._tables[dev] = kx.make_table(
                self.lt, self.lr, self.vals, self.log_space, self.t_min,
                self.r_min, dev)
        return self._tables[dev]

    def __call__(self, Te, rho) -> torch.Tensor:
        like = Te if isinstance(Te, torch.Tensor) else rho
        dev = like.device if isinstance(like, torch.Tensor) else self.device
        return kx.lookup_plain(self.table(dev), _f32(Te, dev),
                               _f32(rho, dev))


def make_opacity_lookup(T_grid, rho_grid, table, *, log_space: bool = True,
                        device="cuda") -> OpacityLookup:
    """kappa(Te, rho) lookup over a PROPACEOS-style table.

    ``T_grid`` (n_T,) [eV] and ``rho_grid`` (n_rho,) ascending and
    strictly positive (the interpolation axes are log T and log rho in
    either space); ``table`` (n_T, n_rho) [cm^2/g], strictly positive when
    ``log_space`` (interpolate log(table)); ``log_space=False``
    interpolates the values linearly. Queries outside the table clamp to
    its edges. The table is built in float32 on the CPU and held on
    ``device``."""
    T_grid = _f32(T_grid, "cpu")
    rho_grid = _f32(rho_grid, "cpu")
    table = _f32(table, "cpu")
    if tuple(table.shape) != (T_grid.shape[0], rho_grid.shape[0]):
        raise ValueError(
            f"table shape {tuple(table.shape)} does not match grids "
            f"({T_grid.shape[0]}, {rho_grid.shape[0]})")
    if float(T_grid[0]) <= 0.0 or float(rho_grid[0]) <= 0.0:
        raise ValueError(
            "T_grid and rho_grid must be strictly positive ascending "
            "(the lookup axes are log-spaced regardless of log_space)")
    vals = torch.log(table) if log_space else table
    return OpacityLookup(torch.log(T_grid), torch.log(rho_grid), vals,
                         log_space, float(T_grid[0]), float(rho_grid[0]),
                         _device.resolve(device))


class GreyEmissivity:
    """The grey-body volume emissivity j(Te, rho) = kappa(Te, rho) rho
    Te^4 of ``kappa_fn`` (relative units; ``grey_emissivity``). Records
    its ``kappa_fn``, so that the kernels fuse it when that is an
    ``OpacityLookup``."""

    def __init__(self, kappa_fn: Callable):
        self.kappa_fn = kappa_fn

    def __call__(self, Te, rho) -> torch.Tensor:
        t2 = Te * Te
        return self.kappa_fn(Te, rho) * rho * (t2 * t2)


def grey_emissivity(kappa_fn: Callable) -> GreyEmissivity:
    """Grey-body volume emissivity j(Te, rho) = kappa_e rho Te^4
    (Kirchhoff's law with a frequency-integrated Planck source; the
    sigma/pi constant left out, so images are in relative units)."""
    return GreyEmissivity(kappa_fn)


def _transverse_axes(probing_direction: str) -> Tuple[int, int, int]:
    p_ax = _AXIS_OF[probing_direction]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    return p_ax, a_ax, b_ax


def _lookup_of(emiss_fn) -> Optional[OpacityLookup]:
    """The ``OpacityLookup`` of a ``grey_emissivity`` of one (the fused
    emission route), else None."""
    if isinstance(emiss_fn, GreyEmissivity) and isinstance(
            emiss_fn.kappa_fn, OpacityLookup):
        return emiss_fn.kappa_fn
    return None


def _vol(a, device) -> torch.Tensor:
    """A dense volume as float32 on ``device``; with None, a tensor where
    it is and an array on the card."""
    if device is None:
        device = a.device if isinstance(a, torch.Tensor) else "cuda"
    return _f32(a, _device.resolve(device))


def _plane_integral(weight: torch.Tensor, spacing_m: float,
                    p_ax: int) -> torch.Tensor:
    """Trapezoid line integral of an (nx, ny, nz) weight field along
    p_ax, in cm (K15 over the whole volume as one batch)."""
    w = _f32(weight).movedim(p_ax, 0)
    tau = torch.zeros(w.shape[1:], dtype=torch.float32, device=w.device)
    kx.fold(w, None, mode=1, table=None, w0=True, wlast=True, tau=tau,
            em=None)
    return tau * (spacing_m * 100.0)


def _dense_fold(r, t, kappa_fn, p_ax: int, spacing_m: float,
                want_tau: bool, want_em: bool):
    """(tau, em) line integrals [cm] of the fused route over the volumes
    (K15 mode 0, the whole volume one batch)."""
    r = r.movedim(p_ax, 0)
    t = t.movedim(p_ax, 0)
    if r.stride() != t.stride():
        r, t = r.contiguous(), t.contiguous()
    z = [torch.zeros(r.shape[1:], dtype=torch.float32, device=r.device)
         if want else None for want in (want_tau, want_em)]
    kx.fold(r, t, mode=0, table=kappa_fn.table(r.device), w0=True,
            wlast=True, tau=z[0], em=z[1])
    scale = spacing_m * 100.0
    return [None if v is None else v * scale for v in z]


def attenuation_image(rho, Te, kappa_fn: Callable, spacing_m: float,
                      probing_direction: str = "z",
                      device=None) -> torch.Tensor:
    """Parallel-beam transmission image exp(-integral of kappa rho ds): a
    trapezoid sum over probing-axis planes per transverse cell. Returns
    (na, nb) over the two other axes in x < y < z order. Runs on
    ``device``; with None, where a tensor ``rho`` is (an array on the
    card)."""
    p_ax, _, _ = _transverse_axes(probing_direction)
    r = _vol(rho, device)
    t = _f32(Te, r.device)
    if isinstance(kappa_fn, OpacityLookup):
        tau, _ = _dense_fold(r, t, kappa_fn, p_ax, spacing_m, True, False)
    else:
        tau = _plane_integral(kappa_fn(t, r) * r, spacing_m, p_ax)
    return torch.exp(-tau)


def self_emission_image(rho, Te, emiss_fn: Callable, spacing_m: float,
                        probing_direction: str = "z",
                        device=None) -> torch.Tensor:
    """Optically-thin self-emission image: the integral of j(Te, rho) ds
    [per cm path], with ``emiss_fn`` the volume emissivity
    (``grey_emissivity`` or any callable)."""
    p_ax, _, _ = _transverse_axes(probing_direction)
    r = _vol(rho, device)
    t = _f32(Te, r.device)
    if _lookup_of(emiss_fn) is not None:
        _, em = _dense_fold(r, t, _lookup_of(emiss_fn), p_ax, spacing_m,
                            False, True)
        return em
    return _plane_integral(emiss_fn(t, r), spacing_m, p_ax)


def _pixel_offsets(n: int, L: float) -> torch.Tensor:
    """(n,) float32 pixel centres [m] of a detector side of L mm:
    ((i + 0.5) / n) (L 1e-3) - L 5e-4 in float32 (XLA's constant folding
    of the jitted sampler's same expression differs in the last place on
    some pixels)."""
    i = torch.arange(n, dtype=torch.float32)
    return (i + 0.5) / torch.tensor(float(n)) * np.float32(L * 1e-3) \
        - np.float32(L * 5e-4)


def chord_geometry(coords: Sequence, source_distance: float,
                   detector_distance: float, bins: Tuple[int, int],
                   Lx: float, Ly: float,
                   probing_direction: str = "z") -> kx.ChordGeometry:
    """The chord sampler's float32 geometry (``kernels.xray.pp_chords``):
    the grid of the uniform ``coords``, the source ``source_distance``
    before the box and the detector plane ``detector_distance`` past it,
    both on the box's transverse midpoint, and the pixel offsets, as the
    jitted JAX sampler computes them."""
    coords = [_f32(c, "cpu") for c in coords]
    origin, inv = grid_geometry(coords)
    lo = torch.stack([c[0] for c in coords])
    hi = torch.stack([c[-1] for c in coords])
    p_ax, a_ax, b_ax = _transverse_axes(probing_direction)
    ca = 0.5 * (lo[a_ax] + hi[a_ax])
    cb = 0.5 * (lo[b_ax] + hi[b_ax])
    src = torch.zeros(3)
    src[p_ax] = lo[p_ax] - np.float32(source_distance)
    src[a_ax], src[b_ax] = ca, cb
    return kx.ChordGeometry(
        origin.tolist(), inv.tolist(), lo.tolist(), hi.tolist(),
        src.tolist(), float(ca), float(cb),
        float(hi[p_ax] + np.float32(detector_distance)),
        _pixel_offsets(bins[0], Lx), _pixel_offsets(bins[1], Ly),
        (p_ax, a_ax, b_ax))


def point_projection_radiograph(
    rho, Te, kappa_fn: Callable, coords: Sequence, source_distance: float,
    detector_distance: float, bins: Tuple[int, int] = (431, 321),
    Lx: float = 18.0, Ly: float = 13.5, n_steps: int = 96,
    probing_direction: str = "z", device=None,
) -> torch.Tensor:
    """Magnified point-projection transmission radiograph.

    A point source sits ``source_distance`` [m] before the box on the
    probing axis, the detector ``detector_distance`` [m] past it with
    half-sizes Lx/2 x Ly/2 [mm]; both ride the box's transverse midpoint.
    Each of the bins[0] x bins[1] pixels casts one chord to the source;
    its optical depth is the trapezoid sum of kappa rho at ``n_steps``
    trilinear samples of the chord's in-box segment (K16's ``pp_chords``;
    an ``OpacityLookup`` is evaluated inline, any other ``kappa_fn`` in
    PyTorch on the samples, summed by K15). Returns (bins[0], bins[1])
    transmission exp(-tau)."""
    if int(n_steps) < 2:
        raise ValueError(
            f"n_steps must be >= 2 (trapezoid chord sampling), got {n_steps}")
    r = _vol(rho, device)
    t = _f32(Te, r.device)
    if r.stride() != t.stride():
        r, t = r.contiguous(), t.contiguous()
    g = chord_geometry(coords, source_distance, detector_distance, bins, Lx,
                       Ly, probing_direction)
    n_steps = int(n_steps)
    if isinstance(kappa_fn, OpacityLookup):
        tau = kx.pp_chords(r, t, g, n_steps, 0, kappa_fn.table(r.device))
    else:
        rho_s, te_s, path = kx.pp_chords(r, t, g, n_steps, 1)
        w = (kappa_fn(te_s, rho_s) * rho_s).reshape(n_steps, 1, -1)
        tau = torch.zeros((1, w.shape[2]), dtype=torch.float32,
                          device=r.device)
        kx.fold(w, None, mode=1, table=None, w0=True, wlast=True, tau=tau,
                em=None)
        tau = tau[0] * path
    return torch.exp(-tau).reshape(bins[0], bins[1])


# -- streamed variants: host volumes, one plane batch on the card at a time


class _Planes:
    """Probing-axis plane batches of a volume (numpy array, CPU tensor or
    device tensor) as contiguous float32 (pb, na, nb) tensors on ``dev``.
    A host volume is gathered batch by batch into one of two pinned
    staging buffers and copied up without blocking, so the gather of the
    next batch overlaps the copy and the kernels of this one."""

    def __init__(self, vol, p_ax: int, dev: torch.device, plane_batch: int):
        if not isinstance(vol, torch.Tensor):
            with warnings.catch_warnings():
                # a read-only array (np.broadcast_to) is only read here
                warnings.simplefilter("ignore", UserWarning)
                vol = torch.from_numpy(np.asarray(vol))
        self.v = vol.movedim(p_ax, 0)
        self.dev = dev
        self.stage = self.events = None
        if self.v.device.type == "cpu" and dev.type == "cuda":
            shape = (min(plane_batch, self.v.shape[0]), *self.v.shape[1:])
            self.stage = [torch.empty(shape, dtype=torch.float32,
                                      pin_memory=True) for _ in range(2)]
            self.events = [None, None]

    @property
    def shape(self):
        return tuple(self.v.shape)

    def get(self, k: int, i0: int, i1: int) -> torch.Tensor:
        src = self.v[i0:i1]
        if self.stage is None:
            return src.to(self.dev, torch.float32).contiguous()
        if self.events[k % 2] is not None:
            self.events[k % 2].synchronize()
        st = self.stage[k % 2][:i1 - i0]
        st.copy_(src)
        out = st.to(self.dev, non_blocking=True)
        self.events[k % 2] = torch.cuda.Event()
        self.events[k % 2].record()
        return out


def _stream_device(rho, device) -> torch.device:
    """``device`` when given; else a device volume's own, or the card."""
    if device is None:
        device = (rho.device if isinstance(rho, torch.Tensor)
                  and rho.device.type != "cpu" else "cuda")
    return _device.resolve(device)


def radiography_streamed(
    rho, Te, kappa_fn: Callable, spacing_m: float,
    probing_direction: str = "z", emiss_fn: Optional[Callable] = None,
    plane_batch: int = 32, device=None,
):
    """Parallel-beam attenuation (and optional self-emission) from host
    volumes, streamed in probing-axis plane batches: only ``plane_batch``
    planes of each volume are on the card at a time. Returns
    ``transmission`` (na, nb), or ``(transmission, emission)`` when
    ``emiss_fn`` is given; the same fold as ``attenuation_image`` /
    ``self_emission_image``, batch by batch (K15)."""
    return _survey(rho, Te, kappa_fn, spacing_m, probing_direction,
                   emiss_fn, plane_batch, device, pp=None)["parallel"]


def _pp_frame(coords, p_ax, a_ax, b_ax, source_distance, detector_distance,
              bins, Lx, Ly):
    """The plane-crossing geometry on the host, in numpy as the JAX
    package computes it: (da, db, dl_cm, fracs_all, trap, ca - pa[0],
    cb - pb[0], 1 / sa, 1 / sb, dp)."""
    coords = [np.asarray(c, dtype=np.float32) for c in coords]
    na_px, nb_px = bins
    pa, pb, pp = coords[a_ax], coords[b_ax], coords[p_ax]
    n_p = pp.shape[0]
    dp = float(pp[1] - pp[0])
    ca = 0.5 * (pa[0] + pa[-1])
    cb = 0.5 * (pb[0] + pb[-1])
    src_p = float(pp[0]) - float(source_distance)
    det_p = float(pp[-1]) + float(detector_distance)
    xa = (np.arange(na_px, dtype=np.float32) + 0.5) / na_px * (Lx * 1e-3) \
        - Lx * 5e-4 + ca
    xb = (np.arange(nb_px, dtype=np.float32) + 0.5) / nb_px * (Ly * 1e-3) \
        - Ly * 5e-4 + cb
    A, B = np.meshgrid(xa, xb, indexing="ij")
    span_p = det_p - src_p
    da = (A.ravel() - ca)
    db = (B.ravel() - cb)
    dl_cm = np.sqrt(da**2 + db**2 + span_p**2) / span_p * dp * 100.0
    trap = np.ones((n_p,), np.float32)
    trap[0] = trap[-1] = 0.5
    fracs_all = (pp.astype(np.float64) - src_p) / span_p
    return (da, db, dl_cm, fracs_all, trap, ca - pa[0], cb - pb[0],
            1.0 / float(pa[1] - pa[0]), 1.0 / float(pb[1] - pb[0]), dp)


def _survey(rho, Te, kappa_fn, spacing_m, probing_direction, emiss_fn,
            plane_batch, device, pp) -> Dict[str, object]:
    """One pass over the volumes' plane batches feeding the parallel-beam
    depth, the optional emission and, with ``pp`` (the ``_pp_frame``), the
    point-projection depth. Returns {"parallel": transmission or
    (transmission, emission), "tau_pp": (P,) or None}."""
    p_ax, _, _ = _transverse_axes(probing_direction)
    dev = _stream_device(rho, device)
    R = _Planes(rho, p_ax, dev, plane_batch)
    T = _Planes(Te, p_ax, dev, plane_batch)
    n_p, na, nb = R.shape
    want_emiss = emiss_fn is not None
    # each function by its own type; one K15 pass when they share a lookup
    k_tab = (kappa_fn.table(dev) if isinstance(kappa_fn, OpacityLookup)
             else None)
    e_lookup = _lookup_of(emiss_fn)
    e_tab = None if e_lookup is None else e_lookup.table(dev)
    shared = k_tab is not None and e_tab is k_tab
    f32 = dict(dtype=torch.float32, device=dev)
    tau = torch.zeros((na, nb), **f32) if spacing_m is not None else None
    em = torch.zeros((na, nb), **f32) if want_emiss else None
    tau_pp = wbuf = None
    if pp is not None:
        da, db, _, fracs_all, trap, ca0, cb0, inv_sa, inv_sb, _ = pp
        da_d = torch.from_numpy(np.asarray(da, np.float32)).to(dev)
        db_d = torch.from_numpy(np.asarray(db, np.float32)).to(dev)
        fr_d = torch.from_numpy(fracs_all.astype(np.float32)).to(dev)
        tr_d = torch.from_numpy(trap).to(dev)
        tau_pp = torch.zeros((da_d.shape[0],), **f32)
        if k_tab is not None:
            wbuf = torch.empty((min(plane_batch, n_p), na, nb), **f32)
    for k, i0 in enumerate(range(0, n_p, plane_batch)):
        i1 = min(i0 + plane_batch, n_p)
        rho_b, te_b = R.get(k, i0, i1), T.get(k, i0, i1)
        w0, wlast = i0 == 0, i1 == n_p
        if k_tab is not None:
            wout = None if wbuf is None else wbuf[:i1 - i0]
            kx.fold(rho_b, te_b, mode=0, table=k_tab, w0=w0, wlast=wlast,
                    tau=tau, em=em if shared else None, wout=wout)
            w = wout
        else:
            w = (kappa_fn(te_b, rho_b) * rho_b).contiguous()
            if tau is not None:
                kx.fold(w, None, mode=1, table=None, w0=w0, wlast=wlast,
                        tau=tau, em=None)
        if want_emiss and not shared:
            if e_tab is not None:
                kx.fold(rho_b, te_b, mode=0, table=e_tab, w0=w0,
                        wlast=wlast, tau=None, em=em)
            else:
                kx.fold(None, emiss_fn(te_b, rho_b).contiguous(), mode=1,
                        table=None, w0=w0, wlast=wlast, tau=None, em=em)
        if pp is not None:
            kx.pp_fold(w, da_d, db_d, fr_d[i0:i1], tr_d[i0:i1], float(ca0),
                       float(cb0), float(np.float32(inv_sa)),
                       float(np.float32(inv_sb)), tau_pp)
    out = {"tau_pp": tau_pp, "parallel": None}
    if tau is not None:
        scale = spacing_m * 100.0
        trans = torch.exp(-tau * scale)
        out["parallel"] = (trans, em * scale) if want_emiss else trans
    return out


def xray_survey_streamed(
    rho, Te, kappa_fn: Callable, coords: Sequence, source_distance: float,
    detector_distance: float, bins: Tuple[int, int] = (431, 321),
    Lx: float = 18.0, Ly: float = 13.5, probing_direction: str = "z",
    emiss_fn: Optional[Callable] = None, plane_batch: int = 32,
    device=None,
) -> dict:
    """Every streamed X-ray diagnostic in one pass over (rho, Te): each
    plane batch computes kappa rho once (K15) and folds the parallel-beam
    depth, the optional self-emission and the point-projection depth (K16's
    ``pp_fold``). The folds are those of ``radiography_streamed`` and
    ``point_projection_radiograph_streamed``, so the results are theirs
    bit for bit. Returns {"transmission": (na, nb), "point_projection":
    (bins[0], bins[1])} plus "emission" when ``emiss_fn`` is given."""
    p_ax, a_ax, b_ax = _transverse_axes(probing_direction)
    pp = _pp_frame(coords, p_ax, a_ax, b_ax, source_distance,
                   detector_distance, bins, Lx, Ly)
    res = _survey(rho, Te, kappa_fn, pp[9], probing_direction, emiss_fn,
                  plane_batch, device, pp)
    dl = torch.from_numpy(np.asarray(pp[2], np.float32)).to(
        res["tau_pp"].device)
    par = res["parallel"]
    out = {"transmission": par[0] if emiss_fn is not None else par,
           "point_projection": torch.exp(-res["tau_pp"] * dl).reshape(
               bins[0], bins[1])}
    if emiss_fn is not None:
        out["emission"] = par[1]
    return out


def point_projection_radiograph_streamed(
    rho, Te, kappa_fn: Callable, coords: Sequence, source_distance: float,
    detector_distance: float, bins: Tuple[int, int] = (431, 321),
    Lx: float = 18.0, Ly: float = 13.5, probing_direction: str = "z",
    plane_batch: int = 32, device=None,
) -> torch.Tensor:
    """Point-projection transmission radiograph from host volumes by
    plane-crossing quadrature: every chord crosses each grid plane once,
    and its optical depth is the trapezoid sum of bilinear in-plane
    samples at the crossings times the chord's run length between planes,
    so each uploaded batch folds into the per-pixel depth (K15 for w, K16's
    ``pp_fold``). Agrees with ``point_projection_radiograph`` to
    quadrature tolerance."""
    p_ax, a_ax, b_ax = _transverse_axes(probing_direction)
    pp = _pp_frame(coords, p_ax, a_ax, b_ax, source_distance,
                   detector_distance, bins, Lx, Ly)
    res = _survey(rho, Te, kappa_fn, None, probing_direction, None,
                  plane_batch, device, pp)
    dl = torch.from_numpy(np.asarray(pp[2], np.float32)).to(
        res["tau_pp"].device)
    return torch.exp(-(res["tau_pp"] * dl)).reshape(bins[0], bins[1])
