"""End-to-end pipeline: trace -> optics -> detector (PyTorch port of
``synthpy_tpu.pipeline`` for the incoherent benches).

Tracer back-ends (``run``'s ``solver``):

* ``"zscan"`` (default): the plain slab march (kernel K4,
  ``kernels.slab_march``) across the planes of a ``ZScanPack``;
* ``"zscan_seg"``: the segmented march (K1, ``kernels.march``) over a
  segment pack, built by K2 (``kernels.pack``) unless the caller passes
  ``spack=``;
* ``"time"``: fixed-step RK4 in time (K5, ``kernels.time_march``) over the
  TracePack, the general tracer, which reflects at the critical surface.
  A z-scan solver on a field at ``critical_guard`` of the critical density
  falls back to it with a warning; ``run_split`` routes only the rays
  whose column reaches it there.

The exit state goes through the composed optical bench into a detector
image by kernel K3 (``kernels.detector``). Everything runs on the device
of the domain and rays.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: the coherent benches (A.6), ``solver="analytic"`` (A.9, B6),
``pack_dtype="auto"`` and host-resident packs (A.12), and the mesh modes
(A.17).
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from synthpy_tpu_torch import constants
from synthpy_tpu_torch.fields.domain import (ScalarDomain, TracePack,
                                             build_pack, layout_of,
                                             peak_ne_over_nc)
from synthpy_tpu_torch.kernels.detector import detect
from synthpy_tpu_torch.optics.compose import (BENCHES, NEEDS_JONES,
                                              analyser_weight)
from synthpy_tpu_torch.tracer.propagator import (default_n_steps, dt_of,
                                                 ray_to_Jonesvector,
                                                 trace_rk4)
from synthpy_tpu_torch.tracer.zscan import (_AXIS_OF, PACK_DTYPES,
                                            _not_ported,
                                            build_segment_pack_device,
                                            entry_sort, make_segment_pack,
                                            make_zscan_pack, permute_state,
                                            reassemble_state, trace_zscan,
                                            trace_zscan_segments)


def _check_incoherent(diagnostic) -> None:
    names = (diagnostic,) if isinstance(diagnostic, str) else diagnostic
    for name in names:
        if BENCHES[name][1]:
            raise _not_ported(f"the coherent bench {name!r}", "A.6")


def _image_from_uf(uf: torch.Tensor, p_end, probing_depth: float, *,
                   diagnostic, probing_direction: str, bins,
                   L: float, R: float, Lx: float, Ly: float,
                   focal_plane: float, detL: float | None = None,
                   pol_beta_deg: float = 85.0):
    """(N, 8) permuted exit state -> optics -> detector, for one bench name
    or a tuple of names (then a tuple of images). Every ray sits at the
    probing coordinate ``p_end``, or at its own when ``p_end`` is an (N,)
    tensor.

    The counterpart of the JAX package's ``_image_from_sf``, with
    ``reassemble_state`` fused into the detector kernel. The callers have
    refused the coherent benches before tracing.
    """
    names = (diagnostic,) if isinstance(diagnostic, str) else diagnostic
    Jf = None
    if any(n in NEEDS_JONES for n in names):
        sf = reassemble_state(uf, p_end, probing_direction)
        _, Jf = ray_to_Jonesvector(sf, probing_depth,
                                   probing_direction=probing_direction,
                                   return_E=True)
    range_ = ((-Lx / 2, Lx / 2), (-Ly / 2, Ly / 2))
    images = []
    for name in names:
        builder, _ = BENCHES[name]
        extra = ({"detL": detL} if detL is not None
                 and name == "shadowgraphy_exp" else {})
        stages = builder(L=L, R=R, focal_plane=focal_plane, **extra)
        w = (analyser_weight(Jf, pol_beta_deg).to(torch.float32)
             if name in NEEDS_JONES else None)
        images.append(detect(uf, p_end, probing_depth, probing_direction,
                             stages, bins, range_, weights=w))
    if isinstance(diagnostic, str):
        return images[0]
    return tuple(images)


def _image_from_sf(sf: torch.Tensor, probing_depth: float, *,
                   probing_direction: str, **kw):
    """(9, N) exit state, each ray at its own probing coordinate (the time
    tracer's) -> optics -> detector."""
    uf = permute_state(sf, probing_direction)
    p = sf[_AXIS_OF[probing_direction]].contiguous()
    return _image_from_uf(uf, p, probing_depth,
                          probing_direction=probing_direction, **kw)


def synth_image(
    s_rows: torch.Tensor,
    channels: torch.Tensor,
    origin,
    inv_spacing,
    dt,
    probing_depth: float,
    *,
    layout,
    n_steps: int,
    diagnostic="shadowgraphy",
    probing_direction: str = "z",
    bins: Tuple[int, int] = (431, 321),  # pix/8 of a KAF-8300
    ray_chunk: Optional[int] = None,
    lwl: float = 1064e-9,
    L: float = 400.0,
    R: float = 25.0,
    Lx: float = 18.0,
    Ly: float = 13.5,
    focal_plane: float = 0.0,
    detL: float | None = None,
    pol_beta_deg: float = 85.0,
):
    """Time-tracer pipeline on (N, 9) ray rows: ``n_steps`` RK4 steps of
    ``dt`` (kernel K5), then the bench and detector (K3, each ray from its
    own exit coordinate). Returns the (ny, nx) image (a tuple for a tuple
    of diagnostics). ``lwl`` and ``ray_chunk`` are accepted as in the JAX
    package; the incoherent benches do not read ``lwl``."""
    del lwl
    _check_incoherent(diagnostic)
    sf_rows = trace_rk4(s_rows, channels, origin, inv_spacing, dt,
                        layout=layout, n_steps=n_steps, ray_chunk=ray_chunk)
    return _image_from_sf(
        sf_rows.T, probing_depth, probing_direction=probing_direction,
        diagnostic=diagnostic, bins=bins, L=L, R=R, Lx=Lx, Ly=Ly,
        focal_plane=focal_plane, detL=detL, pol_beta_deg=pol_beta_deg)


def synth_image_zscan(
    s0: torch.Tensor,
    planes: torch.Tensor,
    origin_ab: torch.Tensor,
    inv_ab: torch.Tensor,
    probing_depth: float,
    *,
    layout,
    n_slabs: int,
    p0: float,
    dp_static: float,
    sort_rays: bool = False,
    segmented: bool = False,
    seg_K: Optional[int] = None,
    shape_ab: Optional[Tuple[int, int]] = None,
    substeps: int = 1,
    diagnostic="shadowgraphy",
    probing_direction: str = "z",
    bins: Tuple[int, int] = (431, 321),
    ray_chunk: Optional[int] = None,
    lwl: float = 1064e-9,
    L: float = 400.0,
    R: float = 25.0,
    Lx: float = 18.0,
    Ly: float = 13.5,
    focal_plane: float = 0.0,
    integrator: str = "rk4",
    detL: float | None = None,
    pol_beta_deg: float = 85.0,
    seg_weights: str = "stage",
    seg_scales: Optional[torch.Tensor] = None,
    seg_qbits: Optional[int] = None,
):
    """z-scan pipeline on a (9, N) initial state; returns the (ny, nx)
    image (a tuple for a tuple of diagnostics).

    ``segmented=False``: ``planes`` is a ZScanPack's (n_p, na, nb, C) stack
    and the plain march (kernel K4) crosses ``n_slabs`` intervals with
    ``substeps`` RK4 steps each. ``segmented=True``: ``planes`` is a
    SegmentPack's table and the segmented march (K1) runs ``integrator``.
    ``sort_rays`` reorders the rays by entry cell first, with the JAX
    package's key (the image does not depend on the order); the kernels
    order the rays they march by themselves, so on the card this only
    costs time.
    """
    del lwl
    _check_incoherent(diagnostic)
    if not segmented and integrator != "rk4":
        raise ValueError("integrator is only selectable on the segmented "
                         "(zscan_seg) path; the plain zscan tracer is rk4")
    u = permute_state(s0, probing_direction)
    if sort_rays:
        u = entry_sort(u, origin_ab, inv_ab,
                       shape_ab[1] if segmented else planes.shape[2])
    if segmented:
        n_seg = planes.shape[0]
        uf = trace_zscan_segments(
            u, planes, origin_ab, inv_ab, dp_static, shape_ab=shape_ab,
            layout=layout, K=seg_K, n_seg=n_seg,
            substeps=substeps, integrator=integrator, weights=seg_weights,
            seg_scales=seg_scales, qbits=seg_qbits)
        p_end = p0 + n_seg * seg_K * dp_static
    else:
        uf = trace_zscan(u, planes, origin_ab, inv_ab, dp_static,
                         layout=layout, n_slabs=n_slabs, substeps=substeps,
                         ray_chunk=ray_chunk)
        p_end = p0 + n_slabs * dp_static
    return _image_from_uf(
        uf, p_end, probing_depth,
        diagnostic=diagnostic, probing_direction=probing_direction,
        bins=bins, L=L, R=R, Lx=Lx, Ly=Ly,
        focal_plane=focal_plane, detL=detL, pol_beta_deg=pol_beta_deg)


def _same_device(s0: torch.Tensor, table: torch.Tensor) -> None:
    if s0.device != table.device:
        raise ValueError(f"rays on {s0.device}, pack on {table.device}")


def _segment_pack(domain, lwl, seg_K, pack, zpack, bench_kwargs):
    """The segment pack of ``run(solver="zscan_seg")`` without ``spack``:
    built by K2 at ``pack_dtype`` (default f32), or regrouped from a
    caller's ``zpack`` / ``pack``."""
    n_p = (domain.x, domain.y, domain.z)[
        _AXIS_OF[domain.probing_direction]].shape[0]
    if "pack_dtype" not in bench_kwargs and (pack is not None
                                             or zpack is not None):
        zp = zpack or make_zscan_pack(pack, layout_of(domain),
                                      domain.probing_direction)
        return make_segment_pack(zp, K=min(seg_K, zp.planes.shape[0] - 1))
    pdt = bench_kwargs.pop("pack_dtype", torch.float32)
    if bench_kwargs.pop("pack_dither", None) is not None:
        raise _not_ported("pack_dither=", "A.4")
    if isinstance(pdt, str) and pdt == "auto":
        raise _not_ported("pack_dtype='auto'", "A.12")
    if isinstance(pdt, str):
        pdt = PACK_DTYPES[pdt]
    K_eff = min(seg_K, n_p - 1)
    if pdt == "int4" and K_eff % 2:
        K_eff += 1  # nibble packs pair planes; pads one zero slab
    return build_segment_pack_device(domain, lwl=lwl, K=K_eff, dtype=pdt)


def run(
    domain: ScalarDomain,
    s0: torch.Tensor,
    *,
    diagnostic="shadowgraphy",
    solver: str = "zscan",
    lwl: float = 1064e-9,
    n_steps: Optional[int] = None,
    steps_per_cell: float = 1.0,
    probing_depth: Optional[float] = None,
    pack: Optional[TracePack] = None,
    zpack=None,
    spack=None,
    bins: Tuple[int, int] = (431, 321),
    ray_chunk: Optional[int] = None,
    critical_guard: Optional[float] = 0.85,
    mesh=None,
    ray_axis: str = "rays",
    grid_axis: Optional[str] = None,
    pp_axis: Optional[str] = None,
    **bench_kwargs,
):
    """Trace ``s0`` (9, N) through ``domain`` and synthesise the image.

    ``solver``: "zscan" (default), "zscan_seg" or "time" (see the module
    docstring). Prebuilt packs amortise their build across calls: ``pack``
    (``build_pack``) for "time" and "zscan", ``zpack``
    (``make_zscan_pack``) for "zscan", ``spack``
    (``build_segment_pack_device``) for "zscan_seg"; there
    ``pack_dtype=`` ("f32", "bf16", "int8", "int4" or a torch dtype) builds
    the segment pack at that tier, ``seg_K`` (default 64) sets the slabs
    per segment and ``integrator`` / ``seg_weights`` select the march.
    ``n_steps`` (default ``default_n_steps``) sets the time tracer's steps
    and ``steps_per_cell`` the z-scan substeps. ``sort_rays=True`` orders
    the rays by entry cell first (z-scan solvers).

    ``critical_guard``: a z-scan solver on a field whose max(ne)/nc
    reaches this fraction falls back to ``solver="time"`` with a warning,
    dropping the z-scan-only arguments; None disables the check, which is
    skipped when ``domain.ne`` has been freed.

    ``diagnostic`` may be a list or tuple of names: the bundle is traced
    once and a dict {name: image} is returned. ``ray_chunk`` is accepted
    as in the JAX package and has no effect: the kernels keep no per-ray
    buffer.
    """
    multi = isinstance(diagnostic, (list, tuple))
    diagnostic = tuple(diagnostic) if multi else diagnostic
    if mesh is not None or grid_axis is not None or pp_axis is not None:
        raise _not_ported("mesh=, grid_axis= and pp_axis=", "A.17")
    _check_incoherent(diagnostic)
    if (critical_guard is not None
            and solver in ("zscan", "zscan_seg", "analytic")
            and domain.ne is not None):
        frac = peak_ne_over_nc(domain, lwl)
        if frac >= critical_guard:
            dropped = [k for k in ("integrator", "seg_weights", "seg_cache",
                                   "pack_dtype") if k in bench_kwargs]
            warnings.warn(
                f"max(ne)/nc = {frac:.3f} >= {critical_guard}: z-scan "
                "solvers are ill-conditioned near critical density; "
                "falling back to solver='time'"
                + (f" (dropping {', '.join(dropped)})" if dropped else "")
                + ".", stacklevel=2)
            solver = "time"
            for k in dropped:
                bench_kwargs.pop(k)
    if solver == "analytic":
        raise _not_ported("solver='analytic' (the pack-free analytic "
                          "tracer, B6)", "A.9")
    if solver not in ("zscan", "zscan_seg", "time"):
        raise ValueError(f"unknown solver {solver!r}")
    seg_K = bench_kwargs.pop("seg_K", 64)
    for knob in ("batch_pack_bytes", "batch_corner_bytes"):
        bench_kwargs.pop(knob, None)   # the JAX package's HBM batching
    if probing_depth is None:
        probing_depth = domain.extent
    layout = layout_of(domain)
    substeps = max(int(round(steps_per_cell)), 1)
    common = dict(diagnostic=diagnostic,
                  probing_direction=domain.probing_direction, bins=bins,
                  ray_chunk=ray_chunk, lwl=lwl)
    if solver == "zscan_seg":
        if spack is None:
            spack = _segment_pack(domain, lwl, seg_K, pack, zpack,
                                  bench_kwargs)
        _same_device(s0, spack.seg_planes)
        res = synth_image_zscan(
            s0, spack.seg_planes, spack.origin_ab, spack.inv_spacing_ab,
            probing_depth, layout=layout,
            n_slabs=spack.seg_planes.shape[0] * spack.K, p0=spack.p0,
            dp_static=spack.dp, segmented=True, seg_K=spack.K,
            shape_ab=spack.shape_ab, substeps=substeps,
            seg_scales=spack.scales, seg_qbits=spack.qbits, **common,
            **bench_kwargs)
    elif solver == "zscan":
        zp = zpack or make_zscan_pack(pack or build_pack(domain, lwl),
                                      layout, domain.probing_direction)
        _same_device(s0, zp.planes)
        res = synth_image_zscan(
            s0, zp.planes, zp.origin_ab, zp.inv_spacing_ab, probing_depth,
            layout=layout, n_slabs=zp.planes.shape[0] - 1, p0=zp.p0,
            dp_static=zp.dp, substeps=substeps, **common, **bench_kwargs)
    else:
        if pack is None:
            pack = build_pack(domain, lwl)
        _same_device(s0, pack.channels)
        if n_steps is None:
            n_steps = default_n_steps(domain, probing_depth, steps_per_cell)
        res = synth_image(
            s0.T.contiguous(), pack.channels, pack.origin, pack.inv_spacing,
            dt_of(n_steps, probing_depth), probing_depth, layout=layout,
            n_steps=n_steps, **common, **bench_kwargs)
    return dict(zip(diagnostic, res)) if multi else res


def run_split(
    domain: ScalarDomain,
    s0: torch.Tensor,
    *,
    lwl: float = 1064e-9,
    critical_frac: float = 0.85,
    margin_cells: int = 4,
    pad_to: int = 65536,
    **kwargs,
):
    """Mixed-bundle solve for fields with localised overcritical regions.

    The electron density is reduced to a transverse map of its maximum
    along the probing axis, dilated by ``margin_cells``; rays whose entry
    column stays below ``critical_frac * nc`` trace on the segmented
    z-scan march, the rest on the time tracer (which reflects at ne = nc),
    and the two images add. Returns what ``run`` returns. ``pad_to`` is
    accepted as in the JAX package, which pads each partition to reuse
    compiled program shapes; the kernels need no padding (pad rays land on
    no detector bin, so the image is the same). Coherent diagnostics are
    not ported (A.6).
    """
    del pad_to
    _check_incoherent(kwargs.get("diagnostic", "shadowgraphy"))
    if domain.ne is None:
        raise RuntimeError("run_split needs the domain's ne grid")
    nc = float(constants.critical_density(constants.omega_from_lwl(lwl)))
    p_ax = _AXIS_OF[domain.probing_direction]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    m = margin_cells
    col = torch.amax(domain.ne, dim=p_ax)        # (na, nb) transverse max
    col = F.max_pool2d(col[None, None], 2 * m + 1, stride=1, padding=m)[0, 0]
    mask = col >= critical_frac * nc
    coords = (domain.x, domain.y, domain.z)
    idx = []
    for ax in (a_ax, b_ax):
        c = coords[ax]
        i = torch.round((s0[ax] - c[0]) / (c[1] - c[0]))
        idx.append(i.nan_to_num(0.0).clamp(0, c.shape[0] - 1).long())
    slow = mask.to(s0.device)[idx[0], idx[1]]
    out = None
    for sel, solver in ((~slow, "zscan_seg"), (slow, "time")):
        rays = s0[:, sel]
        if rays.shape[1] == 0:
            continue
        res = run(domain, rays, solver=solver, lwl=lwl, critical_guard=None,
                  **kwargs)
        if out is None:
            out = res
        elif isinstance(out, dict):
            out = {k: out[k] + res[k] for k in out}
        else:
            out = out + res
    return out
