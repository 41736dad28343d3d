"""End-to-end pipeline: trace -> optics -> detector (PyTorch port of the
``solver="zscan_seg"`` path of ``synthpy_tpu.pipeline``).

A (9, N) ray bundle is marched through a segment pack by kernel K1
(``kernels.march``), and the exit state goes through the composed optical
bench into a detector image by kernel K3 (``kernels.detector``). The pack
comes from the caller (``spack=``) or is built by kernel K2
(``kernels.pack``). Everything runs on the device of the domain and rays.

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP
item: the coherent benches (A.6), ``solver="zscan"/"time"/"analytic"``
(A.9), ``pack_dtype="auto"`` and host-resident packs (A.12), and the mesh
modes (A.17). The critical-density guard raises: the time-domain tracer it
would fall back to is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from synthpy_tpu_torch.fields.domain import (ScalarDomain, layout_of,
                                             peak_ne_over_nc)
from synthpy_tpu_torch.kernels.detector import detect
from synthpy_tpu_torch.optics.compose import (BENCHES, NEEDS_JONES,
                                              analyser_weight)
from synthpy_tpu_torch.tracer.propagator import ray_to_Jonesvector
from synthpy_tpu_torch.tracer.zscan import (_AXIS_OF, PACK_DTYPES,
                                            _not_ported,
                                            build_segment_pack_device,
                                            permute_state, reassemble_state,
                                            trace_zscan_segments)


def _image_from_uf(uf: torch.Tensor, p_end: float, probing_depth: float, *,
                   diagnostic, probing_direction: str, bins,
                   L: float, R: float, Lx: float, Ly: float,
                   focal_plane: float, detL: float | None = None,
                   pol_beta_deg: float = 85.0):
    """(N, 8) permuted exit state -> optics -> detector, for one bench name
    or a tuple of names (then a tuple of images).

    The counterpart of the JAX package's ``_image_from_sf``, with
    ``reassemble_state`` fused into the detector kernel.
    """
    names = (diagnostic,) if isinstance(diagnostic, str) else diagnostic
    for name in names:
        if BENCHES[name][1]:
            raise _not_ported(f"the coherent bench {name!r}", "A.6")
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


def synth_image_zscan(
    s0: torch.Tensor,
    planes: torch.Tensor,
    origin_ab: torch.Tensor,
    inv_ab: torch.Tensor,
    probing_depth: float,
    *,
    layout,
    p0: float,
    dp_static: float,
    sort_rays: bool = False,
    seg_K: Optional[int] = None,
    shape_ab: Optional[Tuple[int, int]] = None,
    substeps: int = 1,
    diagnostic="shadowgraphy",
    probing_direction: str = "z",
    bins: Tuple[int, int] = (431, 321),  # pix/8 of a KAF-8300
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
    """Segmented z-scan pipeline on a (9, N) initial state; returns the
    (ny, nx) image (a tuple for a tuple of diagnostics).

    ``sort_rays`` reorders the rays by entry cell before the march, with
    the JAX package's key (the image does not depend on the order). Kernel
    K1 orders the rays it marches by itself, so on the card this only
    costs time: a second argsort and a copy of the state.
    """
    n_seg = planes.shape[0]
    u = permute_state(s0, probing_direction)
    if sort_rays:
        ta = (u[:, 0] - origin_ab[0]) * inv_ab[0]
        tb = (u[:, 1] - origin_ab[1]) * inv_ab[1]
        cell = (ta.to(torch.int32).clamp_min(0) * shape_ab[1]
                + tb.to(torch.int32).clamp_min(0))
        u = u[torch.argsort(cell, stable=True)]
    uf = trace_zscan_segments(
        u, planes, origin_ab, inv_ab, dp_static, shape_ab=shape_ab,
        layout=layout, K=seg_K, n_seg=n_seg,
        substeps=substeps, integrator=integrator, weights=seg_weights,
        seg_scales=seg_scales, qbits=seg_qbits)
    return _image_from_uf(
        uf, p0 + n_seg * seg_K * dp_static, probing_depth,
        diagnostic=diagnostic, probing_direction=probing_direction,
        bins=bins, L=L, R=R, Lx=Lx, Ly=Ly,
        focal_plane=focal_plane, detL=detL, pol_beta_deg=pol_beta_deg)


def run(
    domain: ScalarDomain,
    s0: torch.Tensor,
    *,
    diagnostic="shadowgraphy",
    solver: str = "zscan_seg",
    lwl: float = 1064e-9,
    steps_per_cell: float = 1.0,
    probing_depth: Optional[float] = None,
    spack=None,
    bins: Tuple[int, int] = (431, 321),
    critical_guard: Optional[float] = 0.85,
    mesh=None,
    grid_axis: Optional[str] = None,
    pp_axis: Optional[str] = None,
    **bench_kwargs,
):
    """Trace ``s0`` (9, N) through ``domain`` and synthesise the image.

    Pass a prebuilt ``spack`` (``build_segment_pack_device``) to amortise
    the pack build across calls, or ``pack_dtype=`` ("f32", "bf16",
    "int8", "int4" or a torch dtype) to build one at that tier; otherwise
    an f32 pack is built. ``seg_K`` (default 64) sets the slabs per
    segment, ``integrator`` and ``seg_weights`` select the march, and
    ``sort_rays=True`` orders the rays by entry cell first.
    ``diagnostic`` may be a list or tuple of names: the bundle is traced
    once and a dict {name: image} is returned.
    """
    multi = isinstance(diagnostic, (list, tuple))
    diagnostic = tuple(diagnostic) if multi else diagnostic
    if solver != "zscan_seg":
        raise _not_ported(f"solver={solver!r}", "A.9")
    if mesh is not None or grid_axis is not None or pp_axis is not None:
        raise _not_ported("mesh=, grid_axis= and pp_axis=", "A.17")
    if critical_guard is not None and domain.ne is not None:
        frac = peak_ne_over_nc(domain, lwl)
        if frac >= critical_guard:
            raise _not_ported(
                f"max(ne)/nc = {frac:.3f} >= {critical_guard}: the z-scan "
                "march is ill-conditioned near critical density, and the "
                "time-domain tracer it falls back to", "A.9")
    seg_K = bench_kwargs.pop("seg_K", 64)
    n_p = (domain.x, domain.y, domain.z)[
        _AXIS_OF[domain.probing_direction]].shape[0]
    if spack is None:
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
        spack = build_segment_pack_device(domain, lwl=lwl, K=K_eff,
                                          dtype=pdt)
    if s0.device != spack.seg_planes.device:
        raise ValueError(f"rays on {s0.device}, pack on "
                         f"{spack.seg_planes.device}")
    if probing_depth is None:
        probing_depth = domain.extent
    res = synth_image_zscan(
        s0, spack.seg_planes, spack.origin_ab, spack.inv_spacing_ab,
        probing_depth, layout=layout_of(domain), p0=spack.p0,
        dp_static=spack.dp, seg_K=spack.K, shape_ab=spack.shape_ab,
        substeps=max(int(round(steps_per_cell)), 1), diagnostic=diagnostic,
        probing_direction=domain.probing_direction, bins=bins,
        seg_scales=spack.scales, seg_qbits=spack.qbits, **bench_kwargs)
    return dict(zip(diagnostic, res)) if multi else res
