"""End-to-end pipeline: trace -> optics -> detector (PyTorch port of
``synthpy_tpu.pipeline``).

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
  whose column reaches it there;
* ``"analytic"``: the pack-free march on the domain's closed forms
  (``tracer.analytic``: K7, ``kernels.analytic``, for the ``test_*``
  fields).

The exit state goes through the composed optical bench into a detector
image by kernel K3 (``kernels.detector``): ``detect`` for the incoherent
benches, ``detect_field`` for the coherent ones (interferometry, coherent
refractometry), whose (ny, nx, C) field sums ``finalize_coherent`` turns
into images. Everything runs on the device of the domain and rays.

``solver="zscan_seg"`` also takes a host pack (``spack.host``, from
``build_segment_pack_streaming(device=False)`` or
``load_segment_pack(device=False)``), marched segment by segment
(``tracer.zscan.march_streamed``), and a pack larger than
``batch_pack_bytes`` is traced in per-call ray batches whose images (raw
field sums for the coherent benches) add up, as in the JAX package.

``run(mesh=)`` takes a ``parallel.Mesh`` and runs the JAX package's three
mesh modes: ray-parallel (each shard of a ``rays`` axis runs the
single-device path on its rays, the images psummed), grid-sharded
(``grid_axis``: the segment tables split along the transverse a-axis,
each shard's rows built on its device by K2 on a row window unless a pack
is given, then kernel K17; a domain whose ne is a ``parallel.Sharded``
runs it without gathering the ne) and depth-pipelined (``pp_axis``:
segments split by depth, ray chunks streamed through the devices, K1).
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
from synthpy_tpu_torch.kernels.detector import detect, detect_field
from synthpy_tpu_torch.ops.histogram import finalize_complex
from synthpy_tpu_torch.optics.compose import (BENCHES, NEEDS_JONES,
                                              analyser_weight)
from synthpy_tpu_torch.optics.diagnostics import (Interferometry,
                                                  Polarimetry, Refractometry,
                                                  Schlieren, Shadowgraphy)
from synthpy_tpu_torch.parallel.mesh import (Mesh, Sharded, line_sum,
                                             make_gridsharded_segment_tracer,
                                             shard)
from synthpy_tpu_torch.parallel.pipeline_pp import (
    make_pipelined_segment_tracer)
from synthpy_tpu_torch.tracer.analytic import trace_domain_analytic
from synthpy_tpu_torch.tracer.propagator import (default_n_steps, dt_of,
                                                 ray_to_Jonesvector,
                                                 trace_rk4)
from synthpy_tpu_torch.tracer.zscan import (_AXIS_OF, PACK_DTYPES,
                                            PackTierAdvice,
                                            build_segment_pack_device,
                                            entry_sort, make_segment_pack,
                                            make_zscan_pack, march_streamed,
                                            permute_state, reassemble_state,
                                            suggest_pack_dtype, trace_zscan,
                                            trace_zscan_segments)

# bench name -> (class, solve method, coherent): the class API over the
# benches of optics.compose.BENCHES, as in the JAX package
DIAGNOSTICS = {
    "shadowgraphy": (Shadowgraphy, "two_lens_solve", False),
    "shadowgraphy_single": (Shadowgraphy, "single_lens_solve", False),
    "shadowgraphy_exp": (Shadowgraphy, "single_exp_solve", False),
    "schlieren_df": (Schlieren, "DF_solve", False),
    "schlieren_lf": (Schlieren, "LF_solve", False),
    "refractometry": (Refractometry, "incoherent_solve", False),
    "refractometry_coherent": (Refractometry, "coherent_solve", True),
    "interferometry": (Interferometry, "two_lens_solve", True),
    # an incoherent detector with a Jones-vector analyser weight
    "polarimetry": (Polarimetry, "two_lens_solve", False),
}


def _image_from_uf(uf: torch.Tensor, p_end, probing_depth: float, *,
                   diagnostic, probing_direction: str, bins,
                   L: float = 400.0, R: float = 25.0, Lx: float = 18.0,
                   Ly: float = 13.5, focal_plane: float = 0.0,
                   lwl: float = 1064e-9,
                   coherent_convention: str = "legacy",
                   detL: float | None = None, n_fringes: float = 10.0,
                   deg: float = 20.0, coherent_raw: bool = False,
                   pol_beta_deg: float = 85.0):
    """(N, 8) permuted exit state -> optics -> detector, for one bench name
    or a tuple of names (then a tuple of images). Every ray sits at the
    probing coordinate ``p_end``, or at its own when ``p_end`` is an (N,)
    tensor.

    The counterpart of the JAX package's ``_image_from_sf``, with
    ``reassemble_state`` fused into the detector kernel. A coherent bench
    gives its field sums (``coherent_raw=True``) or their image.
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
        builder, coherent = BENCHES[name]
        extra = ({"detL": detL} if detL is not None
                 and name == "shadowgraphy_exp" else {})
        stages = builder(L=L, R=R, focal_plane=focal_plane, **extra)
        if coherent:
            acc = detect_field(
                uf, p_end, probing_depth, probing_direction, stages, bins,
                Lx, Ly, lwl, coherent_convention,
                ref=(n_fringes, deg) if name == "interferometry" else None)
            images.append(acc if coherent_raw
                          else finalize_complex(acc, coherent_convention))
            continue
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
    coherent_convention: str = "legacy",
    detL: float | None = None,
    n_fringes: float = 10.0,
    deg: float = 20.0,
    coherent_raw: bool = False,
    pol_beta_deg: float = 85.0,
):
    """Time-tracer pipeline on (N, 9) ray rows: ``n_steps`` RK4 steps of
    ``dt`` (kernel K5), then the bench and detector (K3, each ray from its
    own exit coordinate). Returns the (ny, nx) image (a tuple for a tuple
    of diagnostics); ``coherent_raw=True`` returns the coherent benches'
    raw field sums, to add across batches and finalize once
    (``finalize_coherent``). ``ray_chunk`` is accepted as in the JAX
    package."""
    sf_rows = trace_rk4(s_rows, channels, origin, inv_spacing, dt,
                        layout=layout, n_steps=n_steps, ray_chunk=ray_chunk)
    return _image_from_sf(
        sf_rows.T, probing_depth, probing_direction=probing_direction,
        diagnostic=diagnostic, bins=bins, lwl=lwl, L=L, R=R, Lx=Lx, Ly=Ly,
        focal_plane=focal_plane, coherent_convention=coherent_convention,
        detL=detL, n_fringes=n_fringes, deg=deg, coherent_raw=coherent_raw,
        pol_beta_deg=pol_beta_deg)


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
    coherent_convention: str = "legacy",
    integrator: str = "rk4",
    detL: float | None = None,
    n_fringes: float = 10.0,
    deg: float = 20.0,
    coherent_raw: bool = False,
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
    costs time. ``coherent_raw`` as in ``synth_image``.
    """
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
        bins=bins, lwl=lwl, L=L, R=R, Lx=Lx, Ly=Ly,
        focal_plane=focal_plane, coherent_convention=coherent_convention,
        detL=detL, n_fringes=n_fringes, deg=deg, coherent_raw=coherent_raw,
        pol_beta_deg=pol_beta_deg)


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
    dith = bench_kwargs.pop("pack_dither", None)
    if isinstance(pdt, str) and pdt == "auto":
        # the tier from the field's caustic-ness; int4 nibble packs need
        # the even-stride integrators, int8 is safe at any
        adv = suggest_pack_dtype(domain, lwl)
        integ = bench_kwargs.get("integrator", "rk4")
        if adv["name"] == "int4" and integ not in ("rk2s2", "rk2s4"):
            adv = dict(adv, dtype=torch.int8, name="int8(int4 needs "
                       f"rk2s2/rk2s4, integrator={integ})")
        warnings.warn(
            f"pack_dtype='auto': chose {adv['name']} tier (caustic metric "
            f"chi={adv['chi']}, estimated raw image rel-L1 "
            f"{adv['est_rel_err']}, dither={adv['dither']})",
            PackTierAdvice, stacklevel=3)
        pdt, dith = adv["dtype"], adv["dither"]
    elif isinstance(pdt, str):
        pdt = PACK_DTYPES[pdt]
    K_eff = min(seg_K, n_p - 1)
    if pdt == "int4" and K_eff % 2:
        K_eff += 1  # nibble packs pair planes; pads one zero slab
    return build_segment_pack_device(domain, lwl=lwl, K=K_eff, dtype=pdt,
                                     dither=dith)


def _pad_ray_cols(s0: torch.Tensor, multiple: int, a_ax: int,
                  b_ax: int) -> torch.Tensor:
    """A (9, N) bundle padded to a multiple of ``multiple`` rays with copies
    of ray 0 moved 1e9 m off along both transverse axes: they fly outside
    the grid and land on no detector bin, so the image is unchanged."""
    N = s0.shape[1]
    total = -(-N // multiple) * multiple
    if total == N:
        return s0
    pad = s0[:, :1].repeat(1, total - N)
    pad[a_ax] = 1e9
    pad[b_ax] = 1e9
    return torch.cat([s0, pad], dim=1)


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
    """Trace ``s0`` (9, N) (a tensor or a ``parallel.Sharded``) through
    ``domain`` and synthesise the image.

    ``solver``: "zscan" (default), "zscan_seg", "time" or "analytic" (see
    the module docstring). Prebuilt packs amortise their build across
    calls: ``pack`` (``build_pack``) for "time" and "zscan", ``zpack``
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
    once and a dict {name: image} is returned. The coherent benches
    ("interferometry", "refractometry_coherent") take ``lwl`` as the
    wavelength of their phase stages, ``coherent_convention`` ("legacy" or
    "intensity"), ``n_fringes`` and ``deg`` (the interferometer's
    reference beam) and ``coherent_raw=True`` (return the raw field sums;
    see ``finalize_coherent``). ``solver="analytic"`` marches
    ``n_steps`` (default: the probing axis's cells) of ``integrator``
    ("rk2" default, or "rk4"). ``ray_chunk`` is accepted as in the JAX
    package and has no effect: the kernels keep no per-ray buffer.

    ``mesh`` (a ``parallel.Mesh``) runs JAX's mesh modes: ray-parallel over
    ``ray_axis``, grid-sharded over ``grid_axis`` or depth-pipelined over
    ``pp_axis`` (``pp_chunks``, default the axis size), each on a
    ``zscan_seg`` pack at ``pack_dtype`` (default float32) for the last
    two; see ``parallel``.
    """
    multi = isinstance(diagnostic, (list, tuple))
    diagnostic = tuple(diagnostic) if multi else diagnostic
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, not "
                        f"{type(mesh).__name__}")
    if isinstance(s0, Sharded):
        s0 = s0.gather()
    if (critical_guard is not None
            and solver in ("zscan", "zscan_seg", "analytic")
            and domain.ne_stored is not None):
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
    if solver not in ("zscan", "zscan_seg", "time", "analytic"):
        raise ValueError(f"unknown solver {solver!r}")
    grid_mode = mesh is not None and grid_axis is not None
    pp_mode = mesh is not None and pp_axis is not None
    if grid_mode and solver != "zscan_seg":
        raise ValueError("grid_axis requires solver='zscan_seg' (the "
                         "grid-sharded march is the segmented fast path)")
    if pp_mode and (grid_mode or solver != "zscan_seg"):
        raise ValueError("pp_axis requires solver='zscan_seg' and is "
                         "mutually exclusive with grid_axis (the PP "
                         "tracer shards segments by probing depth)")
    if probing_depth is None:
        probing_depth = domain.extent
    if mesh is not None:
        kw = dict(solver=solver, lwl=lwl, n_steps=n_steps,
                  steps_per_cell=steps_per_cell, probing_depth=probing_depth,
                  pack=pack, zpack=zpack, spack=spack, bins=bins,
                  ray_chunk=ray_chunk, diagnostic=diagnostic)
        if grid_mode or pp_mode:
            res = _run_sharded_field(domain, s0, mesh, ray_axis, grid_axis,
                                     pp_axis, kw, bench_kwargs)
        else:
            res = _run_ray_parallel(domain, s0, mesh, ray_axis, kw,
                                    bench_kwargs)
        return dict(zip(diagnostic, res)) if multi else res
    if spack is not None and isinstance(spack.seg_planes, Sharded):
        spack = spack._replace(seg_planes=spack.seg_planes.gather())
    seg_K = bench_kwargs.pop("seg_K", 64)
    batch_pack_bytes = bench_kwargs.pop("batch_pack_bytes", 4 << 30)
    batch_corner_bytes = bench_kwargs.pop("batch_corner_bytes", 1 << 30)
    layout = layout_of(domain)
    substeps = max(int(round(steps_per_cell)), 1)
    common = dict(diagnostic=diagnostic,
                  probing_direction=domain.probing_direction, bins=bins,
                  ray_chunk=ray_chunk, lwl=lwl)
    if solver == "zscan_seg" and spack is not None and spack.host:
        # a host pack: segments copied up one at a time, each marched by K1
        _same_device(s0, spack.origin_ab)
        uf = march_streamed(
            permute_state(s0, domain.probing_direction), spack,
            layout=layout, integrator=bench_kwargs.pop("integrator", "rk4"),
            weights=bench_kwargs.pop("seg_weights", "stage"),
            substeps=substeps, cache=bench_kwargs.pop("seg_cache", None))
        p_end = spack.p0 + spack.seg_planes.shape[0] * spack.K * spack.dp
        res = _image_from_uf(
            uf, p_end, probing_depth, diagnostic=diagnostic,
            probing_direction=domain.probing_direction, bins=bins, lwl=lwl,
            **bench_kwargs)
        return dict(zip(diagnostic, res)) if multi else res
    if solver == "analytic":
        uf, p_end = trace_domain_analytic(
            s0, domain, lwl=lwl, n_steps=n_steps,
            integrator=bench_kwargs.pop("integrator", "rk2"))
        res = _image_from_uf(
            uf, p_end, probing_depth, diagnostic=diagnostic,
            probing_direction=domain.probing_direction, bins=bins, lwl=lwl,
            **bench_kwargs)
    elif solver == "zscan_seg":
        if spack is None:
            spack = _segment_pack(domain, lwl, seg_K, pack, zpack,
                                  bench_kwargs)
        _same_device(s0, spack.seg_planes)
        table = spack.seg_planes

        def call(rays):
            return synth_image_zscan(
                rays, table, spack.origin_ab, spack.inv_spacing_ab,
                probing_depth, layout=layout,
                n_slabs=table.shape[0] * spack.K, p0=spack.p0,
                dp_static=spack.dp, segmented=True, seg_K=spack.K,
                shape_ab=spack.shape_ab, substeps=substeps,
                seg_scales=spack.scales, seg_qbits=spack.qbits, **common,
                **bench_kwargs)

        pack_bytes = table.numel() * table.element_size()
        # corner bytes a ray: 4 rows of the table
        max_rays = max(int(batch_corner_bytes // (4 * table.shape[-1]
                                                  * table.element_size())),
                       1024)
        if pack_bytes > batch_pack_bytes and s0.shape[1] > max_rays:
            res = _batched(call, s0, max_rays, domain.probing_direction,
                           diagnostic, bench_kwargs)
        else:
            res = call(s0)
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


def _to(x, dev: torch.device):
    """A pack (or None) with its tensors on ``dev``."""
    if x is None:
        return None
    return type(x)(*(v.to(dev) if isinstance(v, torch.Tensor) else v
                     for v in x))


def _run_ray_parallel(domain, s0: torch.Tensor, mesh, ray_axis: str, kw,
                      bench_kwargs: dict):
    """``run(mesh=)`` over a ``rays`` axis: the bundle padded with rays
    that land nowhere to a multiple of the axis and split over it, the
    field's pack built once and copied to each distinct device, each shard
    traced by the single-device path, the images (raw field sums for the
    coherent benches, finalized once) psummed over the axis."""
    if ray_axis not in mesh.shape:
        raise ValueError(f"mesh has no '{ray_axis}' axis; pass "
                         f"grid_axis= for field-sharded tracing or "
                         f"pp_axis= for depth-pipelined tracing")
    solver = kw["solver"]
    diagnostic = kw["diagnostic"]
    names = (diagnostic,) if isinstance(diagnostic, str) else diagnostic
    layout = layout_of(domain)
    if solver == "zscan_seg":
        spack = kw["spack"]
        if spack is None:
            spack = _segment_pack(domain, kw["lwl"],
                                  bench_kwargs.pop("seg_K", 64), kw["pack"],
                                  kw["zpack"], bench_kwargs)
        elif spack.host:
            raise ValueError("streamed host packs are single-device; "
                             "pass a device spack for mesh mode")
        if isinstance(spack.seg_planes, Sharded):
            spack = spack._replace(seg_planes=spack.seg_planes.gather())
        kw.update(spack=spack, pack=None, zpack=None)
    elif solver == "zscan":
        kw.update(zpack=kw["zpack"] or make_zscan_pack(
            kw["pack"] or build_pack(domain, kw["lwl"]), layout,
            domain.probing_direction), pack=None)
    elif solver == "time":
        kw.update(pack=kw["pack"] or build_pack(domain, kw["lwl"]))
    user_raw = bench_kwargs.get("coherent_raw", False)
    any_coh = any(BENCHES[n][1] for n in names)
    p_ax = _AXIS_OF[domain.probing_direction]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    s_sh = shard(_pad_ray_cols(s0, mesh.shape[ray_axis], a_ax, b_ax), mesh,
                 (None, ray_axis))
    line = mesh.groups(ray_axis)[0]
    packs = {}
    parts, devs = [], []
    for p in line:
        dev = mesh.flat_devices[p]
        if dev not in packs:
            packs[dev] = {k: _to(kw[k], dev)
                          for k in ("pack", "zpack", "spack")}
        res = run(domain, s_sh.shards[p].contiguous(),
                  **{**kw, **packs[dev]}, critical_guard=None,
                  **{**bench_kwargs, "coherent_raw": any_coh or user_raw})
        parts.append(tuple(res.values()) if isinstance(res, dict) else res)
        devs.append(dev)
    # the psum over the axis (and over the processes it spans)
    across = ray_axis == mesh.process_axis
    if isinstance(parts[0], tuple):
        total = tuple(line_sum([x[i] for x in parts], devs, across)[devs[0]]
                      for i in range(len(names)))
    else:
        total = line_sum(parts, devs, across)[devs[0]]
    if any_coh and not user_raw:
        total = finalize_coherent(total, diagnostic, bench_kwargs.get(
            "coherent_convention", "legacy"))
    return total


def _pack_dtype(bench_kwargs: dict):
    """The tier of a mesh mode's pack: ``pack_dtype`` (default float32,
    the single-device accuracy class), as a dtype or "int4"."""
    pdt = bench_kwargs.pop("pack_dtype", torch.float32)
    return PACK_DTYPES[pdt] if isinstance(pdt, str) else pdt


def _run_sharded_field(domain, s0: torch.Tensor, mesh, ray_axis: str,
                       grid_axis, pp_axis, kw, bench_kwargs: dict):
    """``run(mesh=, grid_axis=)`` and ``run(mesh=, pp_axis=)``: the segment
    pack (built at ``pack_dtype``, float32 by default, unless ``spack`` is
    given; over the grid axis each shard builds its own rows) marched
    with its tables split over the grid axis (the grid-sharded march, K17)
    or its segments over the pp axis (the depth-pipelined march, K1 a
    device), then the bench and detector on the exit states."""
    seg_K = bench_kwargs.pop("seg_K", 64)
    spack = kw["spack"]
    if spack is not None and spack.host:
        raise ValueError("streamed host packs are single-device; pass a "
                         "device spack for mesh mode")
    layout = layout_of(domain)
    substeps = max(int(round(kw["steps_per_cell"])), 1)
    integrator = bench_kwargs.pop("integrator", "rk4")
    weights = bench_kwargs.pop("seg_weights", "stage")
    p_ax = _AXIS_OF[domain.probing_direction]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    if grid_axis is not None:
        G = mesh.shape[grid_axis]
        if spack is None:
            na = (domain.x, domain.y, domain.z)[a_ax].shape[0]
            # the build splits over the axis when na divides; otherwise
            # the single-device pack is padded below
            spack = build_segment_pack_device(
                domain, lwl=kw["lwl"], K=seg_K, dtype=_pack_dtype(
                    bench_kwargs), mesh=mesh if na % G == 0 else None,
                mesh_axis=grid_axis)
        r_ax = ray_axis if ray_axis in mesh.shape else None
        if r_ax is not None:
            s0 = _pad_ray_cols(s0, mesh.shape[r_ax], a_ax, b_ax)
        n_seg = spack.seg_planes.shape[0]
        na, nb = spack.shape_ab
        na_pad = -(-na // G) * G
        tracer = make_gridsharded_segment_tracer(
            mesh, layout, spack, grid_axis=grid_axis, ray_axis=r_ax,
            substeps=substeps, integrator=integrator, weights=weights,
            table_na=na_pad)
        tables = spack.seg_planes
        if not isinstance(tables, Sharded):
            tables = tables.reshape(n_seg, na, nb, tables.shape[-1])
            if na_pad != na:
                # zero a-rows that no ray owns or reads: the march's mask
                # and corner clip stay bounded by the real na
                tables = F.pad(tables, (0, 0, 0, 0, 0, na_pad - na))
        uf = tracer(permute_state(s0, domain.probing_direction), tables,
                    spack.origin_ab, spack.inv_spacing_ab, spack.dp)
    else:
        if spack is None:
            spack = build_segment_pack_device(
                domain, lwl=kw["lwl"], K=seg_K,
                dtype=_pack_dtype(bench_kwargs))
        seg_planes, scales = spack.seg_planes, spack.scales
        if isinstance(seg_planes, Sharded):
            seg_planes = seg_planes.gather()
        D = mesh.shape[pp_axis]
        n_seg = seg_planes.shape[0]
        n_pad = -(-n_seg // D) * D - n_seg
        if n_pad:
            # zero segments the tracer skips (n_seg_real)
            seg_planes = F.pad(seg_planes, (0, 0, 0, 0, 0, n_pad))
            if scales is not None:
                scales = F.pad(scales, (0, 0, 0, 0, 0, n_pad), value=1.0)
        u = permute_state(s0, domain.probing_direction)
        N = u.shape[0]
        n_chunks = int(bench_kwargs.pop("pp_chunks", D))
        if n_chunks % D:
            raise ValueError(f"pp_chunks {n_chunks} must be a multiple of "
                             f"the {D}-way '{pp_axis}' axis")
        chunk_rays = -(-N // n_chunks)
        total = n_chunks * chunk_rays
        if total != N:
            # pad rows are sliced off again before the detector
            u = torch.cat([u, u[:1].expand(total - N, 8)])
        tracer = make_pipelined_segment_tracer(
            mesh, layout, spack._replace(seg_planes=seg_planes,
                                         scales=scales),
            n_chunks=n_chunks, axis=pp_axis, substeps=substeps,
            integrator=integrator, weights=weights, n_seg_real=n_seg)
        args = (seg_planes,) + ((scales,) if scales is not None else ())
        uf = tracer(u.reshape(n_chunks, chunk_rays, 8), *args,
                    spack.origin_ab, spack.inv_spacing_ab,
                    spack.dp).reshape(total, 8)[:N]
    # the march ends at the real segment count's exit plane
    p_end = spack.p0 + n_seg * spack.K * spack.dp
    return _image_from_uf(
        uf, p_end, kw["probing_depth"], diagnostic=kw["diagnostic"],
        probing_direction=domain.probing_direction, bins=kw["bins"],
        lwl=kw["lwl"], **bench_kwargs)


def _batched(call, s0: torch.Tensor, max_rays: int, probing_direction: str,
             diagnostic, bench_kwargs: dict):
    """``call`` on ``max_rays``-ray batches of the bundle (padded with rays
    that land nowhere), the images summed: the JAX package's per-call
    batching of packs larger than ``batch_pack_bytes``. Coherent benches
    are summed as raw field sums and finalized once, so interference
    across batches is kept; counts equal the one-call image's."""
    names = (diagnostic,) if isinstance(diagnostic, str) else diagnostic
    user_raw = bench_kwargs.get("coherent_raw", False)
    any_coh = any(BENCHES[n][1] for n in names)
    if any_coh:
        bench_kwargs["coherent_raw"] = True
    p_ax = _AXIS_OF[probing_direction]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    s_pad = _pad_ray_cols(s0, max_rays, a_ax, b_ax)
    acc = None
    for i0 in range(0, s_pad.shape[1], max_rays):
        res = call(s_pad[:, i0:i0 + max_rays])
        if acc is None:
            acc = res
        elif isinstance(res, tuple):
            acc = tuple(a + b for a, b in zip(acc, res))
        else:
            acc = acc + res
    if any_coh and not user_raw:
        acc = finalize_coherent(acc, diagnostic, bench_kwargs.get(
            "coherent_convention", "legacy"))
    return acc


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
    no detector bin, so the image is the same).

    Coherent diagnostics: the two partitions' raw field sums add and are
    finalized once (``coherent_raw`` is forced on), so interference across
    the partitions is kept; the two integrators' phases differ at the
    ~1e-3 level over hundreds of radians, so run_split warns, as the JAX
    package does, that such fringes are solver-sensitive.
    """
    del pad_to
    diag = kwargs.get("diagnostic", "shadowgraphy")
    names = (diag,) if isinstance(diag, str) else tuple(diag)
    any_coh = any(BENCHES[n][1] for n in names)
    user_raw = kwargs.get("coherent_raw", False)
    if any_coh:
        warnings.warn(
            "run_split mixes z-scan and time-tracer phases in one "
            "coherent sum; fringes involving both partitions are "
            "solver-sensitive at the integrator-mismatch level. Use "
            "solver='time' on the full bundle for quantitative coherent "
            "work.", stacklevel=2)
        kwargs["coherent_raw"] = True
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
    if any_coh and not user_raw and out is not None:
        conv = kwargs.get("coherent_convention", "legacy")
        if isinstance(out, dict):
            out = dict(zip(out, finalize_coherent(
                tuple(out.values()), tuple(out), conv)))
        else:
            out = finalize_coherent(out, diag, conv)
    return out


def finalize_coherent(images, diagnostic, convention: str = "legacy"):
    """Finalize the raw field sums of ``coherent_raw=True`` runs.

    ``images`` is one tensor or a tuple matching ``diagnostic`` (one name
    or a tuple of names): coherent entries are (ny, nx, C) field sums and
    become images, incoherent entries pass through. Sum the raw results
    of ray batches first, then call this once.
    """
    if isinstance(diagnostic, str):
        if BENCHES[diagnostic][1]:
            return finalize_complex(images, convention)
        return images
    return tuple(finalize_complex(img, convention) if BENCHES[n][1] else img
                 for n, img in zip(diagnostic, images))
