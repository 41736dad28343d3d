"""Slab marches with the probing axis as independent variable (PyTorch
port of the plain and segmented subsets of ``synthpy_tpu.tracer.zscan``).

Every ray crosses the probing axis monotonically, so the ray ODE is
reparameterised from t to the probing coordinate p. The plain march
(``trace_zscan``, kernel K4 in ``kernels.slab_march``) steps RK4 across the
planes of a ``ZScanPack`` (the trace pack with the probing axis leading).
The segmented march groups the planes into segments of K slabs, stored as
corner-column tables ``[seg, cell, k*C + c]`` (``SegmentPack``); the pack
is built by kernel K2 (``kernels.pack``, which also holds the nibble
helpers) and marched by kernel K1 (``kernels.march``).

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP item:
``dither=`` (A.4), ``mesh=`` (A.17), and on the segmented march ``block=``,
``substeps > 1`` and ``remat`` (A.4 / B8).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from synthpy_tpu_torch import constants as _c
from synthpy_tpu_torch.fields.domain import (ChannelLayout, ScalarDomain,
                                             TracePack, build_pack,
                                             layout_of)
from synthpy_tpu_torch.kernels import march as _march
from synthpy_tpu_torch.kernels import pack as _pack
from synthpy_tpu_torch.kernels import slab_march as _slab
from synthpy_tpu_torch.kernels.slab_march import (  # noqa: F401
    bilinear as _bilinear, deriv as _deriv)
from synthpy_tpu_torch.tracer.propagator import (_AXIS_OF, TraceResult,
                                                 ray_to_Jonesvector)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def permute_state(s0: torch.Tensor, probing_direction: str = "z"
                  ) -> torch.Tensor:
    """(9, N) canonical state -> (N, 8) permuted (a, b, va, vb, vp, amp,
    phase, pol) columns, contiguous."""
    p_ax = _AXIS_OF[probing_direction]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    return torch.stack([s0[a_ax], s0[b_ax], s0[3 + a_ax], s0[3 + b_ax],
                        s0[3 + p_ax], s0[6], s0[7], s0[8]], dim=1)


def reassemble_state(uf: torch.Tensor, p_end,
                     probing_direction: str = "z") -> torch.Tensor:
    """(N, 8) permuted exit columns -> (9, N) canonical exit state; every
    ray sits at the exit-plane coordinate ``p_end`` along the probing
    axis, or at its own coordinate when ``p_end`` is an (N,) tensor."""
    p_ax = _AXIS_OF[probing_direction]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    cols = [None] * 9
    cols[a_ax], cols[b_ax] = uf[:, 0], uf[:, 1]
    cols[p_ax] = (p_end if isinstance(p_end, torch.Tensor) else torch.full(
        (uf.shape[0],), p_end, dtype=uf.dtype, device=uf.device))
    cols[3 + a_ax], cols[3 + b_ax], cols[3 + p_ax] = (uf[:, 2], uf[:, 3],
                                                      uf[:, 4])
    cols[6], cols[7], cols[8] = uf[:, 5], uf[:, 6], uf[:, 7]
    return torch.stack(cols)


class ZScanPack(NamedTuple):
    """Trace pack permuted so the probing axis leads.

    planes: (n_p, n_a, n_b, C) with the gradient channels (and the Faraday
        channels) reordered to (a, b, p), the permuted state's order.
    """

    planes: torch.Tensor
    origin_ab: torch.Tensor       # (2,) transverse origins
    inv_spacing_ab: torch.Tensor  # (2,)
    p0: float
    dp: float
    omega: float


def make_zscan_pack(pack: TracePack, layout: ChannelLayout,
                    probing_direction: str = "z",
                    dtype=None) -> ZScanPack:
    """Permute a TracePack into probing-axis-major plane layout;
    ``dtype`` (e.g. torch.bfloat16) down-casts the stored planes, the
    march's arithmetic staying float32."""
    p_ax = _AXIS_OF[probing_direction]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    perm = list(range(pack.channels.shape[-1]))
    perm[0], perm[1], perm[2] = a_ax, b_ax, p_ax
    if layout.B_on:
        f = layout.faraday_index
        perm[f + 0], perm[f + 1], perm[f + 2] = f + a_ax, f + b_ax, f + p_ax
    planes = pack.channels.permute(p_ax, a_ax, b_ax, 3)[..., perm]
    planes = planes.to(dtype or planes.dtype).contiguous()
    o = np.asarray(pack.origin)
    s = np.asarray(pack.inv_spacing)
    dev = planes.device
    return ZScanPack(planes,
                     torch.as_tensor(np.stack([o[a_ax], o[b_ax]]),
                                     device=dev),
                     torch.as_tensor(np.stack([s[a_ax], s[b_ax]]),
                                     device=dev),
                     float(o[p_ax]), float(1.0 / s[p_ax]), pack.omega)


def trace_zscan(u: torch.Tensor, planes: torch.Tensor, origin_ab, inv_ab,
                dp, *, layout: ChannelLayout, n_slabs: int,
                substeps: int = 1, atten_sign: float = -1.0,
                ray_chunk: Optional[int] = None,
                unroll: int = 1) -> torch.Tensor:
    """March (N, 8) permuted rays across ``n_slabs`` grid intervals with
    ``substeps`` RK4 steps each (kernel K4). ``ray_chunk`` and ``unroll``
    are the JAX program's memory and scan knobs and have no effect here:
    the kernel keeps no per-ray buffer."""
    del ray_chunk, unroll
    return _slab.march(u, planes, [float(v) for v in origin_ab.tolist()],
                       [float(v) for v in inv_ab.tolist()], float(dp),
                       layout=layout, n_slabs=n_slabs, substeps=substeps,
                       atten_sign=atten_sign)


def entry_sort(u: torch.Tensor, origin_ab, inv_ab, nb: int) -> torch.Tensor:
    """``u`` reordered by entry cell with the JAX package's key
    ``clip(int(ta), 0) * nb + clip(int(tb), 0)``."""
    ta = (u[:, 0] - origin_ab[0]) * inv_ab[0]
    tb = (u[:, 1] - origin_ab[1]) * inv_ab[1]
    cell = (ta.to(torch.int32).clamp_min(0) * nb
            + tb.to(torch.int32).clamp_min(0))
    return u[torch.argsort(cell, stable=True)]


def solve_zscan(
    s0: torch.Tensor,
    domain: ScalarDomain,
    probing_depth: Optional[float] = None,
    *,
    lwl: float = 1064e-9,
    return_E: bool = False,
    substeps: int = 1,
    atten_sign: float = -1.0,
    pack: Optional[TracePack] = None,
    zpack: Optional[ZScanPack] = None,
    ray_chunk: Optional[int] = None,
    sort_rays: bool = False,
    unroll: int = 1,
) -> TraceResult:
    """Trace a (9, N) bundle from the entry face to the far face of the
    grid with the plain slab march, then resolve the exit plane
    ``probing_depth``. With ``sort_rays`` the output columns are in
    entry-cell order."""
    layout = layout_of(domain)
    if probing_depth is None:
        probing_depth = domain.extent
    if zpack is None:
        if pack is None:
            pack = build_pack(domain, lwl)
        zpack = make_zscan_pack(pack, layout, domain.probing_direction)
    u = permute_state(s0, domain.probing_direction)
    if sort_rays:
        u = entry_sort(u, zpack.origin_ab, zpack.inv_spacing_ab,
                       zpack.planes.shape[2])
    n_slabs = zpack.planes.shape[0] - 1
    if u.is_cuda:
        torch.cuda.synchronize(u.device)
    start = time.perf_counter()
    uf = trace_zscan(u, zpack.planes, zpack.origin_ab, zpack.inv_spacing_ab,
                     zpack.dp, layout=layout, n_slabs=n_slabs,
                     substeps=substeps, atten_sign=atten_sign,
                     ray_chunk=ray_chunk, unroll=unroll)
    if uf.is_cuda:
        torch.cuda.synchronize(uf.device)
    duration = time.perf_counter() - start
    sf = reassemble_state(uf, zpack.p0 + n_slabs * zpack.dp,
                          domain.probing_direction)
    rf, Jf = ray_to_Jonesvector(sf, probing_depth,
                                probing_direction=domain.probing_direction,
                                return_E=return_E)
    return TraceResult(rf, Jf, sf, duration)


class SegmentPack(NamedTuple):
    """Planes regrouped as per-segment corner-column tables.

    seg_planes: (n_seg, na*nb, (K+1)*C): [s, cell, k*C + c] is channel c of
        plane s*K + k at transverse cell ``cell``; int4 packs hold
        (K//2+1)*C bytes per row, byte j*C + c packing plane 2j (low
        nibble) and 2j+1 (high nibble).
    scales: None for float packs, else the (n_seg, K+1, C) f32
        dequantisation scales (value = code * scale).
    qbits: 4 for int4 nibble packs, else None.
    """

    seg_planes: Optional[torch.Tensor]
    origin_ab: torch.Tensor
    inv_spacing_ab: torch.Tensor
    shape_ab: Tuple[int, int]
    K: int
    n_slabs: int          # real slab count (before padding)
    p0: float
    dp: float
    omega: float
    scales: Optional[torch.Tensor] = None
    qbits: Optional[int] = None


# pack-tier names -> the dtype argument of build_segment_pack_device
# ("int4" is the nibble-pack sentinel)
PACK_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
               "int8": torch.int8, "int4": "int4"}


def _geometry(domain: ScalarDomain):
    p_ax = _AXIS_OF[domain.probing_direction]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    coords = (domain.x, domain.y, domain.z)
    return p_ax, a_ax, b_ax, coords[a_ax], coords[b_ax], coords[p_ax]


def _origin_inv(ca: torch.Tensor, cb: torch.Tensor):
    origin_ab = torch.stack([ca[0], cb[0]])
    inv_ab = torch.stack([1.0 / (ca[1] - ca[0]), 1.0 / (cb[1] - cb[0])])
    return origin_ab, inv_ab


def make_segment_pack(zpack: ZScanPack, K: int = 64) -> SegmentPack:
    """Regroup a ZScanPack into K-slab segments with duplicated borders
    (zero planes pad the last segment)."""
    n_p, na, nb, C = zpack.planes.shape
    n_slabs = n_p - 1
    n_seg = -(-n_slabs // K)
    planes = zpack.planes
    if n_seg * K + 1 > n_p:
        pad = planes.new_zeros((n_seg * K + 1 - n_p, na, nb, C))
        planes = torch.cat([planes, pad])
    segs = torch.stack([planes[s * K:s * K + K + 1] for s in range(n_seg)])
    segs = segs.permute(0, 2, 3, 1, 4).reshape(n_seg, na * nb, (K + 1) * C)
    return SegmentPack(segs, zpack.origin_ab, zpack.inv_spacing_ab,
                       (na, nb), K, n_slabs, zpack.p0, zpack.dp, zpack.omega)


def segment_pack_metadata(domain: ScalarDomain, lwl: float = 1064e-9,
                          K: int = 64) -> SegmentPack:
    """SegmentPack with ``seg_planes=None``: geometry and segmentation
    from the domain coordinates, no tables built."""
    _, _, _, ca, cb, cp = _geometry(domain)
    origin_ab, inv_ab = _origin_inv(ca, cb)
    cp_h = cp.cpu()
    return SegmentPack(None, origin_ab, inv_ab,
                       (ca.shape[0], cb.shape[0]), K, cp.shape[0] - 1,
                       float(cp_h[0]), float(cp_h[1] - cp_h[0]),
                       float(_c.omega_from_lwl(lwl)), None)


def _channels_of(spack: SegmentPack) -> int:
    return spack.seg_planes.shape[-1] // _march.plane_blocks(spack.K,
                                                             spack.qbits)


def quantize_segment_pack(spack: SegmentPack, bits: int = 8,
                          dither=None) -> SegmentPack:
    """Symmetric per-(segment, plane, channel) int8 or int4 quantisation:
    codes round(value / scale) in [-qmax, qmax], scale = amax / qmax.
    ``bits=4`` packs two planes per byte and needs an even K."""
    if dither is not None:
        raise _not_ported("dither=", "A.4")
    if spack.scales is not None:
        return spack
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if bits == 4 and spack.K % 2:
        raise ValueError("int4 nibble packs require even K "
                         "(planes pair per byte)")
    codes, scales = _pack.quantize_tables(spack.seg_planes, spack.K,
                                          _channels_of(spack), bits)
    return spack._replace(seg_planes=codes, scales=scales,
                          qbits=None if bits == 8 else 4)


def decimate_segment_pack(spack: SegmentPack,
                          stride: int = 2) -> SegmentPack:
    """Keep every ``stride``-th plane: K' = K/stride slabs of
    dp' = stride*dp per segment. rk2s2 on a stride-2 pack is bit-identical
    to rk2s4 on the full pack; decimation commutes with quantisation."""
    if stride < 1 or spack.K % stride:
        raise ValueError(f"K={spack.K} must divide by stride={stride}")
    if stride == 1:
        return spack
    K, Kd = spack.K, spack.K // stride
    if spack.qbits == 4 and Kd % 2:
        raise ValueError(f"int4 nibble packs need an even K/stride "
                         f"(got K={K}, stride={stride})")
    tables = _pack.decimate_tables(spack.seg_planes, K, _channels_of(spack),
                                   stride, nibbles=spack.qbits == 4)
    scales = spack.scales
    if scales is not None:
        scales = scales[:, ::stride].contiguous()
    return spack._replace(seg_planes=tables, K=Kd,
                          n_slabs=-(-spack.n_slabs // stride),
                          dp=spack.dp * stride, scales=scales)


def build_segment_pack_device(
    domain: ScalarDomain,
    lwl: float = 1064e-9,
    K: int = 64,
    dtype=torch.bfloat16,
    free_ne: bool = False,
    plane_stride: int = 1,
    dither=None,
    mesh=None,
) -> SegmentPack:
    """SegmentPack built on the domain's device by kernel K2.

    ``dtype``: torch.float32, torch.bfloat16, torch.int8 or "int4".
    Quantised tiers are the quantisation of the f32 build, computed from
    the volumes without a float table (the JAX package's fused quantiser).
    ``plane_stride`` keeps every stride-th plane, the gradients still
    computed at full resolution: the decimation of the full build, built
    directly (the JAX package's fused strided route, at every size).
    ``free_ne`` drops the domain's field references once they are read.
    """
    if dither is not None:
        raise _not_ported("dither=", "A.4")
    if mesh is not None:
        raise _not_ported("mesh=", "A.17")
    layout = layout_of(domain)
    if domain.ne is None:
        raise RuntimeError("domain has no electron density")
    if layout.inv_brems and (domain.Te is None or domain.Z is None):
        raise RuntimeError("inv_brems requires Te and Z grids")
    if layout.B_on and domain.B is None:
        raise RuntimeError("B_on requires a B grid")
    quantized4 = isinstance(dtype, str) and dtype == "int4"
    quantized = quantized4 or dtype == torch.int8
    if not quantized and dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported pack dtype {dtype!r}")
    if plane_stride < 1 or K % plane_stride:
        raise ValueError(f"K={K} must divide by plane_stride={plane_stride}")
    Ko = K // plane_stride
    if quantized4 and Ko % 2:
        raise ValueError("int4 nibble packs require even K after "
                         "plane_stride (output planes pair per byte)")
    p_ax, _, _, ca, cb, cp = _geometry(domain)
    ca_h, cb_h, cp_h = ca.cpu(), cb.cpu(), cp.cpu()
    da = float(ca_h[1] - ca_h[0])
    db = float(cb_h[1] - cb_h[0])
    dp = float(cp_h[1] - cp_h[0])
    omega = float(_c.omega_from_lwl(lwl))
    nc = float(_c.critical_density(omega))
    n_seg = -(-(cp.shape[0] - 1) // K)
    vols = {"ne": domain.ne, "Te": domain.Te, "Z": domain.Z,
            "B": domain.B}
    if free_ne:
        domain.ne = domain.Te = domain.Z = domain.B = None
    kw = dict(p_ax=p_ax, layout=layout, K=K, n_seg=n_seg,
              pref=-0.5 * _c.C**2 / nc, da=da, db=db, dp=dp, omega=omega,
              verdet=_c.verdet_constant(lwl) if layout.B_on else 0.0,
              plane_stride=plane_stride)
    scales = None
    if quantized:
        table, scales = _pack.build_quantized_tables(
            vols, bits=4 if quantized4 else 8, **kw)
    else:
        table = _pack.build_tables(vols, dtype=dtype, **kw)
    del vols
    origin_ab, inv_ab = _origin_inv(ca, cb)
    return SegmentPack(table, origin_ab, inv_ab,
                       (ca.shape[0], cb.shape[0]), Ko,
                       -(-(cp.shape[0] - 1) // plane_stride),
                       float(cp_h[0]), dp * plane_stride, omega, scales,
                       4 if quantized4 else None)


def trace_zscan_segments(
    u: torch.Tensor,
    seg_planes: torch.Tensor,
    origin_ab,
    inv_ab,
    dp: float,
    *,
    shape_ab: Tuple[int, int],
    layout,
    K: int,
    n_seg: int,
    substeps: int = 1,
    atten_sign: float = -1.0,
    block: Optional[int] = None,
    integrator: str = "rk4",
    remat: bool = False,
    weights: str = "stage",
    seg_scales: Optional[torch.Tensor] = None,
    qbits: Optional[int] = None,
) -> torch.Tensor:
    """March (N, 8) permuted rays through ``n_seg`` segments of K slabs
    (kernel K1). ``integrator``: "rk4", "rk2" (midpoint), "rk2s2" (2-slab
    midpoint) or "rk2s4" (4-slab midpoint); ``weights``: "stage" (corner
    weights at every stage) or "slab" (once per slab)."""
    if substeps != 1:
        raise _not_ported("substeps > 1", "A.4")
    if block is not None:
        raise _not_ported("block=", "A.4")
    if remat:
        raise _not_ported("remat", "B8")
    if integrator not in _march.INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")
    if weights not in ("stage", "slab"):
        raise ValueError(f"unknown weights mode {weights!r}")
    if qbits == 4:
        if seg_scales is None:
            raise ValueError("int4 packs carry a scales table")
        if integrator not in ("rk2s2", "rk2s4"):
            raise ValueError(
                "int4 nibble packs run on the even-stride integrators "
                "(rk2s2, rk2s4) whose stage planes align to whole byte "
                "blocks; got integrator=" + repr(integrator))
        if (integrator == "rk2s2" and K % 2) or (
                integrator == "rk2s4" and K % 4):
            raise ValueError("int4 packs need K divisible by the stride "
                             "(no single-slab remainder steps)")
    elif qbits is not None:
        raise ValueError(f"unknown qbits {qbits!r} (None or 4)")
    if seg_planes.shape[0] != n_seg:
        raise ValueError(f"table has {seg_planes.shape[0]} segments, "
                         f"n_seg={n_seg}")
    return _march.march(
        u, seg_planes, seg_scales, shape_ab=shape_ab,
        origin_ab=[float(v) for v in origin_ab.tolist()],
        inv_ab=[float(v) for v in inv_ab.tolist()], dp=float(dp),
        layout=layout, K=K, integrator=integrator, weights=weights,
        qbits=qbits, atten_sign=atten_sign)


def solve_zscan_segments(
    s0: torch.Tensor,
    domain: ScalarDomain,
    probing_depth: Optional[float] = None,
    *,
    lwl: float = 1064e-9,
    return_E: bool = False,
    substeps: int = 1,
    K: int = 64,
    atten_sign: float = -1.0,
    spack: Optional[SegmentPack] = None,
    integrator: str = "rk4",
    weights: str = "stage",
) -> TraceResult:
    """Trace a (9, N) bundle through the segmented march and resolve the
    exit plane. Without ``spack``, an f32 pack of K-slab segments is built
    from the domain."""
    layout = layout_of(domain)
    if probing_depth is None:
        probing_depth = domain.extent
    if spack is None:
        spack = build_segment_pack_device(domain, lwl=lwl, K=K,
                                          dtype=torch.float32)
    u = permute_state(s0, domain.probing_direction)
    n_seg = spack.seg_planes.shape[0]
    if u.is_cuda:
        torch.cuda.synchronize(u.device)
    start = time.perf_counter()
    uf = trace_zscan_segments(
        u, spack.seg_planes, spack.origin_ab, spack.inv_spacing_ab,
        spack.dp, shape_ab=spack.shape_ab, layout=layout, K=spack.K,
        n_seg=n_seg, substeps=substeps, atten_sign=atten_sign,
        integrator=integrator, weights=weights, seg_scales=spack.scales,
        qbits=spack.qbits)
    if uf.is_cuda:
        torch.cuda.synchronize(uf.device)
    duration = time.perf_counter() - start
    sf = reassemble_state(uf, spack.p0 + n_seg * spack.K * spack.dp,
                          domain.probing_direction)
    rf, Jf = ray_to_Jonesvector(sf, probing_depth,
                                probing_direction=domain.probing_direction,
                                return_E=return_E)
    return TraceResult(rf, Jf, sf, duration)
