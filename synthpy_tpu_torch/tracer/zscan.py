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

The scale builders fill a pack plane batch by plane batch with kernel K9
(``kernels.fill``): ``build_segment_pack_upload`` from volumes on the host
(pinned, copied up on a side stream one batch ahead),
``build_segment_pack_synth`` from field closures evaluated on the card,
and ``build_segment_pack_streaming`` segment by segment, into a table on
the card or in pinned host memory (``device=False``, a host pack). A host
pack is marched segment by segment by ``solve_zscan_segments_streamed``,
each segment copied up on a side stream while K1 marches the one before
(``DeviceSegmentCache`` keeps a prefix of them on the card). Dithered
int8/int4 packs draw JAX's threefry stream (``kernels.random``), so they
equal the JAX package's for the same key.

Under autograd the segmented march is ``_SegmentMarch``: K1 forward one
segment at a time, keeping the segment-start states, and kernel K11
(``kernels.march_adjoint``) backward segment by segment, for rk4 with
stage weights on float32 or bf16 tables (what ``inverse.make_renderer``
runs); other configurations raise under autograd, naming ROADMAP B8.

``build_segment_pack_device(mesh=)`` builds the pack split into a-row
blocks over a grid axis of a ``parallel.Mesh``, each shard its own rows on
its own device (K2 on a row window, with a one-row halo from each
neighbour), for the grid-sharded march
(``parallel.make_gridsharded_segment_tracer``).

Not ported yet, and raising ``NotImplementedError`` with their ROADMAP item:
on the segmented march ``block=`` and ``substeps > 1`` (A.4).
"""

from __future__ import annotations

import hashlib
import os
import time
import weakref
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from synthpy_tpu_torch import _device
from synthpy_tpu_torch import constants as _c
from synthpy_tpu_torch import random as _rand
from synthpy_tpu_torch.fields.domain import (ChannelLayout, ScalarDomain,
                                             TracePack, build_pack,
                                             host_resident, layout_of)
from synthpy_tpu_torch.kernels import fill as _fill
from synthpy_tpu_torch.kernels import march as _march
from synthpy_tpu_torch.kernels import march_adjoint as _adjoint
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
    host: True for a host pack, whose ``seg_planes`` (and ``scales``) stay
        in (pinned) host memory and are marched segment by segment
        (``solve_zscan_segments_streamed``); the JAX package's host packs
        hold a numpy ``seg_planes``.
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
    host: bool = False


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
    ``bits=4`` packs two planes per byte and needs an even K.

    ``dither``: a key (``random.PRNGKey``, a JAX key) or an int seed: JAX's
    non-subtractive dither, u ~ U[-0.5, 0.5) from fold_in(key, s*K + k)
    over (cells, C), added to value / scale where the value is not zero
    (exact zeros stay exact)."""
    if spack.scales is not None:
        return spack
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if bits == 4 and spack.K % 2:
        raise ValueError("int4 nibble packs require even K "
                         "(planes pair per byte)")
    codes, scales = _pack.quantize_tables(
        spack.seg_planes, spack.K, _channels_of(spack), bits,
        None if dither is None else _rand.key_of(dither))
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
    fuse_threshold_bytes: int = 4 << 30,
    dither=None,
    mesh=None,
    mesh_axis: str = "grid",
) -> SegmentPack:
    """SegmentPack built on the domain's device by kernel K2.

    ``fuse_threshold_bytes`` picks between the JAX package's fused and
    two-step XLA programs, which give the same pack; K2 is one route for
    every size, so it has no effect here.

    ``dtype``: torch.float32, torch.bfloat16, torch.int8 or "int4".
    Quantised tiers are the quantisation of the f32 build, computed from
    the volumes without a float table (the JAX package's fused quantiser).
    ``plane_stride`` keeps every stride-th plane, the gradients still
    computed at full resolution: the decimation of the full build, built
    directly (the JAX package's fused strided route, at every size).
    ``free_ne`` drops the domain's field references once they are read.
    ``dither`` (int8 / int4 only): a key or an int seed, keyed by the
    absolute plane index over (na, nb, C), so that every build route and
    ``quantize_segment_pack`` of the full build dither alike.

    ``mesh`` (a ``parallel.Mesh``): the pack split along the transverse
    a-axis over ``mesh_axis``, its ``seg_planes`` a ``parallel.Sharded``
    of a-row blocks on the shards' devices (the scales whole, on the
    domain's device), bit-equal to the single-device build; na must
    divide over the axis, as in JAX. Each shard builds its own rows on its
    device (K2 on a row window, ``kernels.pack.Window``): its ne rows (a
    sharded ne as it is stored, moved by an all-to-all where it is split
    along another axis; a tensor ne split), one halo row from each
    neighbour (a ``ppermute``), and for int8 / int4 the field's amax, the
    shards' amax passes max-reduced over the axis before the codes are
    written. The whole ne is never gathered.
    """
    if mesh is not None:
        from synthpy_tpu_torch.parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh, not "
                            f"{type(mesh).__name__}")
        G = mesh.shape[mesh_axis]
        na = _geometry(domain)[3].shape[0]
        if na % G:
            raise ValueError(f"transverse a-dim {na} must divide over the "
                             f"{G}-way '{mesh_axis}' axis")
    layout = layout_of(domain)
    if domain.ne_stored is None:
        raise RuntimeError("domain has no electron density")
    if layout.inv_brems and (domain.Te is None or domain.Z is None):
        raise RuntimeError("inv_brems requires Te and Z grids")
    if layout.B_on and domain.B is None:
        raise RuntimeError("B_on requires a B grid")
    quantized4 = isinstance(dtype, str) and dtype == "int4"
    quantized = quantized4 or dtype == torch.int8
    if not quantized and dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported pack dtype {dtype!r}")
    if dither is not None and not quantized:
        raise ValueError("dither applies to quantised dtypes "
                         "(int8 / 'int4') only")
    _host_refused(domain, "build_segment_pack_device")
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
    kw = dict(p_ax=p_ax, layout=layout, K=K, n_seg=n_seg,
              pref=-0.5 * _c.C**2 / nc, da=da, db=db, dp=dp, omega=omega,
              verdet=_c.verdet_constant(lwl) if layout.B_on else 0.0,
              plane_stride=plane_stride)
    bits = (4 if quantized4 else 8) if quantized else None
    dkey = None if dither is None else _rand.key_of(dither)
    if mesh is not None:
        table, scales = _build_sharded(domain, mesh, mesh_axis, bits, dtype,
                                       dkey, free_ne, kw)
    else:
        vols = {"ne": domain.ne, "Te": domain.Te, "Z": domain.Z,
                "B": domain.B}
        if free_ne:
            domain.ne = domain.Te = domain.Z = domain.B = None
        scales = None
        if quantized:
            table, scales = _pack.build_quantized_tables(
                vols, bits=bits, dither=dkey, **kw)
        else:
            table = _pack.build_tables(vols, dtype=dtype, **kw)
        del vols
    origin_ab, inv_ab = _origin_inv(ca, cb)
    return SegmentPack(table, origin_ab, inv_ab,
                       (ca.shape[0], cb.shape[0]), Ko,
                       -(-(cp.shape[0] - 1) // plane_stride),
                       float(cp_h[0]), dp * plane_stride, omega, scales,
                       4 if quantized4 else None)


def _split_volumes(domain: ScalarDomain, mesh, axis: str, a_ax: int):
    """Per flat mesh position, the domain's volumes cut to the shard's
    a-rows on its device, contiguous: ne as it is stored (a ``Sharded``
    split along another dimension moved by an all-to-all, a tensor split),
    Te, Z and B split from the domain's device."""
    from synthpy_tpu_torch.parallel.mesh import Sharded, all_to_all, shard

    spec = tuple(axis if d == a_ax else None for d in range(3))
    ne = domain.ne_stored
    if isinstance(ne, Sharded):
        d = ne.split_dim()
        if ne.mesh is not mesh or d is None or ne.spec[d] != axis:
            raise ValueError(f"ne is sharded as {ne.spec} on {ne.mesh}, "
                             f"not split over the {axis!r} axis of {mesh}")
        blocks = (ne.shards if d == a_ax else
                  all_to_all(ne.shards, mesh, axis, split_dim=a_ax,
                             concat_dim=d))
    else:
        blocks = shard(ne, mesh, spec).shards
    out = [{"ne": b.contiguous()} for b in blocks]
    for name in ("Te", "Z", "B"):
        v = getattr(domain, name)
        parts = ([None] * mesh.size if v is None
                 else shard(v, mesh, spec).shards)
        for o, t in zip(out, parts):
            o[name] = None if t is None else t.contiguous()
    return out


def halo_rows(vols, mesh, axis: str, a_ax: int):
    """(lo, hi) per flat position: the ne a-row before and after each
    shard's rows, ppermuted from its neighbours (zeros at the edges)."""
    from synthpy_tpu_torch.parallel.mesh import ppermute

    G = mesh.shape[axis]
    n = vols[0]["ne"].shape[a_ax]
    # shard g + 1 receives shard g's last a-row, shard g its right
    # neighbour's first
    lo = ppermute([v["ne"].narrow(a_ax, n - 1, 1).contiguous()
                   for v in vols], mesh, axis,
                  [(i, i + 1) for i in range(G - 1)])
    hi = ppermute([v["ne"].narrow(a_ax, 0, 1).contiguous() for v in vols],
                  mesh, axis, [(i + 1, i) for i in range(G - 1)])
    return lo, hi


def shard_windows(domain: ScalarDomain, mesh, axis: str, p_ax: int):
    """The inputs of the sharded build's K2 launches: (vols per flat
    position, {(grid index, device): (flat position, ``kernels.pack.
    Window``)} once per distinct block and device)."""
    G = mesh.shape[axis]
    a_ax = [a for a in range(3) if a != p_ax][0]
    vols = _split_volumes(domain, mesh, axis, a_ax)
    na_loc = vols[0]["ne"].shape[a_ax]
    lo, hi = halo_rows(vols, mesh, axis, a_ax)
    windows = {}
    for p, dev in enumerate(mesh.flat_devices):
        g = mesh.index(p, axis)
        if (g, dev) not in windows:
            windows[(g, dev)] = (p, _pack.Window(
                g * na_loc, na_loc * G, lo[p] if g > 0 else None,
                hi[p] if g < G - 1 else None))
    return vols, windows


def _build_sharded(domain: ScalarDomain, mesh, axis: str,
                   bits: Optional[int], dtype, dkey, free_ne: bool, kw):
    """``build_segment_pack_device(mesh=)``'s tables: each shard's rows by
    K2 on its row window, once per distinct (block, device); returns
    (the ``Sharded`` tables, the scales or None)."""
    from synthpy_tpu_torch.parallel.mesh import Sharded, local_axis, pmax

    local_axis(mesh, axis, "the sharded pack build")
    vols, windows = shard_windows(domain, mesh, axis, kw["p_ax"])
    if free_ne:
        domain.ne = domain.Te = domain.Z = domain.B = None
    keys = [(mesh.index(p, axis), dev)
            for p, dev in enumerate(mesh.flat_devices)]
    scales = None
    if bits is None:
        tabs = {k: _pack.build_tables(vols[p], dtype=dtype, window=w, **kw)
                for k, (p, w) in windows.items()}
    else:
        amax = {k: _pack.build_amax(vols[p], window=w, **kw)
                for k, (p, w) in windows.items()}
        amax = pmax([amax[k] for k in keys], mesh, axis)
        codes = {k: _pack.build_quantized_tables(
            vols[p], bits=bits, dither=dkey, window=w, amax=amax[p], **kw)
            for k, (p, w) in windows.items()}
        tabs = {k: c for k, (c, _) in codes.items()}
        scales = codes[keys[0]][1].to(domain.device)
    t0 = tabs[keys[0]]
    rows = t0.shape[1] * mesh.shape[axis]
    return Sharded(mesh, (None, axis, None), [tabs[k] for k in keys],
                   (t0.shape[0], rows, t0.shape[2])), scales


def check_march(integrator: str, weights: str, K: int,
                qbits: Optional[int], seg_scales, substeps: int = 1) -> None:
    """Raise unless the segmented march (K1, and K17 on a shard) runs this
    configuration: a known integrator and weights mode, one substep, and
    int4 tables only on the even-stride integrators with a scales
    table."""
    if substeps != 1:
        raise _not_ported("substeps > 1", "A.4")
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
    ray_chunk: Optional[int] = None,
    unroll: int = 2,
) -> torch.Tensor:
    """March (N, 8) permuted rays through ``n_seg`` segments of K slabs
    (kernel K1). ``integrator``: "rk4", "rk2" (midpoint), "rk2s2" (2-slab
    midpoint) or "rk2s4" (4-slab midpoint); ``weights``: "stage" (corner
    weights at every stage) or "slab" (once per slab). ``ray_chunk`` and
    ``unroll`` are the JAX program's memory and scan knobs and have no
    effect here.

    Differentiable in ``u`` and ``seg_planes`` for rk4 with stage weights on
    a float32 or bf16 table: the forward keeps each segment's start state
    and the backward runs the adjoint (kernel K11) segment by segment, so
    memory grows with n_seg, not with the slab count, whatever ``remat``
    says. ``remat=True`` and ``remat=False`` give the same gradient, as in
    JAX (where ``remat`` places ``jax.checkpoint``s); the flag is kept so
    that JAX callers run unchanged. A bf16 table's cotangent is summed in
    float32 and rounded to bf16 once, where JAX's transposed ``astype``
    sums it in bf16: the two differ by bf16 rounding (2^-8 relative). Any
    other configuration raises ``NotImplementedError`` (ROADMAP B8) when a
    gradient is asked of it."""
    del ray_chunk, unroll
    if block is not None:
        raise _not_ported("block=", "A.4")
    check_march(integrator, weights, K, qbits, seg_scales, substeps)
    if seg_planes.shape[0] != n_seg:
        raise ValueError(f"table has {seg_planes.shape[0]} segments, "
                         f"n_seg={n_seg}")
    kw = dict(shape_ab=shape_ab,
              origin_ab=[float(v) for v in origin_ab.tolist()],
              inv_ab=[float(v) for v in inv_ab.tolist()], dp=float(dp),
              layout=layout, K=K, atten_sign=atten_sign)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (u, seg_planes, seg_scales))
    if not grad:
        return _march.march(u, seg_planes, seg_scales, integrator=integrator,
                            weights=weights, qbits=qbits, **kw)
    if not _adjoint.covers(integrator, weights, seg_planes.dtype, qbits):
        raise _not_ported(
            f"the gradient of the segmented march with integrator="
            f"{integrator!r}, weights={weights!r} on a {seg_planes.dtype} "
            "table (covered: rk4, stage weights, float32 or bf16)", "B8")
    return _SegmentMarch.apply(u, seg_planes, kw)


class _SegmentMarch(torch.autograd.Function):
    """The rk4 / stage-weights segmented march under autograd: K1 one
    segment at a time forward (on one-segment views of the table, as
    ``march_streamed``), keeping the n_seg start states; K11
    (``kernels.march_adjoint``) backward, last segment first. On CPU
    tensors the same bookkeeping runs the plain versions."""

    @staticmethod
    def forward(ctx, u, seg_planes, kw):
        starts = []
        for s in range(seg_planes.shape[0]):
            starts.append(u)
            u = _march.march(u, seg_planes[s:s + 1], None, **kw)
        ctx.save_for_backward(seg_planes, *starts)
        ctx.kw = kw
        return u

    @staticmethod
    def backward(ctx, du):
        seg_planes, *starts = ctx.saved_tensors
        dseg = (torch.zeros(seg_planes.shape,
                            dtype=_adjoint.grad_dtype(seg_planes.dtype),
                            device=seg_planes.device)
                if ctx.needs_input_grad[1] else None)
        du = du.contiguous()
        for s in reversed(range(len(starts))):
            du = _adjoint.march_adjoint(
                starts[s], seg_planes[s], du,
                dseg=None if dseg is None else dseg[s], **ctx.kw)
        if dseg is not None:
            dseg = dseg.to(seg_planes.dtype)
        return du, dseg, None


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
    pack: Optional[TracePack] = None,
    spack: Optional[SegmentPack] = None,
    ray_chunk: Optional[int] = None,
    unroll: int = 2,
    integrator: str = "rk4",
    weights: str = "stage",
) -> TraceResult:
    """Trace a (9, N) bundle through the segmented march and resolve the
    exit plane. Without ``spack``, an f32 pack of K-slab segments is made:
    regrouped from ``pack`` (a ``TracePack``, as the JAX package's
    ``ScalarDomain.solve`` passes it) when one is given, else built from
    the domain by kernel K2. ``ray_chunk`` and ``unroll`` tune the JAX
    program only and have no effect here."""
    del ray_chunk, unroll
    layout = layout_of(domain)
    if probing_depth is None:
        probing_depth = domain.extent
    if spack is None and pack is not None:
        spack = make_segment_pack(
            make_zscan_pack(pack, layout, domain.probing_direction), K=K)
    elif spack is None:
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


# ---------------------------------------------------------------------------
# Host-resident fields and packs: the segment-streamed march
# ---------------------------------------------------------------------------

def _host_refused(domain: ScalarDomain, what: str) -> None:
    """Refuse host-resident volumes (``external_*(host=True)``) where a
    builder would read the whole volume on the card."""
    if domain.ne_stored is not None and host_resident(domain):
        raise ValueError(
            f"{what} needs the fields on {domain.device}; the domain's ne "
            "is host-resident (external_ne(host=True)): use "
            "build_segment_pack_upload or build_segment_pack_streaming")


class DeviceSegmentCache:
    """A prefix of a host pack's segment tables, kept on the card.

    The streamed march copies every segment up on every call; this keeps
    the first ``budget_bytes`` worth resident, so repeated streamed solves
    copy only the rest. Made by ``make_device_segment_cache`` and passed to
    ``solve_zscan_segments_streamed`` (``pipeline.run``'s ``seg_cache=``).
    It is tied to the pack's table by a weak reference; drop it to free
    the device buffers.
    """

    def __init__(self, hpack: SegmentPack, budget_bytes: int,
                 device="cuda"):
        table = hpack.seg_planes
        n_seg = table.shape[0]
        seg_bytes = table[0].numel() * table.element_size()
        n_res = max(0, min(int(budget_bytes // max(seg_bytes, 1)), n_seg))
        dev = _device.resolve(device)
        self._ref = weakref.ref(table)
        self.n_seg = n_seg
        self.resident = [table[i].to(dev) for i in range(n_res)]

    def matches(self, seg_planes) -> bool:
        return self._ref() is seg_planes

    def get(self, si: int):
        """The device table of segment ``si`` if resident, else None."""
        return self.resident[si] if si < len(self.resident) else None


def make_device_segment_cache(hpack: SegmentPack,
                              budget_bytes: int = 8 << 30,
                              device="cuda") -> DeviceSegmentCache:
    """Keep a prefix of ``hpack``'s segment tables on ``device``."""
    return DeviceSegmentCache(hpack, budget_bytes, device)


def _segments_up(hpack: SegmentPack, dev: torch.device,
                 cache: Optional[DeviceSegmentCache]):
    """Yield (segment table on ``dev``, its scales or None), each segment
    copied up on a side stream while the one before is marched: segment
    s+1's copy is issued before segment s is handed out, and the march's
    stream waits on an event for it (``record_stream`` keeps the
    allocator from reusing the buffer while the march reads it)."""
    table, scales = hpack.seg_planes, hpack.scales
    n_seg = table.shape[0]
    if dev.type == "cpu":
        for si in range(n_seg):
            hit = None if cache is None else cache.get(si)
            yield (table[si] if hit is None else hit,
                   None if scales is None else scales[si])
        return
    sc_dev = None if scales is None else scales.to(dev)
    side = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)

    def issue(si):
        hit = None if cache is None else cache.get(si)
        if hit is not None:
            return hit, None
        side.wait_stream(main)
        with torch.cuda.stream(side):
            seg = table[si].to(dev, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        return seg, ev

    nxt = issue(0)
    for si in range(n_seg):
        seg, ev = nxt
        if si + 1 < n_seg:
            nxt = issue(si + 1)
        if ev is not None:
            main.wait_event(ev)
            seg.record_stream(main)
        yield seg, None if sc_dev is None else sc_dev[si]


def march_streamed(u: torch.Tensor, hpack: SegmentPack, *, layout,
                   integrator: str = "rk4", weights: str = "stage",
                   substeps: int = 1, atten_sign: float = -1.0,
                   cache: Optional[DeviceSegmentCache] = None
                   ) -> torch.Tensor:
    """March (N, 8) permuted rays through a host pack segment by segment:
    one K1 launch per segment on a one-segment view of the table (the JAX
    package's ``_march_one_segment``), so the result is the in-memory
    march's, bit for bit."""
    if cache is not None and not cache.matches(hpack.seg_planes):
        raise ValueError("seg cache was built for a different pack")
    for seg, sc in _segments_up(hpack, u.device, cache):
        u = trace_zscan_segments(
            u, seg[None], hpack.origin_ab, hpack.inv_spacing_ab, hpack.dp,
            shape_ab=hpack.shape_ab, layout=layout, K=hpack.K, n_seg=1,
            substeps=substeps, atten_sign=atten_sign, integrator=integrator,
            weights=weights, seg_scales=None if sc is None else sc[None],
            qbits=hpack.qbits)
    return u


def solve_zscan_segments_streamed(
    s0: torch.Tensor,
    domain: ScalarDomain,
    probing_depth: Optional[float] = None,
    *,
    hpack: SegmentPack,
    lwl: float = 1064e-9,
    return_E: bool = False,
    substeps: int = 1,
    atten_sign: float = -1.0,
    ray_chunk: Optional[int] = None,
    unroll: int = 2,
    integrator: str = "rk4",
    weights: str = "stage",
    cache: Optional[DeviceSegmentCache] = None,
) -> TraceResult:
    """Segment-streamed march of a (9, N) bundle through a host pack (packs
    larger than the card): each segment is copied up on a side stream while
    K1 marches the one before, and marched with the in-memory tracer's
    arithmetic, so the result is ``solve_zscan_segments``'s bit for bit.
    Device memory holds two segment tables and the rays.

    ``lwl`` is read by neither package here: the pack's channels were
    computed for the wavelength it was built with (the JAX package takes
    the argument and leaves it unused too). ``ray_chunk`` and ``unroll``
    tune the JAX program only."""
    del lwl, ray_chunk, unroll
    layout = layout_of(domain)
    if probing_depth is None:
        probing_depth = domain.extent
    u = permute_state(s0, domain.probing_direction)
    if u.is_cuda:
        torch.cuda.synchronize(u.device)
    start = time.perf_counter()
    uf = march_streamed(u, hpack, layout=layout, integrator=integrator,
                        weights=weights, substeps=substeps,
                        atten_sign=atten_sign, cache=cache)
    if uf.is_cuda:
        torch.cuda.synchronize(uf.device)
    duration = time.perf_counter() - start
    n_seg = hpack.seg_planes.shape[0]
    sf = reassemble_state(uf, hpack.p0 + n_seg * hpack.K * hpack.dp,
                          domain.probing_direction)
    rf, Jf = ray_to_Jonesvector(sf, probing_depth,
                                probing_direction=domain.probing_direction,
                                return_E=return_E)
    return TraceResult(rf, Jf, sf, duration)


# ---------------------------------------------------------------------------
# The scale builders: plane batches filled in place by K9
# ---------------------------------------------------------------------------

class _Geometry(NamedTuple):
    p_ax: int
    a_ax: int
    b_ax: int
    na: int
    nb: int
    n_p: int
    da: float
    db: float
    dp: float
    omega: float
    pref: float
    verdet: float
    p0: float
    origin_ab: torch.Tensor
    inv_ab: torch.Tensor


def _geometry_of(domain: ScalarDomain, lwl: float) -> _Geometry:
    layout = layout_of(domain)
    p_ax, a_ax, b_ax, ca, cb, cp = _geometry(domain)
    ca_h, cb_h, cp_h = ca.cpu(), cb.cpu(), cp.cpu()
    omega = float(_c.omega_from_lwl(lwl))
    nc = float(_c.critical_density(omega))
    origin_ab, inv_ab = _origin_inv(ca, cb)
    return _Geometry(p_ax, a_ax, b_ax, ca.shape[0], cb.shape[0],
                     cp.shape[0], float(ca_h[1] - ca_h[0]),
                     float(cb_h[1] - cb_h[0]), float(cp_h[1] - cp_h[0]),
                     omega, -0.5 * _c.C**2 / nc,
                     _c.verdet_constant(lwl) if layout.B_on else 0.0,
                     float(cp_h[0]), origin_ab, inv_ab)


def _fill_kw(geo: _Geometry, layout, mode: int, dither) -> dict:
    return dict(mode=mode, layout=layout, n_p=geo.n_p, pref=geo.pref,
                da=geo.da, db=geo.db, dp=geo.dp, omega=geo.omega,
                verdet=geo.verdet,
                dither=None if dither is None else _rand.key_of(dither))


def _tier(dtype):
    """(fill mode, quantised, int4) of a pack dtype."""
    mode = _fill.mode_of(dtype)
    return mode, mode >= 2, mode == 3


def _schedule(n_seg: int, K: int, PB: int, int4: bool):
    """Every (segment, k0, pb, lone) body batch of PB planes, then each
    segment's final plane K on its own (duplicated as plane 0 of the next
    segment; a zero high nibble for int4)."""
    sched = []
    for s_i in range(n_seg):
        sched += [(s_i, k0, min(PB, K - k0), False)
                  for k0 in range(0, K, PB)]
        sched.append((s_i, K, 1, int4))
    return sched


def _col0(k0: int, C: int, int4: bool) -> int:
    return (k0 // 2 if int4 else k0) * C


def _extra_volumes(domain: ScalarDomain, geo: _Geometry):
    layout = layout_of(domain)
    vols = []
    if layout.inv_brems:
        if domain.Te is None or domain.Z is None:
            raise RuntimeError("inv_brems requires Te and Z grids")
        vols += [domain.Te, domain.Z]
    if layout.B_on:
        if domain.B is None:
            raise RuntimeError("B_on requires a B grid")
        vols += [domain.B[..., geo.a_ax], domain.B[..., geo.b_ax],
                 domain.B[..., geo.p_ax]]
    return vols


def _volume_batches(domain: ScalarDomain, geo: _Geometry, sched, K: int,
                    n_hi: int, dev: torch.device):
    """Yield (s_i, k0, pb, lone, slab, ex) for each batch of ``sched`` on
    ``dev``: cut from the volumes where they already live there, staged up
    from padded pinned copies where they are host volumes headed for a
    card (planes up to ``n_hi`` + 1)."""
    if domain.ne is None:
        raise RuntimeError("domain has no electron density")
    if domain.ne.device.type == dev.type:
        return _sliced_batches(domain, geo, sched, K)
    ne_pad, ex_pad = _probe_major(domain, geo, n_hi)
    return _staged_batches(sched, K, ne_pad, ex_pad, dev)


def _sliced_batches(domain: ScalarDomain, geo: _Geometry, sched, K: int):
    """Batches gathered from probe-axis views of the volumes: one batch of
    planes is copied at a time (plane -1 is plane 0 again, planes at n_p
    or beyond are zero, as in ``_probe_major``'s tables)."""
    n_p = geo.n_p
    ne = domain.ne.movedim(geo.p_ax, 0)
    extras = [v.movedim(geo.p_ax, 0) for v in _extra_volumes(domain, geo)]

    def planes(vol, lo, hi):
        """Absolute planes lo .. hi - 1 (lo >= -1) of a probe-major view."""
        parts = [vol[:1]] if lo < 0 else []
        parts.append(vol[max(lo, 0):min(hi, n_p)])
        n_past = hi - max(lo, n_p)
        if n_past > 0:
            parts.append(vol.new_zeros((n_past, *vol.shape[1:])))
        return torch.cat(parts).to(torch.float32)

    for s_i, k0, pb, lone in sched:
        g0 = s_i * K + k0
        slab = planes(ne, g0 - 1, g0 + pb + 1)
        ex = (torch.stack([planes(v, g0, g0 + pb) for v in extras], dim=1)
              if extras else slab.new_zeros((pb, 0, *slab.shape[1:])))
        yield s_i, k0, pb, lone, slab, ex


def _probe_major(domain: ScalarDomain, geo: _Geometry, n_hi: int):
    """Probe-major padded copies of host volumes headed for a card, in
    pinned host memory: ne_pad (n_hi + 3, na, nb), ne_pad[1 + i] = plane
    i, ne_pad[0] = plane 0 again, zeros past the grid; ex_pad (n_hi + 1,
    n_extra, na, nb), plane-major, so that every batch is a contiguous
    slice of both."""
    extras = _extra_volumes(domain, geo)

    def empty(shape):
        return torch.empty(shape, dtype=torch.float32, pin_memory=True)

    na, nb, n_p = geo.na, geo.nb, geo.n_p
    ne_pad = empty((n_hi + 3, na, nb))
    ne_pad[1:n_p + 1].copy_(domain.ne.movedim(geo.p_ax, 0))
    ne_pad[0] = ne_pad[1]
    ne_pad[n_p + 1:] = 0.0
    ex_pad = empty((n_hi + 1, len(extras), na, nb))
    for j, vol in enumerate(extras):
        ex_pad[:n_p, j].copy_(vol.movedim(geo.p_ax, 0))
    ex_pad[n_p:] = 0.0
    return ne_pad, ex_pad


def _staged_batches(sched, K: int, ne_pad: torch.Tensor,
                    ex_pad: torch.Tensor, dev: torch.device):
    """Yield (s_i, k0, pb, lone, slab, ex) with slab and ex on the card
    ``dev``: the host arrays go up through two device staging buffers on a
    side stream, batch i+1's copy issued before batch i is handed out (the
    JAX package's producer thread); the compute stream waits on an event
    for each copy, and a copy waits for the fill that last read its
    buffer."""
    PB = max(pb for _, _, pb, _ in sched)
    n_extra, na, nb = ex_pad.shape[1:]
    stage = [(torch.empty((PB + 2, na, nb), device=dev),
              torch.empty((PB, n_extra, na, nb), device=dev))
             for _ in range(2)]
    freed = [None, None]
    side = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)

    def issue(i):
        s_i, k0, pb, _ = sched[i]
        g0 = s_i * K + k0
        slab, ex = stage[i % 2]
        with torch.cuda.stream(side):
            if freed[i % 2] is not None:
                side.wait_event(freed[i % 2])
            slab[:pb + 2].copy_(ne_pad[g0:g0 + pb + 2], non_blocking=True)
            ex[:pb].copy_(ex_pad[g0:g0 + pb], non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(side)
        return ev

    ready = issue(0)
    for i, (s_i, k0, pb, lone) in enumerate(sched):
        nxt = issue(i + 1) if i + 1 < len(sched) else None
        main.wait_event(ready)
        slab, ex = stage[i % 2]
        yield s_i, k0, pb, lone, slab[:pb + 2], ex[:pb]
        ev = torch.cuda.Event()
        ev.record(main)
        freed[i % 2] = ev
        ready = nxt


def _check_batch(K: int, plane_batch: int, int4: bool) -> int:
    PB = min(plane_batch, K)
    if K % PB:
        raise ValueError(f"plane_batch={PB} must divide K={K}")
    if int4 and (PB % 2 or K % 2):
        raise ValueError("int4 packs need even K and plane_batch")
    return PB


def _empty_pack(n_seg: int, na: int, nb: int, K: int, C: int, dtype,
                quantized: bool, int4: bool, dev, pin: bool = False):
    blocks = _march.plane_blocks(K, 4 if int4 else None)
    buf = torch.zeros((n_seg, na * nb, blocks * C),
                      dtype=torch.int8 if quantized else dtype, device=dev,
                      pin_memory=pin)
    scl = (torch.ones((n_seg, K + 1, C), dtype=torch.float32, device=dev,
                      pin_memory=pin) if quantized else None)
    return buf, scl


def build_segment_pack_upload(
    domain: ScalarDomain,
    lwl: float = 1064e-9,
    K: int = 256,
    dtype="int4",
    plane_batch: int = 32,
    dither=None,
    extras_dtype=torch.float32,
    verbose: bool = False,
) -> SegmentPack:
    """Stream host-resident volumes up to a SegmentPack on the card.

    For fields whose volumes (ne, Te, Z, B) exceed the card while the
    quantised pack does not: the volumes are copied once into probe-major
    padded pinned host arrays, then every plane batch goes up through two
    staging buffers on a side stream while K9 fills the batch before it in
    place into the final (n_seg, na*nb, blocks*C) table. The pack equals
    ``build_segment_pack_device``'s of the same volumes and dither key bit
    for bit (the same channel and quantiser arithmetic). Volumes already on
    the card are cut batch by batch where they are, with no padded copy.

    ``plane_batch`` must divide K (and be even for int4); ``dither`` as
    ``build_segment_pack_device``. ``extras_dtype``: the floating type the
    JAX package uploads Te, Z and B in (float32 by default, which keeps the
    pack bit-equal to the device build). Another float type (bfloat16
    halves those uploads in JAX, at ~0.4% input error on the kappa and
    Faraday channels) gives JAX's pack: each batch's Te, Z and B are
    rounded to it on the card before the fill. They still go up as
    float32, so the upload's bytes do not fall.
    """
    ex_dt = _device.torch_dtype(extras_dtype)
    if not ex_dt.is_floating_point or ex_dt == torch.float64:
        raise ValueError(
            f"extras_dtype={extras_dtype!r}: the volumes are read as "
            "float32 and may be rounded to a narrower float type only "
            "(ROADMAP C.10)")
    layout = layout_of(domain)
    mode, quantized, int4 = _tier(dtype)
    if dither is not None and not quantized:
        raise ValueError("dither applies to quantised dtypes only")
    PB = _check_batch(K, plane_batch, int4)
    geo = _geometry_of(domain, lwl)
    C = layout.n_channels
    n_seg = -(-(geo.n_p - 1) // K)
    dev = domain.device
    t0 = time.perf_counter()
    sched = _schedule(n_seg, K, PB, int4)
    batches = _volume_batches(domain, geo, sched, K, n_seg * K, dev)
    if verbose:
        print(f"  probe-major copies {time.perf_counter() - t0:.1f}s",
              flush=True)
    buf, scl = _empty_pack(n_seg, geo.na, geo.nb, K, C, dtype, quantized,
                           int4, dev)
    kw = _fill_kw(geo, layout, mode, dither)
    for s_i, k0, pb, lone, slab, ex in batches:
        if ex_dt != torch.float32:
            ex = ex.to(ex_dt).to(torch.float32)
        _fill.fill(buf, scl, slab, ex, g0=s_i * K + k0, seg_i=s_i,
                   col0=_col0(k0, C, int4), k0=k0, pb=pb, lone=lone, **kw)
        if verbose and not lone and pb == PB:
            print(f"  seg {s_i} planes {k0}..{k0 + pb} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return SegmentPack(buf, geo.origin_ab, geo.inv_ab, (geo.na, geo.nb), K,
                       geo.n_p - 1, geo.p0, geo.dp, geo.omega, scl,
                       4 if int4 else None)


def _closure_batches(domain: ScalarDomain, geo: _Geometry, fields, layout,
                     sched, K: int):
    """Yield (s_i, k0, pb, lone, slab, ex) with the batch's ne planes and
    pointwise volumes evaluated from the closures on the domain's device:
    planes below 0 clamp to plane 0 and planes at n_p or beyond are zero
    (the padded plane table of the upload route)."""
    dev = domain.device
    coords = [c.to(dev, torch.float32) for c in (domain.x, domain.y,
                                                 domain.z)]
    ca, cb, cp = coords[geo.a_ax], coords[geo.b_ax], coords[geo.p_ax]
    na, nb, n_p = geo.na, geo.nb, geo.n_p

    def xyz(gs):
        out = [None, None, None]
        out[geo.p_ax] = cp[gs.clamp(0, n_p - 1)][:, None, None]
        out[geo.a_ax] = ca[None, :, None]
        out[geo.b_ax] = cb[None, None, :]
        return out

    def evaluate(fn, gs):
        v = torch.broadcast_to(fn(*xyz(gs)), (gs.shape[0], na, nb)).to(
            torch.float32)
        return torch.where((gs >= n_p)[:, None, None], torch.zeros_like(v),
                           v)

    ex_fns = []
    if layout.inv_brems:
        ex_fns += [fields["Te"], fields["Z"]]
    if layout.B_on:
        for comp in (geo.a_ax, geo.b_ax, geo.p_ax):
            ex_fns.append(lambda x, y, z, _i=comp: fields["B"](x, y, z)[_i])
    for s_i, k0, pb, lone in sched:
        g0 = s_i * K + k0
        slab = evaluate(fields["ne"], torch.arange(g0 - 1, g0 + pb + 1,
                                                   device=dev))
        gbody = torch.arange(g0, g0 + pb, device=dev)
        ex = (torch.stack([evaluate(f, gbody) for f in ex_fns], dim=1)
              if ex_fns else torch.zeros((pb, 0, na, nb), device=dev))
        yield s_i, k0, pb, lone, slab, ex


def build_segment_pack_synth(
    domain: ScalarDomain,
    fields=None,
    lwl: float = 1064e-9,
    K: int = 256,
    dtype="int4",
    plane_batch: int = 32,
    dither=None,
    verbose: bool = False,
) -> SegmentPack:
    """Build a SegmentPack by evaluating the fields' closures on the card,
    plane batch by plane batch, each batch filled in place by K9: no volume
    is materialised, only the pack.

    ``fields``: a dict of torch closures over broadcastable (x, y, z)
    tensors: ``"ne"`` (required), ``"Te"`` / ``"Z"`` (when the domain has
    inv_brems) and ``"B"`` returning an (Bx, By, Bz) tuple (when B_on);
    default ``domain.analytic`` (the ``test_*`` closed forms, or a JAX
    domain's converted by ``convert.closed_form``). The pack holds the
    upload route's numbers for the same closures, to the rounding of
    evaluating them per batch: the JAX package's envelope is < 1% of codes
    differing, never by more than one step.
    """
    layout = layout_of(domain)
    if fields is None:
        fields = domain.analytic
    if not fields or "ne" not in fields:
        raise ValueError(
            "build_segment_pack_synth needs a fields dict with 'ne' "
            "(or a domain with analytic closures)")
    if layout.inv_brems and not ("Te" in fields and "Z" in fields):
        raise RuntimeError("inv_brems requires 'Te' and 'Z' closures")
    if layout.B_on and "B" not in fields:
        raise RuntimeError("B_on requires a 'B' closure")
    mode, quantized, int4 = _tier(dtype)
    if dither is not None and not quantized:
        raise ValueError("dither applies to quantised dtypes only")
    PB = _check_batch(K, plane_batch, int4)
    geo = _geometry_of(domain, lwl)
    C = layout.n_channels
    n_seg = -(-(geo.n_p - 1) // K)
    buf, scl = _empty_pack(n_seg, geo.na, geo.nb, K, C, dtype, quantized,
                           int4, domain.device)
    kw = _fill_kw(geo, layout, mode, dither)
    t0 = time.perf_counter()
    sched = _schedule(n_seg, K, PB, int4)
    for s_i, k0, pb, lone, slab, ex in _closure_batches(
            domain, geo, fields, layout, sched, K):
        _fill.fill(buf, scl, slab, ex, g0=s_i * K + k0, seg_i=s_i,
                   col0=_col0(k0, C, int4), k0=k0, pb=pb, lone=lone, **kw)
        if verbose and not lone:
            print(f"  seg {s_i} planes {k0}..{k0 + pb} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return SegmentPack(buf, geo.origin_ab, geo.inv_ab, (geo.na, geo.nb), K,
                       geo.n_p - 1, geo.p0, geo.dp, geo.omega, scl,
                       4 if int4 else None)


def build_segment_pack_streaming(
    domain: ScalarDomain,
    lwl: float = 1064e-9,
    K: int = 64,
    dtype=torch.bfloat16,
    plane_batch: int = 16,
    device: bool = True,
    verbose: bool = False,
) -> SegmentPack:
    """Build a SegmentPack segment by segment: each segment's table is
    filled on the card by K9 in plane batches (from host-resident or
    device volumes, as ``build_segment_pack_upload``) and, with
    ``device=False``, copied into a pinned host table: a host pack, the
    input of ``solve_zscan_segments_streamed`` for packs larger than the
    card. The card then holds one segment table and a plane batch.

    ``dtype``: f32, bf16 or int8, as in the JAX package. Scales are per
    plane over the whole transverse plane (a segment border plane has one
    scale in both its segments), and the first and last planes take
    one-sided probe-axis differences (JAX zscan.py:1575-1590), quantised
    with their own scales; pad planes of the tail segment are zero with
    scale 1.
    """
    if dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError("build_segment_pack_streaming builds f32, bf16 or "
                         f"int8 packs, not {dtype!r}")
    layout = layout_of(domain)
    mode, quantized, _ = _tier(dtype)
    geo = _geometry_of(domain, lwl)
    C = layout.n_channels
    n_seg = -(-(geo.n_p - 1) // K)
    PB = max(1, min(plane_batch, K))
    dev = domain.device
    t0 = time.perf_counter()
    pin = not device and dev.type == "cuda"
    buf, scl = _empty_pack(n_seg, geo.na, geo.nb, K, C, dtype, quantized,
                           False, dev if device else "cpu", pin)
    # a host pack is filled one segment at a time on the card, then copied
    # down (stream-ordered before the next segment's fills)
    seg, sseg = (_empty_pack(1, geo.na, geo.nb, K, C, dtype, quantized,
                             False, dev) if not device else (buf, scl))
    kw = _fill_kw(geo, layout, mode, None)
    sched = [(s_i, k0, min(PB, K + 1 - k0), False) for s_i in range(n_seg)
             for k0 in range(0, K + 1, PB)]
    for s_i, k0, pb, _, slab, ex in _volume_batches(domain, geo, sched, K,
                                                    n_seg * K, dev):
        _fill.fill(seg, sseg, slab, ex, g0=s_i * K + k0,
                   seg_i=s_i if device else 0, col0=k0 * C, k0=k0, pb=pb,
                   lone=False, **kw)
        if k0 + pb < K + 1:
            continue
        if not device:   # the segment is whole: copy it down
            buf[s_i].copy_(seg[0], non_blocking=pin)
            if quantized:
                scl[s_i].copy_(sseg[0], non_blocking=pin)
        if verbose and s_i % 8 == 0:
            print(f"  segment {s_i}/{n_seg} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if pin:
        torch.cuda.synchronize(dev)
    return SegmentPack(buf, geo.origin_ab, geo.inv_ab, (geo.na, geo.nb), K,
                       geo.n_p - 1, geo.p0, geo.dp, geo.omega, scl, None,
                       host=not device)


# ---------------------------------------------------------------------------
# Pack persistence: the JAX package's .npz layout, both ways
# ---------------------------------------------------------------------------

def save_segment_pack(path: str, spack: SegmentPack) -> None:
    """Write a SegmentPack to ``path`` as the JAX package's .npz (the same
    keys and dtypes; bfloat16 tables as their uint16 bits with
    ``seg_bf16``), so that either package loads the other's file."""
    seg = spack.seg_planes.detach().cpu()
    is_bf16 = seg.dtype == torch.bfloat16
    arrs = {
        "seg_planes": (seg.view(torch.int16).numpy().view(np.uint16)
                       if is_bf16 else seg.numpy()),
        "seg_bf16": np.array(is_bf16),
        "origin_ab": spack.origin_ab.detach().cpu().numpy(),
        "inv_spacing_ab": spack.inv_spacing_ab.detach().cpu().numpy(),
        "meta": np.array([spack.shape_ab[0], spack.shape_ab[1], spack.K,
                          spack.n_slabs, spack.qbits or 0], dtype=np.int64),
        "fmeta": np.array([spack.p0, spack.dp, spack.omega],
                          dtype=np.float64),
    }
    if spack.scales is not None:
        arrs["scales"] = spack.scales.detach().cpu().numpy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)


def load_segment_pack(path: str, device: bool = True,
                      on="cuda") -> SegmentPack:
    """Load a ``save_segment_pack`` file (either package's) onto ``on``;
    ``device=False`` keeps the table in (pinned) host memory: a host
    pack."""
    dev = _device.resolve(on)
    with np.load(path) as z:
        seg = torch.from_numpy(np.array(z["seg_planes"]))
        if "seg_bf16" in z.files and bool(z["seg_bf16"]):
            seg = seg.view(torch.int16).view(torch.bfloat16)
        meta = z["meta"]
        fmeta = z["fmeta"]
        scales = (torch.from_numpy(np.array(z["scales"]))
                  if "scales" in z.files else None)
        origin_ab = torch.from_numpy(np.array(z["origin_ab"])).to(dev)
        inv_ab = torch.from_numpy(np.array(z["inv_spacing_ab"])).to(dev)
    if device:
        seg = seg.to(dev)
        scales = None if scales is None else scales.to(dev)
    elif dev.type == "cuda":
        seg = seg.pin_memory()
    return SegmentPack(seg, origin_ab, inv_ab, (int(meta[0]), int(meta[1])),
                       int(meta[2]), int(meta[3]), float(fmeta[0]),
                       float(fmeta[1]), float(fmeta[2]), scales,
                       int(meta[4]) or None, host=not device)


def cached_build_segment_pack(
    domain: ScalarDomain,
    cache_dir: str,
    lwl: float = 1064e-9,
    K: int = 64,
    dtype=torch.bfloat16,
    plane_stride: int = 1,
    dither=None,
    device: bool = True,
    verbose: bool = False,
    **build_kwargs,
) -> SegmentPack:
    """Build, or load, a SegmentPack keyed by the field's bytes and the
    build's parameters (blake2b, as the JAX package keys it):
    ``cache_dir/segpack-<digest>.npz``."""
    layout = layout_of(domain)
    h = hashlib.blake2b(digest_size=20)
    for vol in (domain.ne, domain.Te, domain.Z, domain.B):
        if vol is not None:
            h.update(vol.detach().cpu().contiguous().numpy().tobytes())
        h.update(b"|")
    for c in (domain.x, domain.y, domain.z):
        h.update(c.detach().cpu().numpy().tobytes())
    dname = (dtype if isinstance(dtype, str)
             else str(dtype).replace("torch.", ""))
    dseed = (None if dither is None else int(dither)
             if isinstance(dither, (int, np.integer))
             else np.asarray(_rand.key_data(dither), np.uint32).tobytes())
    h.update(repr((lwl, K, dname, plane_stride, dseed, layout.inv_brems,
                   layout.phaseshift, layout.B_on,
                   domain.probing_direction)).encode())
    path = os.path.join(cache_dir, f"segpack-{h.hexdigest()}.npz")
    if os.path.exists(path):
        if verbose:
            print(f"segment pack cache HIT {path}", flush=True)
        return load_segment_pack(path, device=device, on=domain.device)
    spack = build_segment_pack_device(
        domain, lwl=lwl, K=K, dtype=dtype, plane_stride=plane_stride,
        dither=dither, **build_kwargs)
    os.makedirs(cache_dir, exist_ok=True)
    save_segment_pack(path, spack)
    if verbose:
        print(f"segment pack cache MISS -> built + saved {path}", flush=True)
    if not device:
        spack = spack._replace(
            seg_planes=spack.seg_planes.cpu(),
            scales=None if spack.scales is None else spack.scales.cpu(),
            host=True)
    return spack


# ---------------------------------------------------------------------------
# pack_dtype="auto": the caustic-ness tier advice
# ---------------------------------------------------------------------------

class PackTierAdvice(UserWarning):
    """Emitted when a pack tier is chosen automatically."""


def suggest_pack_dtype(domain: ScalarDomain, lwl: float = 1064e-9,
                       target_rel_err: float = 0.05) -> dict:
    """Choose a quantised pack tier from a cheap caustic-ness metric (the
    JAX package's, computed the same way in host numpy float64).

    chi = max |d2 Phi / da2| + |d2 Phi / db2| * L_box, with Phi the
    line-integrated ne / (2 nc); the tier is the coarsest whose linear
    error estimate (int4 + dither 0.30 chi, int8 + dither 0.05 chi, bf16
    0.005 chi) is within ``target_rel_err``. Returns {"dtype", "dither"
    (the seed 7 for quantised tiers), "chi", "est_rel_err", "name"}.
    """
    p_ax, a_ax, b_ax, _, _, _ = _geometry(domain)
    xs = [c.detach().cpu().numpy().astype(np.float64)
          for c in (domain.x, domain.y, domain.z)]
    dp = xs[p_ax][1] - xs[p_ax][0]
    nc = float(_c.critical_density(float(_c.omega_from_lwl(lwl))))
    ne = domain.ne.detach().cpu().numpy().astype(np.float64)
    Phi = 0.5 * ne.sum(axis=p_ax) * dp / nc
    da = xs[a_ax][1] - xs[a_ax][0]
    db = xs[b_ax][1] - xs[b_ax][0]
    curv = (np.abs(np.gradient(np.gradient(Phi, da, axis=0), da, axis=0))
            + np.abs(np.gradient(np.gradient(Phi, db, axis=1), db, axis=1)))
    L_box = xs[p_ax][-1] - xs[p_ax][0]
    chi = float(curv.max() * L_box)
    tiers = (("int4", 0.30), ("int8", 0.05), ("bf16", 0.005))
    for name, slope in tiers:
        est = slope * chi
        if est <= target_rel_err:
            break
    quantised = name in ("int4", "int8")
    return {"dtype": PACK_DTYPES[name], "dither": 7 if quantised else None,
            "chi": round(chi, 4), "est_rel_err": round(est, 4),
            "name": name}
