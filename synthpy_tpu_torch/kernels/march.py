"""K1: the segment march.

``march`` launches the CUDA kernel of ``csrc/march.cu`` on CUDA tensors and
runs ``march_plain``, its plain PyTorch version, on CPU tensors. The plain
version repeats the JAX package's arithmetic (``synthpy_tpu/tracer/zscan.py``
march_segment :756 over trace_zscan_segments :1102) in the state's dtype
(float32 or float64), vectorised over rays, with Python loops over segments
and slabs; it gathers only the 2-plane window of each corner row a slab
needs.

On CUDA tensors the wrapper first orders the rays by entry cell
(``ray_order``, a stable argsort of ``entry_cells``), so that each block of
the kernel marches rays that share corner rows; the kernel writes every
ray back to its own row, and the plain version ignores the order.
``launch`` runs a given build of the kernel in a given order, without the
checks of ``march``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel
from synthpy_tpu_torch.kernels.pack import nibble_hi, nibble_lo

KERNEL = Kernel("march.cu", {
    "march_segments": [P, P, P, P, P, L, I, I, I, I, I, I, I, I, I,
                       F, F, F, F, F, I, I, I, F, P],
}, flags=["--fmad=false"])

INTEGRATORS = ("rk4", "rk2", "rk2s2", "rk2s4")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def plane_blocks(K: int, qbits: Optional[int]) -> int:
    """Byte blocks per (K+1)-plane corner row: nibble packs pair planes."""
    return K // 2 + 1 if qbits == 4 else K + 1


def entry_cells(u: torch.Tensor, shape: Sequence[int],
                origin: Sequence[float],
                inv_spacing: Sequence[float]) -> torch.Tensor:
    """(N,) flat cell of each ray's first ``len(shape)`` columns, row-major
    over ``shape``, each index clip(floor(t), 0, n - 2) of t = (x - origin)
    * inv_spacing (a NaN coordinate gives 0, as in the kernels). For K1's
    (a, b) it is the JAX march's frozen corner cell ia0 * nb + ib0
    (zscan.py:850-853); K4 takes the same (a, b) key, K5 and K6 the 3-D
    cell (ix * ny + iy) * nz + iz. int32, or int64 for a grid of 2^31
    cells or more."""
    wide = int(np.prod(shape, dtype=np.int64)) >= 2**31
    flat = None
    for col, n in enumerate(shape):
        t = torch.floor((u[:, col] - float(np.float32(origin[col])))
                        * float(np.float32(inv_spacing[col])))
        i = t.nan_to_num(0.0).clamp(0, n - 2).to(
            torch.int64 if wide else torch.int32)
        flat = i if flat is None else flat * n + i
    return flat


def ray_order(u: torch.Tensor, shape: Sequence[int], origin: Sequence[float],
              inv_spacing: Sequence[float]) -> torch.Tensor:
    """(N,) int64 stable permutation of the rays by entry cell: the order
    in which a kernel marches them, so that a block's rays share corner
    rows."""
    return torch.argsort(entry_cells(u, shape, origin, inv_spacing),
                         stable=True)


def march_plain(u: torch.Tensor, seg_planes: torch.Tensor,
                seg_scales: Optional[torch.Tensor], *,
                shape_ab: Tuple[int, int], origin_ab: Sequence[float],
                inv_ab: Sequence[float], dp: float, layout: ChannelLayout,
                K: int, integrator: str = "rk4", weights: str = "stage",
                qbits: Optional[int] = None, atten_sign: float = -1.0,
                a_offset: int = 0) -> torch.Tensor:
    """Plain version of the march: (N, 8) permuted states in and out.
    ``a_offset``: the first a-row the table holds (a shard's rows, as in
    the JAX package's ``march_segment(a_offset=)``); the rays' corner
    cells must lie in it."""
    na, nb = shape_ab
    n_seg, cells, row = seg_planes.shape
    C = row // plane_blocks(K, qbits)
    dt = u.dtype

    def rnd(v: float) -> float:
        # a scalar as the state's dtype holds it (JAX's weak typing)
        return float(np.float32(v)) if dt == torch.float32 else float(v)

    oa, ob = (rnd(v) for v in origin_ab)
    ia_, ib_ = (rnd(v) for v in inv_ab)
    h = rnd(dp)
    flat = seg_planes.reshape(-1)
    ch = torch.arange(C, device=u.device)
    cols = tuple(u[:, i] for i in range(8))

    def rhs(cc, vals):
        a, b, va, vb, vp, amp, ph, pol = cc
        inv_vp = 1.0 / vp
        zeros = torch.zeros_like(a)
        d_amp = (atten_sign * vals[:, layout.kappa_index] * amp * inv_vp
                 if layout.inv_brems else zeros)
        d_phase = (vals[:, layout.phase_index] * inv_vp
                   if layout.phaseshift else zeros)
        if layout.B_on:
            fi = layout.faraday_index
            d_pol = (vals[:, fi] * va + vals[:, fi + 1] * vb
                     + vals[:, fi + 2] * vp) * inv_vp
        else:
            d_pol = zeros
        return (va * inv_vp, vb * inv_vp, vals[:, 0] * inv_vp,
                vals[:, 1] * inv_vp, vals[:, 2] * inv_vp, d_amp, d_phase,
                d_pol)

    zero, one = (torch.tensor(v, dtype=dt, device=u.device)
                 for v in (0.0, 1.0))

    def clip01(r):
        # jnp.clip's min(max(r, 0), 1): the same values as torch.clamp,
        # and under autograd the same derivative as jax.grad, 1/2 at a tie
        return torch.minimum(torch.maximum(r, zero), one)

    def fractions(cc, ia0f, ib0f):
        ta = (cc[0] - oa) * ia_
        tb = (cc[1] - ob) * ib_
        inside = (ta >= 0) & (ta <= na - 1) & (tb >= 0) & (tb <= nb - 1)
        return clip01(ta - ia0f), clip01(tb - ib0f), inside

    def blend(w4, wv):
        w00, w01, w10, w11 = (w[:, None] for w in w4)
        return w00 * wv[0] + w01 * wv[1] + w10 * wv[2] + w11 * wv[3]

    def axpy(cc, kk, c):
        return tuple(x + c * kv for x, kv in zip(cc, kk))

    for s in range(n_seg):
        ta = (cols[0] - oa) * ia_
        tb = (cols[1] - ob) * ib_
        ia0f = torch.clamp(torch.floor(ta), 0, na - 2)
        ib0f = torch.clamp(torch.floor(tb), 0, nb - 2)
        base = s * cells + ((ia0f - a_offset) * nb + ib0f).to(torch.int64)
        rows = [(base + off) * row for off in (0, 1, nb, nb + 1)]
        sc = None if seg_scales is None else seg_scales[s].to(dt)

        def plane(k):
            # the 4 corners' (N, C) values of plane k, dequantised
            out = []
            for r in rows:
                if qbits == 4:
                    w = flat[r[:, None] + (k // 2) * C + ch]
                    v = (nibble_hi(w) if k % 2 else nibble_lo(w)).to(dt)
                else:
                    v = flat[r[:, None] + k * C + ch].to(dt)
                out.append(v if sc is None else v * sc[k])
            return out

        def stage_fn(w4):
            if weights == "slab":
                def stage(cc, wv):
                    return rhs(cc, blend(w4, wv))
            else:
                def stage(cc, wv):
                    fa, fb, inside = fractions(cc, ia0f, ib0f)
                    vals = blend(((1 - fa) * (1 - fb), (1 - fa) * fb,
                                  fa * (1 - fb), fa * fb), wv)
                    return rhs(cc, torch.where(inside[:, None], vals,
                                               torch.zeros_like(vals)))
            return stage

        def slab_weights(cc):
            if weights != "slab":
                return None
            fa, fb, inside = fractions(cc, ia0f, ib0f)
            m = inside.to(dt)
            return (m * (1 - fa) * (1 - fb), m * (1 - fa) * fb,
                    m * fa * (1 - fb), m * fa * fb)

        def slab(cc, k, rk4):
            w0, w1 = plane(k), plane(k + 1)
            wm = [0.5 * (x + y) for x, y in zip(w0, w1)]
            stage = stage_fn(slab_weights(cc))
            k1 = stage(cc, w0)
            k2 = stage(axpy(cc, k1, 0.5 * h), wm)
            if not rk4:
                return axpy(cc, k2, h)
            k3 = stage(axpy(cc, k2, 0.5 * h), wm)
            k4 = stage(axpy(cc, k3, h), w1)
            return tuple(x + rnd(h / 6.0) * (a + 2 * b2 + 2 * c2 + d2)
                         for x, a, b2, c2, d2 in zip(cc, k1, k2, k3, k4))

        def midpoint(cc, k0, km, half, full):
            w0, wm = plane(k0), plane(km)
            stage = stage_fn(slab_weights(cc))
            k1 = stage(cc, w0)
            k2 = stage(axpy(cc, k1, half), wm)
            return axpy(cc, k2, full)

        if integrator == "rk2s4":
            for j in range(K // 4):
                cols = midpoint(cols, 4 * j, 4 * j + 2, 2.0 * h, 4.0 * h)
            for k in range(K - K % 4, K):
                cols = slab(cols, k, False)
        elif integrator == "rk2s2":
            for j in range(K // 2):
                cols = midpoint(cols, 2 * j, 2 * j + 1, h, 2.0 * h)
            if K % 2:
                cols = slab(cols, K - 1, False)
        else:
            for k in range(K):
                cols = slab(cols, k, integrator == "rk4")
    return torch.stack(cols, dim=1)


def march(u: torch.Tensor, seg_planes: torch.Tensor,
          seg_scales: Optional[torch.Tensor], *,
          shape_ab: Tuple[int, int], origin_ab: Sequence[float],
          inv_ab: Sequence[float], dp: float, layout: ChannelLayout, K: int,
          integrator: str = "rk4", weights: str = "stage",
          qbits: Optional[int] = None,
          atten_sign: float = -1.0) -> torch.Tensor:
    """March (N, 8) permuted rays through every segment of a table.

    ``seg_planes``: (n_seg, na*nb, blocks*C) f32, bf16 or int8 values, or
    int4 nibble pairs (``qbits=4``); ``seg_scales``: (n_seg, K+1, C) f32
    for the quantised tables, else None. On CUDA tensors the kernel marches
    the rays in ``ray_order`` and writes each back to its own row; the
    result does not depend on the order.
    """
    kw = dict(shape_ab=shape_ab, origin_ab=origin_ab, inv_ab=inv_ab, dp=dp,
              layout=layout, K=K, integrator=integrator, weights=weights,
              qbits=qbits, atten_sign=atten_sign)
    if u.device.type == "cpu":
        return march_plain(u, seg_planes, seg_scales, **kw)
    dev = u.device
    if (u.dtype != torch.float32 or u.dim() != 2 or u.shape[1] != 8
            or not u.is_contiguous()):
        raise ValueError("u must be a contiguous (N, 8) float32 tensor")
    if (seg_planes.device != dev or seg_planes.dtype not in _DTYPE_CODE
            or seg_planes.dim() != 3 or not seg_planes.is_contiguous()):
        raise ValueError("seg_planes must be a contiguous (n_seg, cells, "
                         "row) f32/bf16/int8 tensor on the rays' device")
    n_seg, cells, row = seg_planes.shape
    na, nb = shape_ab
    C = layout.n_channels
    if cells != na * nb or row != plane_blocks(K, qbits) * C:
        raise ValueError(f"table shape {tuple(seg_planes.shape)} does not "
                         f"match shape_ab={shape_ab}, K={K}, C={C}")
    quantized = seg_planes.dtype == torch.int8
    if quantized != (seg_scales is not None):
        raise ValueError("int8/int4 tables need scales; float tables none")
    if qbits == 4 and not quantized:
        raise ValueError("int4 nibble packs are int8 byte tables")
    if quantized and (seg_scales.device != dev
                      or seg_scales.dtype != torch.float32
                      or tuple(seg_scales.shape) != (n_seg, K + 1, C)
                      or not seg_scales.is_contiguous()):
        raise ValueError("scales must be a contiguous (n_seg, K+1, C) f32 "
                         "tensor on the rays' device")
    # the kernel reads states as 16-byte vectors: a fresh allocation is
    # aligned
    if u.data_ptr() % 16:
        u = u.clone()
    return launch(KERNEL, u, seg_planes, seg_scales,
                  ray_order(u, shape_ab, origin_ab, inv_ab), **kw)


def launch(kernel: Kernel, u: torch.Tensor, seg_planes: torch.Tensor,
           seg_scales: Optional[torch.Tensor], order: torch.Tensor, *,
           shape_ab: Tuple[int, int], origin_ab: Sequence[float],
           inv_ab: Sequence[float], dp: float, layout: ChannelLayout, K: int,
           integrator: str = "rk4", weights: str = "stage",
           qbits: Optional[int] = None,
           atten_sign: float = -1.0) -> torch.Tensor:
    """Launch ``kernel`` (a build of ``csrc/march.cu``) on inputs that
    ``march`` has checked, marching ray ``order[i]`` i-th."""
    out = torch.empty_like(u)
    n_seg, cells, row = seg_planes.shape
    na, nb = shape_ab
    kernel.launch(
        "march_segments", u.device, u.data_ptr(), out.data_ptr(),
        order.data_ptr(), seg_planes.data_ptr(),
        None if seg_scales is None else seg_scales.data_ptr(), u.shape[0],
        n_seg, cells, row, K,
        3 if qbits == 4 else _DTYPE_CODE[seg_planes.dtype],
        INTEGRATORS.index(integrator), int(weights == "slab"), na, nb,
        float(origin_ab[0]), float(origin_ab[1]), float(inv_ab[0]),
        float(inv_ab[1]), float(dp), int(layout.inv_brems),
        int(layout.phaseshift), int(layout.B_on), float(atten_sign))
    return out
