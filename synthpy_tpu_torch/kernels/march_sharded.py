"""K17: one segment of the grid-sharded segment march, on one shard.

``march_owned`` launches the CUDA kernel of ``csrc/march_sharded.cu`` on
CUDA tensors and runs ``march_owned_plain`` on CPU tensors. A shard holds
a-rows [lo, lo + naloc) of one segment's corner table and the first a-row
of its right neighbour (the halo); a ray is the shard's when its frozen
corner cell ia0 = clip(floor(ta), 0, na - 2) lies in its rows (the JAX
package's ``parallel/mesh.py:292-297``). Owned rays are marched as K1
marches them on the whole table (``march_segment(a_offset=lo)``), bit for
bit; the others get zeros, which the psum over the grid axis then fills
with their owner's result (``parallel.mesh.make_gridsharded_segment_tracer``).

The plain version marches the owned rays with ``march.march_plain`` on the
shard's rows and the halo, offset by ``lo``. On CUDA tensors the wrapper
hands the rays over in ``order`` (default: ``march.ray_order``, entry-cell
order, which keeps a shard's rays together); the result does not depend on
the order.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel, refuse_grad
from synthpy_tpu_torch.kernels.march import (_DTYPE_CODE, INTEGRATORS,
                                             march_plain, plane_blocks,
                                             ray_order)

KERNEL = Kernel("march_sharded.cu", {
    "march_owned": [P, P, P, P, P, P, L, I, I, I, I, I, I, I, I, I,
                    F, F, F, F, F, I, I, I, F, P],
}, flags=["--fmad=false"])


def owned(u: torch.Tensor, lo: int, naloc: int, na: int, origin_a: float,
          inv_a: float) -> torch.Tensor:
    """(N,) bool: the rays whose frozen corner a-row lies in [lo, lo +
    naloc), as the kernels compute it (a NaN coordinate gives row 0)."""
    ta = (u[:, 0] - origin_a) * inv_a
    ia0 = torch.floor(ta).nan_to_num(0.0).clamp(0, na - 2)
    return (ia0 >= lo) & (ia0 < lo + naloc)


def march_owned_plain(u: torch.Tensor, table: torch.Tensor,
                      halo: Optional[torch.Tensor],
                      scales: Optional[torch.Tensor], *, lo: int,
                      naloc: int, shape_ab: Tuple[int, int],
                      origin_ab: Sequence[float], inv_ab: Sequence[float],
                      dp: float, layout: ChannelLayout, K: int,
                      integrator: str = "rk4", weights: str = "stage",
                      qbits: Optional[int] = None,
                      atten_sign: float = -1.0) -> torch.Tensor:
    """Plain version of ``march_owned``: (N, 8) in, the owned rays marched
    and the rest zeros."""
    nb = shape_ab[1]
    row = table.shape[-1]
    rows = [table.reshape(naloc * nb, row)]
    if halo is not None:
        rows.append(halo.reshape(nb, row))
    local = torch.cat(rows)[None]
    mask = owned(u, lo, naloc, shape_ab[0], float(origin_ab[0]),
                 float(inv_ab[0]))
    out = torch.zeros_like(u)
    out[mask] = march_plain(
        u[mask], local, None if scales is None else scales[None],
        shape_ab=shape_ab, origin_ab=origin_ab, inv_ab=inv_ab, dp=dp,
        layout=layout, K=K, integrator=integrator, weights=weights,
        qbits=qbits, atten_sign=atten_sign, a_offset=lo)
    return out


def march_owned(u: torch.Tensor, table: torch.Tensor,
                halo: Optional[torch.Tensor],
                scales: Optional[torch.Tensor], *, lo: int, naloc: int,
                shape_ab: Tuple[int, int], origin_ab: Sequence[float],
                inv_ab: Sequence[float], dp: float, layout: ChannelLayout,
                K: int, integrator: str = "rk4", weights: str = "stage",
                qbits: Optional[int] = None, atten_sign: float = -1.0,
                order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """March the shard's rays of (N, 8) permuted states through one
    segment; the other rays get zeros.

    ``table``: the segment's (naloc, nb, row) or (naloc*nb, row) rows of
    a-rows [lo, lo + naloc), f32, bf16, int8 or int4 nibble pairs
    (``qbits=4``); ``halo``: the (nb, row) rows of a-row lo + naloc, needed
    unless no owned cell reaches it; ``scales``: the segment's (K+1, C) f32
    for the quantised tables, else None. ``order``: the launch order (on
    CUDA tensors; default ``ray_order`` of ``u``)."""
    kw = dict(lo=lo, naloc=naloc, shape_ab=shape_ab, origin_ab=origin_ab,
              inv_ab=inv_ab, dp=dp, layout=layout, K=K,
              integrator=integrator, weights=weights, qbits=qbits,
              atten_sign=atten_sign)
    if u.device.type == "cpu":
        return march_owned_plain(u, table, halo, scales, **kw)
    refuse_grad("march_sharded.march_owned (K17)", u, table, halo)
    dev = u.device
    if (u.dtype != torch.float32 or u.dim() != 2 or u.shape[1] != 8
            or not u.is_contiguous()):
        raise ValueError("u must be a contiguous (N, 8) float32 tensor")
    na, nb = shape_ab
    C = layout.n_channels
    row = plane_blocks(K, qbits) * C
    for name, t, n in (("table", table, naloc * nb), ("halo", halo, nb)):
        if t is None:
            continue
        if (t.device != dev or t.dtype not in _DTYPE_CODE
                or not t.is_contiguous() or t.numel() != n * row
                or t.shape[-1] != row or t.dtype != table.dtype):
            raise ValueError(f"{name} must be {n} contiguous rows of {row} "
                             f"f32/bf16/int8 values on the rays' device")
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")
    if not 0 <= lo < na or naloc < 1:
        raise ValueError(f"shard rows [{lo}, {lo + naloc}) outside na={na}")
    quantized = table.dtype == torch.int8
    if quantized != (scales is not None):
        raise ValueError("int8/int4 tables need scales; float tables none")
    if qbits == 4 and not quantized:
        raise ValueError("int4 nibble packs are int8 byte tables")
    if quantized and (scales.device != dev or scales.dtype != torch.float32
                      or tuple(scales.shape) != (K + 1, C)
                      or not scales.is_contiguous()):
        raise ValueError("scales must be a contiguous (K+1, C) f32 tensor "
                         "on the rays' device")
    if u.data_ptr() % 16:
        u = u.clone()
    if order is None:
        order = ray_order(u, shape_ab, origin_ab, inv_ab)
    return launch(KERNEL, u, table, halo, scales, order, **kw)


def launch(kernel: Kernel, u: torch.Tensor, table: torch.Tensor,
           halo: Optional[torch.Tensor], scales: Optional[torch.Tensor],
           order: torch.Tensor, *, lo: int, naloc: int,
           shape_ab: Tuple[int, int], origin_ab: Sequence[float],
           inv_ab: Sequence[float], dp: float, layout: ChannelLayout,
           K: int, integrator: str = "rk4", weights: str = "stage",
           qbits: Optional[int] = None,
           atten_sign: float = -1.0) -> torch.Tensor:
    """Launch ``kernel`` (a build of ``csrc/march_sharded.cu``) on checked
    inputs, marching ray ``order[i]`` i-th."""
    out = torch.empty_like(u)
    na, nb = shape_ab
    kernel.launch(
        "march_owned", u.device, u.data_ptr(), out.data_ptr(),
        order.data_ptr(), table.data_ptr(),
        None if halo is None else halo.data_ptr(),
        None if scales is None else scales.data_ptr(), u.shape[0], int(lo),
        int(naloc), table.shape[-1], K,
        3 if qbits == 4 else _DTYPE_CODE[table.dtype],
        INTEGRATORS.index(integrator), int(weights == "slab"), na, nb,
        float(origin_ab[0]), float(origin_ab[1]), float(inv_ab[0]),
        float(inv_ab[1]), float(dp), int(layout.inv_brems),
        int(layout.phaseshift), int(layout.B_on), float(atten_sign))
    return out
