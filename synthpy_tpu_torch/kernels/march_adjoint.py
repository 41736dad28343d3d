"""K11: the adjoint of one segment of the segment march K1.

``march_adjoint`` takes one segment's start states ``u`` (N, 8), the
cotangent ``du`` of its end states and its (cells, (K+1) C) table, and
returns the cotangent of ``u``; the table's cotangent is added into a
float32 buffer of the table's shape when one is given. On CUDA tensors it
launches ``csrc/march_adjoint.cu`` on the rays in ``march.ray_order``; on
CPU tensors it runs ``march_vjp_plain``, ``torch.autograd.grad`` through
``march.march_plain`` of that one segment. It covers what the
differentiable renderer runs: rk4, ``weights="stage"``, one substep, float32
or bf16 tables (``covers``). The table's cotangent is summed in float32
for either table.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels import march as _march
from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel

KERNEL = Kernel("march_adjoint.cu", {
    "march_adjoint": [P, P, P, P, P, P, P, L, I, I, I, I, I, F, F, F, F, F,
                      I, I, I, F, P],
}, flags=["--fmad=false"])

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def covers(integrator: str, weights: str, dtype, qbits=None) -> bool:
    """Whether the adjoint covers a march configuration (a float64 table
    only in the plain version, on the CPU: the kernels are float32)."""
    return (integrator == "rk4" and weights == "stage" and qbits is None
            and dtype in (torch.float32, torch.bfloat16, torch.float64))


def grad_dtype(dtype):
    """The type a table's cotangent is summed in: float32, or float64 for
    a float64 table."""
    return torch.promote_types(dtype, torch.float32)


def march_vjp_plain(u: torch.Tensor, seg: torch.Tensor, du: torch.Tensor, *,
                    shape_ab: Tuple[int, int], origin_ab: Sequence[float],
                    inv_ab: Sequence[float], dp: float, layout: ChannelLayout,
                    K: int, atten_sign: float = -1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the adjoint: (du_in, dseg), the cotangents of the
    start states and of the table's values, in float32 for a float32 or
    bf16 table (float64 for float64), by ``torch.autograd.grad`` through
    ``march_plain`` of this segment."""
    with torch.enable_grad():
        u_ = u.detach().requires_grad_()
        t_ = seg.detach().to(grad_dtype(seg.dtype)).requires_grad_()
        out = _march.march_plain(
            u_, t_[None], None, shape_ab=shape_ab, origin_ab=origin_ab,
            inv_ab=inv_ab, dp=dp, layout=layout, K=K, integrator="rk4",
            weights="stage", atten_sign=atten_sign)
        return torch.autograd.grad(out, (u_, t_), du)


def march_adjoint(u: torch.Tensor, seg: torch.Tensor, du: torch.Tensor, *,
                  shape_ab: Tuple[int, int], origin_ab: Sequence[float],
                  inv_ab: Sequence[float], dp: float, layout: ChannelLayout,
                  K: int, dseg: Optional[torch.Tensor] = None,
                  atten_sign: float = -1.0) -> torch.Tensor:
    """The cotangent of one segment's (N, 8) start states ``u`` for the
    cotangent ``du`` of its end states, through the (cells, (K+1) C) table
    ``seg``; the table's cotangent is added into ``dseg`` (the table's
    shape, in ``grad_dtype``) when it is given."""
    kw = dict(shape_ab=shape_ab, origin_ab=origin_ab, inv_ab=inv_ab, dp=dp,
              layout=layout, K=K, atten_sign=atten_sign)
    if u.device.type == "cpu":
        du_in, dt = march_vjp_plain(u, seg, du, **kw)
        if dseg is not None:
            dseg += dt
        return du_in
    dev = u.device
    N = u.shape[0]
    na, nb = shape_ab
    C = layout.n_channels
    for name, t in (("u", u), ("du", du)):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (N, 8)):
            raise ValueError(f"{name} must be an (N, 8) float32 tensor on "
                             "the rays' device")
    if (seg.device != dev or seg.dtype not in _DTYPE_CODE
            or tuple(seg.shape) != (na * nb, (K + 1) * C)
            or not seg.is_contiguous()):
        raise ValueError(f"seg must be a contiguous ({na * nb}, "
                         f"{(K + 1) * C}) float32 or bf16 table on the rays' "
                         "device")
    if dseg is not None and (dseg.device != dev
                             or dseg.dtype != torch.float32
                             or dseg.shape != seg.shape
                             or not dseg.is_contiguous()):
        raise ValueError("dseg must be a contiguous float32 tensor of the "
                         "table's shape on the rays' device")
    # states are read and written as 16-byte vectors
    u, du = (t.contiguous() for t in (u, du))
    u, du = (t.clone() if t.data_ptr() % 16 else t for t in (u, du))
    order = _march.ray_order(u, shape_ab, origin_ab, inv_ab)
    du_in = torch.empty_like(u)
    scratch = torch.empty((K, N, 8), dtype=torch.float32, device=dev)
    KERNEL.launch(
        "march_adjoint", dev, u.data_ptr(), du.data_ptr(), du_in.data_ptr(),
        order.data_ptr(), seg.data_ptr(),
        None if dseg is None else dseg.data_ptr(), scratch.data_ptr(), N,
        (K + 1) * C, K, _DTYPE_CODE[seg.dtype], na, nb, float(origin_ab[0]),
        float(origin_ab[1]), float(inv_ab[0]), float(inv_ab[1]), float(dp),
        int(layout.inv_brems), int(layout.phaseshift), int(layout.B_on),
        float(atten_sign))
    return du_in
