"""K4: the plain slab march (RK4 across the planes of a ``ZScanPack``).

``march`` launches the CUDA kernel of ``csrc/slab_march.cu`` on CUDA tensors
and runs ``march_plain`` on CPU tensors. The plain version is the JAX
package's ``trace_zscan`` (``synthpy_tpu/tracer/zscan.py:209-240``): per
slab it blends whole planes (``0.5 * (w0 + w1)`` in the plane dtype for one
substep, ``w0 + (j / substeps) * dw`` promoted to float32 for more) and
evaluates ``deriv`` (``_deriv`` :159) on ``bilinear`` (``_bilinear``
:135). The kernel blends only the corners it reads, the same values
elementwise. On CUDA tensors the wrapper hands the rays over in entry-cell
order (``kernels.march.ray_order``); ``launch`` runs a given build of the
kernel in a given order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel
from synthpy_tpu_torch.kernels.march import ray_order

KERNEL = Kernel("slab_march.cu", {
    "slab_march": [P, P, P, P, L, I, I, I, I, I, F, F, F, F, F, F, F, F, I,
                   I, I, P],
}, flags=["--fmad=false"])

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _f32(v) -> float:
    return float(np.float32(float(v)))


def bilinear(plane: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor,
             origin_ab: Sequence[float], inv_ab: Sequence[float]
             ) -> torch.Tensor:
    """4-corner gather of all channels of one (na, nb, C) plane at (N,)
    transverse positions, in the positions' dtype; 0 outside."""
    na, nb, Cc = plane.shape
    ta = (pa - origin_ab[0]) * inv_ab[0]
    tb = (pb - origin_ab[1]) * inv_ab[1]
    inside = (ta >= 0) & (ta <= na - 1) & (tb >= 0) & (tb <= nb - 1)
    ia = torch.floor(ta).nan_to_num(0.0).clamp(0, na - 2)
    ib = torch.floor(tb).nan_to_num(0.0).clamp(0, nb - 2)
    fa = torch.clamp(ta - ia, 0.0, 1.0)[:, None]
    fb = torch.clamp(tb - ib, 0.0, 1.0)[:, None]
    flat = plane.reshape(na * nb, Cc)
    base = ia.to(torch.int64) * nb + ib.to(torch.int64)

    def corner(off):
        return flat[base + off].to(pa.dtype)

    out = ((1 - fa) * (1 - fb) * corner(0)
           + (1 - fa) * fb * corner(1)
           + fa * (1 - fb) * corner(nb)
           + fa * fb * corner(nb + 1))
    return torch.where(inside[:, None], out, torch.zeros_like(out))


def deriv(u: torch.Tensor, plane: torch.Tensor, origin_ab, inv_ab,
          layout: ChannelLayout, atten_sign: float) -> torch.Tensor:
    """du/dp of permuted (N, 8) states u = (a, b, va, vb, vp, amp, phase,
    pol) on one stage plane."""
    vals = bilinear(plane, u[:, 0], u[:, 1], origin_ab, inv_ab)
    va, vb, vp = u[:, 2:3], u[:, 3:4], u[:, 4:5]
    inv_vp = 1.0 / vp
    zeros = torch.zeros_like(vp)
    d_amp = (atten_sign * vals[:, layout.kappa_index:layout.kappa_index + 1]
             * u[:, 5:6] * inv_vp if layout.inv_brems else zeros)
    d_phase = (vals[:, layout.phase_index:layout.phase_index + 1] * inv_vp
               if layout.phaseshift else zeros)
    if layout.B_on:
        fi = layout.faraday_index
        d_pol = (vals[:, fi:fi + 1] * va + vals[:, fi + 1:fi + 2] * vb
                 + vals[:, fi + 2:fi + 3] * vp) * inv_vp
    else:
        d_pol = zeros
    return torch.cat([va * inv_vp, vb * inv_vp, vals[:, 0:3] * inv_vp,
                      d_amp, d_phase, d_pol], dim=1)


def _steps(dp, substeps: int):
    """h = dp / substeps, 0.5*h and h/6 in float32 (the JAX step's)."""
    h = np.float32(np.float32(float(dp)) / np.float32(substeps))
    return float(h), float(np.float32(0.5) * h), float(h / np.float32(6.0))


def march_plain(u: torch.Tensor, planes: torch.Tensor, origin_ab, inv_ab,
                dp, *, layout: ChannelLayout, n_slabs: int,
                substeps: int = 1, atten_sign: float = -1.0) -> torch.Tensor:
    """Plain version of the march: (N, 8) permuted states in and out."""
    oab = [_f32(v) for v in origin_ab]
    iab = [_f32(v) for v in inv_ab]
    h, hh, h6 = _steps(dp, substeps)

    def d(uu, pl):
        return deriv(uu, pl, oab, iab, layout, atten_sign)

    def step(uc, p0, ph, p1):
        k1 = d(uc, p0)
        k2 = d(uc + hh * k1, ph)
        k3 = d(uc + hh * k2, ph)
        k4 = d(uc + h * k3, p1)
        return uc + h6 * (k1 + 2 * k2 + 2 * k3 + k4)

    for k in range(n_slabs):
        w0, w1 = planes[k], planes[k + 1]
        if substeps == 1:
            u = step(u, w0, 0.5 * (w0 + w1), w1)
            continue
        dw = (w1 - w0).to(torch.float32)
        w0f = w0.to(torch.float32)
        for j in range(substeps):
            fj = np.float32(j)
            S = np.float32(substeps)
            u = step(u, w0f + float(fj / S) * dw,
                     w0f + float((fj + np.float32(0.5)) / S) * dw,
                     w0f + float((fj + np.float32(1.0)) / S) * dw)
    return u


def check(u: torch.Tensor, planes: torch.Tensor, layout: ChannelLayout,
          n_slabs: int) -> None:
    """Raise unless the states and planes are what K4 takes."""
    if (u.dtype != torch.float32 or u.dim() != 2 or u.shape[1] != 8
            or not u.is_contiguous()):
        raise ValueError("u must be a contiguous (N, 8) float32 tensor")
    if (planes.device != u.device or planes.dtype not in _DTYPE_CODE
            or planes.dim() != 4 or not planes.is_contiguous()
            or planes.shape[-1] != layout.n_channels):
        raise ValueError(
            "planes must be a contiguous (n_p, na, nb, C) float32 or "
            f"bfloat16 tensor with C = {layout.n_channels} on the rays' "
            "device")
    if planes.shape[0] < n_slabs + 1:
        raise ValueError(f"{planes.shape[0]} planes for {n_slabs} slabs")


def march(u: torch.Tensor, planes: torch.Tensor, origin_ab, inv_ab, dp, *,
          layout: ChannelLayout, n_slabs: int, substeps: int = 1,
          atten_sign: float = -1.0) -> torch.Tensor:
    """March (N, 8) permuted rays across ``n_slabs`` plane intervals. On
    CUDA tensors the kernel marches the rays in entry-cell order; the
    result does not depend on the order."""
    if substeps < 1:
        raise ValueError(f"substeps must be >= 1, got {substeps}")
    oab = [_f32(v) for v in origin_ab]
    iab = [_f32(v) for v in inv_ab]
    if u.device.type == "cpu":
        return march_plain(u, planes, oab, iab, dp, layout=layout,
                           n_slabs=n_slabs, substeps=substeps,
                           atten_sign=atten_sign)
    check(u, planes, layout, n_slabs)
    # the kernel reads states as 16-byte vectors: a fresh allocation is
    # aligned
    if u.data_ptr() % 16:
        u = u.clone()
    order = ray_order(u, tuple(planes.shape[1:3]), oab, iab)
    return launch(KERNEL, u, planes, oab, iab, dp, order, layout=layout,
                  n_slabs=n_slabs, substeps=substeps, atten_sign=atten_sign)


def launch(kernel: Kernel, u: torch.Tensor, planes: torch.Tensor, origin_ab,
           inv_ab, dp, order: torch.Tensor, *, layout: ChannelLayout,
           n_slabs: int, substeps: int = 1,
           atten_sign: float = -1.0) -> torch.Tensor:
    """Launch ``kernel`` (a build of ``csrc/slab_march.cu``) on checked
    inputs, marching ray ``order[i]`` i-th."""
    out = torch.empty_like(u)
    h, hh, h6 = _steps(dp, substeps)
    kernel.launch(
        "slab_march", u.device, u.data_ptr(), out.data_ptr(),
        order.data_ptr(), planes.data_ptr(), u.shape[0],
        _DTYPE_CODE[planes.dtype], int(n_slabs), int(substeps),
        planes.shape[1], planes.shape[2], _f32(origin_ab[0]),
        _f32(origin_ab[1]), _f32(inv_ab[0]), _f32(inv_ab[1]), h, hh, h6,
        float(atten_sign), int(layout.inv_brems), int(layout.phaseshift),
        int(layout.B_on))
    return out
