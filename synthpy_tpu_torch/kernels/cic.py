"""K12: the cloud-in-cell detector image of the differentiable renderer, and
its adjoint.

``cic`` deposits (N, V) values of rays at (N,) positions ``x``, ``y`` [mm]
onto the (nx, ny) pixel centres of a detector spanning [-Lx/2, Lx/2] x
[-Ly/2, Ly/2], returning the (nx, ny, V) float32 sums, and is
differentiable in ``x``, ``y`` and the values: a ``torch.autograd.Function``
whose forward launches ``cic_deposit`` and whose backward launches
``cic_adjoint`` of ``csrc/cic.cu`` on CUDA tensors, and which runs the plain
versions ``cic_plain`` and ``cic_vjp_plain`` on CPU tensors. The rule is
``synthpy_tpu/inverse.py`` ``_cic_coords`` (:119-136): pixel-centre
coordinates t = (x + L/2) (n/L) - 0.5 with an unclipped floor, non-finite
rays parked off the detector with value 0 (and a zero, not NaN, gradient),
corners below 0 masked and corners at n or above dropped. V is 1, 2 or 4
(``CHANNELS``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel

_ARGS = [P, P, P, I, L, I, I, F, F, F, F]
KERNEL = Kernel("cic.cu", {"cic_deposit": _ARGS + [P, P]},
                flags=["--fmad=false"])
BACKWARD_KERNEL = Kernel("cic.cu", {"cic_adjoint": _ARGS + [P, P, P, P, P]},
                         flags=["--fmad=false"])

CHANNELS = (1, 2, 4)
# None, or a list to which ``cic`` appends each deposit's inputs as
# ("deposit", x, y, vals, bins, Lx, Ly) and each adjoint's as ("adjoint",
# x, y, vals, dacc, bins, Lx, Ly), detached: for a caller that measures
# the kernels at the shapes a renderer gives them (off by default)
RECORD = None


def _scales(bins: Tuple[int, int], Lx: float, Ly: float,
            dtype=torch.float32):
    """(L/2, n/L) of each axis as ``dtype`` holds them (JAX's weak-typed
    scalars)."""
    nx, ny = bins
    f = np.float32 if dtype == torch.float32 else np.float64
    return (float(f(Lx / 2)), float(f(nx / Lx)), float(f(Ly / 2)),
            float(f(ny / Ly)))


def cic_plain(x: torch.Tensor, y: torch.Tensor, vals: torch.Tensor,
              bins: Tuple[int, int], Lx: float, Ly: float) -> torch.Tensor:
    """Plain version of the deposit: four ``index_put(accumulate=True)``
    scatters of value * (wx * wy), the masks decided on the float
    corners."""
    nx, ny = bins
    hx, sx, hy, sy = _scales(bins, Lx, Ly, x.dtype)
    tx = (x + hx) * sx - 0.5
    ty = (y + hy) * sy - 0.5
    finite = torch.isfinite(tx) & torch.isfinite(ty)
    park = torch.full_like(tx, -10.0)
    tx = torch.where(finite, tx, park)
    ty = torch.where(finite, ty, park)
    v = torch.where(finite[:, None], vals, torch.zeros_like(vals))
    ax, ay = torch.floor(tx), torch.floor(ty)
    fx, fy = tx - ax, ty - ay
    acc = torch.zeros((nx * ny, vals.shape[1]), dtype=vals.dtype,
                      device=vals.device)
    zero = torch.zeros_like(ax)
    for a, gx in ((0, 1.0 - fx), (1, fx)):
        for b, gy in ((0, 1.0 - fy), (1, fy)):
            cx, cy = ax + a, ay + b
            ok = (cx >= 0) & (cx <= nx - 1) & (cy >= 0) & (cy <= ny - 1)
            idx = (torch.where(ok, cx, zero).long() * ny
                   + torch.where(ok, cy, zero).long())
            val = torch.where(ok[:, None], v * (gx * gy)[:, None],
                              torch.zeros_like(v))
            acc = acc.index_put((idx,), val, accumulate=True)
    return acc.reshape(nx, ny, vals.shape[1])


def cic_vjp_plain(x: torch.Tensor, y: torch.Tensor, vals: torch.Tensor,
                  dacc: torch.Tensor, bins: Tuple[int, int], Lx: float,
                  Ly: float):
    """Plain version of the adjoint: (dx, dy, dvals), ``torch.autograd.
    grad`` of ``cic_plain`` at these inputs for the cotangent ``dacc``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, y, vals)]
        out = cic_plain(*leaves, bins, Lx, Ly)
        return torch.autograd.grad(out, leaves, dacc)


def _checked(x, y, vals, bins):
    n = x.shape[0]
    V = vals.shape[-1] if vals.dim() == 2 else 0
    if V not in CHANNELS or min(bins) < 1:
        raise ValueError(f"(N, {V}) values on {tuple(bins)} pixels: the "
                         f"deposit takes {CHANNELS} channels")
    dev = x.device
    for name, t, shape in (("x", x, (n,)), ("y", y, (n,)),
                           ("vals", vals, (n, V))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a float32 tensor of shape "
                             f"{shape} on the rays' device")
    return x.contiguous(), y.contiguous(), vals.contiguous(), V


def deposit(x: torch.Tensor, y: torch.Tensor, vals: torch.Tensor,
            bins: Tuple[int, int], Lx: float, Ly: float) -> torch.Tensor:
    """The (nx, ny, V) deposit, not differentiable: the kernel on CUDA
    tensors, ``cic_plain`` on CPU tensors."""
    if x.device.type == "cpu":
        return cic_plain(x, y, vals, bins, Lx, Ly)
    x, y, vals, V = _checked(x, y, vals, bins)
    nx, ny = bins
    acc = torch.zeros((nx, ny, V), dtype=torch.float32, device=x.device)
    KERNEL.launch("cic_deposit", x.device, x.data_ptr(), y.data_ptr(),
                  vals.data_ptr(), V, x.shape[0], nx, ny,
                  *_scales(bins, Lx, Ly), acc.data_ptr())
    return acc


def adjoint(x: torch.Tensor, y: torch.Tensor, vals: torch.Tensor,
            dacc: torch.Tensor, bins: Tuple[int, int], Lx: float,
            Ly: float):
    """(dx, dy, dvals) of the deposit for the cotangent ``dacc`` (nx, ny,
    V): the kernel on CUDA tensors, ``cic_vjp_plain`` on CPU tensors."""
    if x.device.type == "cpu":
        return cic_vjp_plain(x, y, vals, dacc, bins, Lx, Ly)
    x, y, vals, V = _checked(x, y, vals, bins)
    nx, ny = bins
    if (dacc.device != x.device or dacc.dtype != torch.float32
            or tuple(dacc.shape) != (nx, ny, V)):
        raise ValueError(f"dacc must be a float32 ({nx}, {ny}, {V}) tensor "
                         "on the rays' device")
    dacc = dacc.contiguous()
    dx, dy = torch.empty_like(x), torch.empty_like(y)
    dvals = torch.empty_like(vals)
    BACKWARD_KERNEL.launch(
        "cic_adjoint", x.device, x.data_ptr(), y.data_ptr(), vals.data_ptr(),
        V, x.shape[0], nx, ny, *_scales(bins, Lx, Ly), dacc.data_ptr(),
        dx.data_ptr(), dy.data_ptr(), dvals.data_ptr())
    return dx, dy, dvals


class _Cic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, vals, bins, Lx, Ly):
        ctx.save_for_backward(x, y, vals)
        ctx.geometry = (bins, Lx, Ly)
        if RECORD is not None:
            RECORD.append(("deposit", *(t.detach() for t in (x, y, vals)),
                           bins, Lx, Ly))
        return deposit(x, y, vals, bins, Lx, Ly)

    @staticmethod
    def backward(ctx, dacc):
        x, y, vals = ctx.saved_tensors
        if RECORD is not None:
            RECORD.append(("adjoint", *(t.detach() for t in (x, y, vals)),
                           dacc.detach(), *ctx.geometry))
        dx, dy, dvals = adjoint(x, y, vals, dacc, *ctx.geometry)
        return dx, dy, dvals, None, None, None


def cic(x: torch.Tensor, y: torch.Tensor, vals: torch.Tensor,
        bins: Tuple[int, int], Lx: float, Ly: float) -> torch.Tensor:
    """(nx, ny, V) cloud-in-cell sums of (N, V) ``vals`` at (N,) ``x``,
    ``y`` [mm], differentiable in all three (kernel K12 on a card)."""
    return _Cic.apply(x, y, vals, tuple(int(b) for b in bins), float(Lx),
                      float(Ly))
