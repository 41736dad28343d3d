"""Trilinear interpolation on grids (PyTorch port of
``synthpy_tpu.ops.interp``).

``trilinear`` is the uniform-grid lookup of the time-domain tracers: one
8-corner gather of every channel of a channels-last (nx, ny, nz, C) grid,
in the JAX package's operation order (inside mask, clipped corner cell,
clipped fractions, the eight weighted corners summed in order), with
``fill_value`` outside the box. With ``contract=True`` the corner sum is
the one XLA's CPU compiler emits for the JAX tracers' compiled steps,
``fma(w0, c0, w1 * c1)`` and then one fused multiply-add a corner: the
plain version of the gathers of kernels K5 and K6
(``kernels/csrc/time_rhs.cuh``). ``trilinear_nonuniform`` is the
searchsorted path for monotone non-uniform axes.
"""

from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch


def _as_tensor(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, np.ndarray) and not v.flags.writeable:
        v = v.copy()   # torch takes only writable arrays without a warning
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def fma(a, b, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to ``c``'s dtype, as a fused multiply-add
    rounds it: float32 operands are multiplied exactly and added in
    float64 (rounded twice only when the float64 sum falls on a float32
    tie, about once in 2^29 inexact sums)."""
    if c.dtype != torch.float32:
        return a * b + c
    a = a.double() if isinstance(a, torch.Tensor) else float(a)
    return (a * b.double() + c.double()).float()


def trilinear(values: torch.Tensor, pos: torch.Tensor, origin, inv_spacing,
              fill_value=0.0, contract: bool = False) -> torch.Tensor:
    """(N, C) channels of a (nx, ny, nz, C) grid at (N, 3) points ((N,)
    for a 3-D grid); ``origin`` is the coordinate of node (0, 0, 0) and
    ``inv_spacing`` the reciprocal spacing per axis. ``contract`` sums the
    corners with fused multiply-adds (see the module docstring)."""
    squeeze = values.dim() == 3
    if squeeze:
        values = values[..., None]
    nx, ny, nz, C = values.shape
    origin = _as_tensor(origin, pos)
    inv_spacing = _as_tensor(inv_spacing, pos)
    dims = torch.tensor([nx, ny, nz], dtype=pos.dtype, device=pos.device)
    t = (pos - origin) * inv_spacing
    inside = ((t >= 0.0) & (t <= dims - 1.0)).all(dim=-1)
    # clip(floor(t), 0, n - 2) as the JAX int32 conversion gives it (a NaN
    # coordinate lands on 0; its value is masked)
    hi = torch.tensor([nx - 2, ny - 2, nz - 2], dtype=pos.dtype,
                      device=pos.device)
    i = torch.minimum(torch.floor(t).nan_to_num(0.0).clamp_min(0.0), hi)
    f = torch.clamp(t - i, 0.0, 1.0)
    ii = i.to(torch.int64)
    ix, iy, iz = ii[:, 0], ii[:, 1], ii[:, 2]
    fx, fy, fz = f[:, 0:1], f[:, 1:2], f[:, 2:3]
    gx, gy, gz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    flat = values.reshape(nx * ny * nz, C)
    base = (ix * ny + iy) * nz + iz

    def corner(dx: int, dy: int, dz: int) -> torch.Tensor:
        return flat[base + (dx * ny + dy) * nz + dz]

    if contract:
        w = (gx * gy * gz, gx * gy * fz, gx * fy * gz, gx * fy * fz,
             fx * gy * gz, fx * gy * fz, fx * fy * gz, fx * fy * fz)
        c = [corner(dx, dy, dz) for dx in (0, 1) for dy in (0, 1)
             for dz in (0, 1)]
        out = fma(w[0], c[0], w[1] * c[1])
        for k in range(2, 8):
            out = fma(w[k], c[k], out)
    else:
        out = (gx * gy * gz * corner(0, 0, 0)
               + gx * gy * fz * corner(0, 0, 1)
               + gx * fy * gz * corner(0, 1, 0)
               + gx * fy * fz * corner(0, 1, 1)
               + fx * gy * gz * corner(1, 0, 0)
               + fx * gy * fz * corner(1, 0, 1)
               + fx * fy * gz * corner(1, 1, 0)
               + fx * fy * fz * corner(1, 1, 1))
    fill = torch.broadcast_to(_as_tensor(fill_value, out), (C,))
    out = torch.where(inside[:, None], out, fill)
    return out[:, 0] if squeeze else out


def grid_geometry(coords: Sequence[torch.Tensor]):
    """(origin, inv_spacing) of per-axis uniform coordinate vectors, the
    spacing from each axis's first interval."""
    origin = torch.stack([c[0] for c in coords])
    inv_spacing = torch.stack([1.0 / (c[1] - c[0]) for c in coords])
    return origin, inv_spacing


def regular_grid_interpolator(points: Sequence[torch.Tensor],
                              values: torch.Tensor, xi: torch.Tensor,
                              fill_value: float = 0.0) -> torch.Tensor:
    """scipy-style wrapper: ``values`` (nx, ny, nz) on the uniform axes
    ``points``, at (N, 3) points ``xi``."""
    origin, inv_spacing = grid_geometry(points)
    return trilinear(values, xi, origin, inv_spacing, fill_value=fill_value)


def trilinear_nonuniform(points: Sequence[torch.Tensor],
                         values: torch.Tensor, xi: torch.Tensor,
                         fill_value=0.0) -> torch.Tensor:
    """Trilinear interpolation on monotone per-axis grids (searchsorted
    cells), ``fill_value`` outside; (N, C), or (N,) for a grid without a
    channel axis."""
    squeeze = values.dim() == len(points)
    if squeeze:
        values = values[..., None]
    dims = values.shape[:-1]
    C = values.shape[-1]
    idxs, fracs = [], []
    inside = torch.ones(xi.shape[0], dtype=torch.bool, device=xi.device)
    for d, coords in enumerate(points):
        q = xi[:, d].contiguous()
        inside = inside & (q >= coords[0]) & (q <= coords[-1])
        i = torch.clamp(torch.searchsorted(coords, q, right=True) - 1, 0,
                        coords.shape[0] - 2)
        lo, hi = coords[i], coords[i + 1]
        fracs.append(torch.clamp((q - lo) / (hi - lo), 0.0, 1.0))
        idxs.append(i)
    flat = values.reshape(-1, C)
    strides, s = [], 1
    for n in reversed(dims):
        strides.append(s)
        s *= n
    strides = strides[::-1]
    base = sum(idxs[d] * strides[d] for d in range(len(dims)))
    out = torch.zeros((xi.shape[0], C), dtype=values.dtype, device=xi.device)
    for corner in itertools.product((0, 1), repeat=len(dims)):
        w = torch.ones(xi.shape[0], dtype=values.dtype, device=xi.device)
        off = 0
        for d, c in enumerate(corner):
            w = w * (fracs[d] if c else (1.0 - fracs[d]))
            off += c * strides[d]
        out = out + w[:, None] * flat[base + off]
    fill = torch.broadcast_to(_as_tensor(fill_value, out), (C,))
    out = torch.where(inside[:, None], out, fill)
    return out[:, 0] if squeeze else out
