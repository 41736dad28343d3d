"""Detector binning (PyTorch port of ``synthpy_tpu.ops.histogram``:
``histogram2d``, ``complex_histogram`` and ``finalize_complex``).

``histogram2d`` follows numpy.histogram2d: a value on the rightmost edge
falls in the last bin; NaN positions (rays killed by apertures) and values
out of range are dropped. Scalars are rounded to float32 first, so the bin
arithmetic is the float32 arithmetic of the JAX package and of the
detector kernel (``kernels.detector``). ``complex_histogram`` keeps the
reference's coherent layout instead: ``x_edges_n - 1`` pixels, rays by
``digitize - 1``, the right edge dropped.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def f32(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float."""
    return float(np.float32(v))


def bin_params(lo: float, hi: float, nbins: int):
    """(lo, hi, bins per unit) as the float32 values the binning uses."""
    return f32(lo), f32(hi), f32(nbins / (hi - lo))


def _bin_index(v: torch.Tensor, lo: float, hi: float, nbins: int):
    """(index, valid) for numpy.histogram-compatible binning."""
    lo, hi, scale = bin_params(lo, hi, nbins)
    idx = torch.floor((v - lo) * scale)
    # numpy puts v == hi into the last bin
    idx = torch.where(v == hi, torch.full_like(idx, nbins - 1), idx)
    valid = torch.isfinite(v) & (v >= lo) & (v <= hi)
    idx = torch.nan_to_num(idx, nan=0.0).clamp(0, nbins - 1)
    return idx.to(torch.int64), valid


def histogram2d(
    x: torch.Tensor,
    y: torch.Tensor,
    bins: Tuple[int, int],
    range_: Tuple[Tuple[float, float], Tuple[float, float]],
    weights: torch.Tensor | None = None,
):
    """Weighted 2-D histogram, returned in image layout (ny, nx).

    Returns (H, xedges, yedges), like the JAX package.
    """
    (xlo, xhi), (ylo, yhi) = range_
    nx, ny = bins
    ix, vx = _bin_index(x, xlo, xhi, nx)
    iy, vy = _bin_index(y, ylo, yhi, ny)
    valid = vx & vy
    if weights is None:
        w = valid.to(torch.float32)
    else:
        w = torch.where(valid, weights, torch.zeros_like(weights))
    H = torch.zeros(ny * nx, dtype=w.dtype, device=x.device)
    H.index_add_(0, iy * nx + ix, w)
    xedges = torch.linspace(xlo, xhi, nx + 1)
    yedges = torch.linspace(ylo, yhi, ny + 1)
    return H.reshape(ny, nx), xedges, yedges


def _pixel_index(v: torch.Tensor, L: float, n: int):
    """(float pixel index, in range) of ``complex_histogram``'s layout:
    floor((v + L/2) / (L/n)), divided by a tensor so that CUDA divides
    exactly as the CPU does (and as the detector kernel does)."""
    d = torch.tensor(L / n, dtype=v.dtype, device=v.device)
    i = torch.floor((v + L / 2.0) / d)
    return i, (i >= 0) & (i < n)


def complex_histogram(
    x: torch.Tensor,
    y: torch.Tensor,
    Jx: torch.Tensor,
    Jy: torch.Tensor,
    x_edges_n: int,
    y_edges_n: int,
    Lx: float,
    Ly: float,
    convention: str = "legacy",
    return_acc: bool = False,
) -> torch.Tensor:
    """Coherent detector: per-pixel sums of the complex Jones field.

    ``x_edges_n`` points of linspace(-Lx/2, Lx/2) are the edges, so there
    are ``x_edges_n - 1`` pixels an axis; a ray goes to digitize - 1, and
    one left of the first edge or right of the last is dropped.
    ``convention`` "legacy" sums (Re Jx, Re Jy) and finalizes to
    sqrt(Re(sum Jx)^2 + Re(sum Jy)^2); "intensity" sums (Re, Im) of both
    and finalizes to |sum Jx|^2 + |sum Jy|^2. ``return_acc=True`` returns
    the (ny, nx, C) sums, which add exactly across ray batches; finalize
    the total once with ``finalize_complex``.
    """
    npx, npy = x_edges_n - 1, y_edges_n - 1
    ix, vx = _pixel_index(x, Lx, npx)
    iy, vy = _pixel_index(y, Ly, npy)
    valid = torch.isfinite(x) & torch.isfinite(y) & vx & vy
    ix = ix.nan_to_num(0.0).clamp(0, npx - 1).to(torch.int64)
    iy = iy.nan_to_num(0.0).clamp(0, npy - 1).to(torch.int64)
    if convention == "legacy":
        chans = torch.stack([Jx.real, Jy.real], dim=-1)
    elif convention == "intensity":
        chans = torch.stack([Jx.real, Jx.imag, Jy.real, Jy.imag], dim=-1)
    else:
        raise ValueError(f"unknown convention {convention!r}; "
                         "expected 'legacy' or 'intensity'")
    chans = torch.where(valid[:, None], chans, torch.zeros_like(chans))
    acc = torch.zeros((npy * npx, chans.shape[-1]), dtype=chans.dtype,
                      device=x.device)
    acc.index_add_(0, iy * npx + ix, chans)
    acc = acc.reshape(npy, npx, chans.shape[-1])
    if return_acc:
        return acc
    return finalize_complex(acc, convention)


def finalize_complex(acc: torch.Tensor, convention: str = "legacy"
                     ) -> torch.Tensor:
    """A (ny, nx, C) field-sum accumulator as a detector image (the
    counterpart of ``complex_histogram(..., return_acc=True)``)."""
    if convention == "legacy":
        return torch.sqrt(acc[..., 0] ** 2 + acc[..., 1] ** 2)
    if convention == "intensity":
        return (acc[..., 0] ** 2 + acc[..., 1] ** 2 + acc[..., 2] ** 2
                + acc[..., 3] ** 2)
    raise ValueError(f"unknown convention {convention!r}; "
                     "expected 'legacy' or 'intensity'")
