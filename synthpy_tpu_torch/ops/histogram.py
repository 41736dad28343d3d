"""Detector binning (PyTorch port of ``synthpy_tpu.ops.histogram``,
incoherent subset).

Conventions match numpy.histogram2d: a value on the rightmost edge falls
in the last bin; NaN positions (rays killed by apertures) and values out
of range are dropped. Scalars are rounded to float32 first, so the bin
arithmetic is the float32 arithmetic of the JAX package and of the
detector kernel (``kernels.detector``).
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
