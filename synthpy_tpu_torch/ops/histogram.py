"""Detector binning and grid deposits (PyTorch port of
``synthpy_tpu.ops.histogram``: ``histogram2d``, ``complex_histogram``,
``finalize_complex`` and ``deposit_cic``).

``histogram2d`` follows numpy.histogram2d: a value on the rightmost edge
falls in the last bin; NaN positions (rays killed by apertures) and values
out of range are dropped. Scalars are rounded to float32 first, so the bin
arithmetic is the float32 arithmetic of the JAX package and of the
detector kernel (``kernels.detector``). ``complex_histogram`` keeps the
reference's coherent layout instead: ``x_edges_n - 1`` pixels, rays by
``digitize - 1``, the right edge dropped.

On CUDA tensors ``histogram2d`` and ``complex_histogram`` launch K3's
bare-ray entry points (``kernels.binning``) and ``deposit_cic`` launches
K8 (``kernels.deposit``); ``histogram2d_plain``, ``complex_histogram_plain``
and ``kernels.deposit.deposit_plain`` are their plain versions, taken for
CPU tensors only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from synthpy_tpu_torch.kernels import binning
from synthpy_tpu_torch.kernels.deposit import deposit


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

    Returns (H, xedges, yedges), like the JAX package. On CUDA the rays
    (and weights) must be float32; the image is float32.
    """
    if x.device.type == "cpu":
        return histogram2d_plain(x, y, bins, range_, weights)
    (xlo, xhi), (ylo, yhi) = range_
    nx, ny = bins
    H = binning.bin_image(x, y, weights, nx, ny, bin_params(xlo, xhi, nx),
                          bin_params(ylo, yhi, ny))
    return (H, torch.linspace(xlo, xhi, nx + 1),
            torch.linspace(ylo, yhi, ny + 1))


def histogram2d_plain(
    x: torch.Tensor,
    y: torch.Tensor,
    bins: Tuple[int, int],
    range_: Tuple[Tuple[float, float], Tuple[float, float]],
    weights: torch.Tensor | None = None,
):
    """Plain version of ``histogram2d`` (one ``index_add_``)."""
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
    the total once with ``finalize_complex``. On CUDA the positions must
    be float32 and the fields complex64.
    """
    if x.device.type == "cpu":
        return complex_histogram_plain(x, y, Jx, Jy, x_edges_n, y_edges_n,
                                       Lx, Ly, convention, return_acc)
    if convention not in ("legacy", "intensity"):
        raise ValueError(f"unknown convention {convention!r}; "
                         "expected 'legacy' or 'intensity'")
    npx, npy = x_edges_n - 1, y_edges_n - 1
    acc = binning.bin_field(x, y, Jx, Jy, npx, npy,
                            (f32(Lx / 2.0), f32(Lx / npx)),
                            (f32(Ly / 2.0), f32(Ly / npy)),
                            2 if convention == "legacy" else 4)
    if return_acc:
        return acc
    return finalize_complex(acc, convention)


def complex_histogram_plain(
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
    """Plain version of ``complex_histogram`` (one ``index_add_``)."""
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


def deposit_cic(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                x_coords: torch.Tensor, y_coords: torch.Tensor
                ) -> torch.Tensor:
    """Cloud-in-cell (bilinear) deposit of (N,) real or complex values
    ``w`` at (N,) positions onto the (len(x_coords), len(y_coords)) grid of
    uniform node coordinates, each node divided by its deposited weight
    (max(weight, 1e-12)), so the grid approximates the local average of
    ``w``. A ray is deposited when (pos - c[0]) / (c[1] - c[0]) is finite
    and within the grid on both axes (kernel K8 on CUDA)."""
    if torch.is_complex(w):
        g = deposit(x, y, torch.view_as_real(w), x_coords, y_coords)
        return torch.complex(g[..., 0], g[..., 1])
    return deposit(x, y, w[:, None], x_coords, y_coords)[..., 0]
