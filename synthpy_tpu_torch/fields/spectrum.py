"""Isotropic power-spectrum estimators for generated fields (PyTorch port of
``synthpy_tpu.fields.spectrum``): one shell-averaged spectrum for 1/2/3-D
fields with integer, linear or log-spaced shells, summed per shell with
``index_add_`` on the field's device; the slope fit runs in host numpy, as
in the JAX package."""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from synthpy_tpu_torch.fields.domain import linspace
from synthpy_tpu_torch.ops import dft


def radial_spectrum(field: torch.Tensor, lengths, nbins: int = 0,
                    log_bins: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shell-averaged power spectrum of a real field.

    ``lengths``: the physical length per axis (a scalar or one per axis).
    ``nbins``: 0 for one shell per integer multiple of the fundamental up
    to Nyquist, else that many bins, linear or (``log_bins``) log-spaced.
    Returns (k_centers [rad/length], mean |F(k)|^2 per shell, shell
    occupancy)."""
    ndim = field.dim()
    if np.ndim(lengths) == 0:
        lengths = (float(lengths),) * ndim
    shape = field.shape
    dev = field.device
    P = torch.abs(dft.fftn(field)) ** 2
    ks = [2 * math.pi * dft.fftfreq(n, d=length / n, device=dev)
          for n, length in zip(shape, lengths)]
    kgrids = torch.meshgrid(*ks, indexing="ij")
    kmag = torch.sqrt(sum(g**2 for g in kgrids)).reshape(-1)
    P = P.reshape(-1)
    # Python floats, as the JAX module computes them
    k_nyq = float(min(math.pi * n / length
                      for n, length in zip(shape, lengths)))
    k_min_pos = float(min(2 * math.pi / length for length in lengths))
    if nbins == 0:
        # integer shells in units of the fundamental
        nbins = max(int(k_nyq / k_min_pos), 1)
        edges = (torch.arange(nbins + 1, dtype=torch.float32, device=dev)
                 + 0.5) * k_min_pos
    elif log_bins:
        def log10(v):   # XLA's float32 log10: log(v) * f32(1 / ln 10)
            return float(np.float32(np.log(np.float32(v)))
                         * np.float32(1.0 / np.log(10.0)))

        lo, hi = log10(k_min_pos * 0.5), log10(k_nyq)
        edges = torch.pow(10.0, linspace(lo, hi, nbins + 1, device=dev))
    else:
        edges = linspace(0.0, k_nyq, nbins + 1, device=dev)
    idx = torch.clamp(torch.searchsorted(edges, kmag, right=True) - 1, 0,
                      nbins - 1)
    in_range = (kmag >= edges[0]) & (kmag <= edges[-1])
    w = torch.where(in_range, P, torch.zeros_like(P))
    ones = in_range.to(torch.float32)
    power = torch.zeros(nbins, dtype=torch.float32, device=dev).index_add_(
        0, idx, w)
    counts = torch.zeros(nbins, dtype=torch.float32, device=dev).index_add_(
        0, idx, ones)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, power / torch.clamp_min(counts, 1.0), counts


def fit_spectral_slope(k, E_k, counts, k_lo: float, k_hi: float) -> float:
    """Least-squares log-log slope over the occupied shells in
    [k_lo, k_hi] (host numpy)."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    k, E, c = host(k), host(E_k), host(counts)
    mask = (k >= k_lo) & (k <= k_hi) & (c > 0) & (E > 0)
    slope, _ = np.polyfit(np.log(k[mask]), np.log(E[mask]), 1)
    return float(slope)


def moving_average(a: torch.Tensor, n: int = 3) -> torch.Tensor:
    """Simple smoother: the 'valid' convolution with a box of n."""
    a = torch.as_tensor(a)
    kernel = torch.ones(n, dtype=a.dtype, device=a.device) / n
    return torch.nn.functional.conv1d(a[None, None], kernel.flip(0)[None,
                                                                   None])[0, 0]
