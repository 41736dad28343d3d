"""Regularisation priors for inverse problems (PyTorch port of
``synthpy_tpu.priors``), plain tensor chains that autograd differentiates,
to add to a data misfit as ``loss = data + w * prior`` beside
``synthpy_tpu_torch.inverse``:

- ``tv``: anisotropic total variation (mean |forward difference| per axis);
- ``haar_l1``: sparsity of the multi-level orthonormal 2-D Haar transform
  (``haar2d`` / ``ihaar2d``) on the leading two axes;
- ``make_grf_whitener`` / ``make_grf_modal``: a Gaussian-process prior with
  covariance spectrum E(k), as a reparameterisation ``g = colorize(theta)``
  (or ``synth(u)`` in mode space) under which ``white_l2`` is exactly the
  Gaussian log-prior.

All functions accept 2-D or 3-D fields; the spectral ones run on
``ops.dft`` (cuFFT on a card) and take ``device=``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from synthpy_tpu_torch import _device
from synthpy_tpu_torch.fields.grf import _safe_spectrum
from synthpy_tpu_torch.ops import dft

__all__ = ["tv", "haar_l1", "haar2d", "ihaar2d", "make_grf_whitener",
           "make_grf_modal", "white_l2"]


def tv(g: torch.Tensor, axes: Sequence[int] | None = None) -> torch.Tensor:
    """Anisotropic total variation: sum over axes of mean |forward diff|."""
    if axes is None:
        axes = range(g.dim())
    return sum(torch.mean(torch.abs(torch.diff(g, dim=a))) for a in axes)


# ---------------------------------------------------------------------------
# Haar wavelet sparsity
# ---------------------------------------------------------------------------

_R2 = math.sqrt(2.0)


def _haar_once(g: torch.Tensor):
    """One orthonormal 2-D Haar analysis step on the leading two axes."""
    a = (g[0::2] + g[1::2]) / _R2
    d = (g[0::2] - g[1::2]) / _R2
    aa = (a[:, 0::2] + a[:, 1::2]) / _R2   # LL
    ad = (a[:, 0::2] - a[:, 1::2]) / _R2   # LH
    da = (d[:, 0::2] + d[:, 1::2]) / _R2   # HL
    dd = (d[:, 0::2] - d[:, 1::2]) / _R2   # HH
    return aa, (ad, da, dd)


def haar2d(g: torch.Tensor, levels: int = 3):
    """Multi-level orthonormal 2-D Haar transform: ``(approx, details)``,
    details a list (coarsest last) of (LH, HL, HH) triples. The leading two
    axis lengths must be divisible by 2**levels."""
    for n in g.shape[:2]:
        if n % (1 << levels):
            raise ValueError(
                f"haar2d: axis length {n} not divisible by 2^{levels}")
    details = []
    a = g
    for _ in range(levels):
        a, d = _haar_once(a)
        details.append(d)
    return a, details


def ihaar2d(approx: torch.Tensor, details) -> torch.Tensor:
    """Inverse of ``haar2d`` (exact, orthonormal)."""
    a = approx
    for ad, da, dd in reversed(details):
        c0, c1 = (a + ad) / _R2, (a - ad) / _R2
        e0, e1 = (da + dd) / _R2, (da - dd) / _R2
        ny = a.shape[1] * 2
        av = torch.stack([c0, c1], dim=2).reshape(a.shape[0], ny,
                                                  *a.shape[2:])
        dv = torch.stack([e0, e1], dim=2).reshape(a.shape[0], ny,
                                                  *a.shape[2:])
        r0, r1 = (av + dv) / _R2, (av - dv) / _R2
        a = torch.stack([r0, r1], dim=1).reshape(a.shape[0] * 2, ny,
                                                 *a.shape[2:])
    return a


def haar_l1(g: torch.Tensor, levels: int = 3,
            detail_only: bool = True) -> torch.Tensor:
    """Mean |Haar detail coefficient| over ``levels`` scales; with
    ``detail_only=False`` the coarse approximation counts too."""
    a, details = haar2d(g, levels)
    total = sum(torch.abs(x).mean() for tri in details for x in tri)
    if not detail_only:
        total = total + torch.abs(a).mean()
    return total / (3 * levels + (0 if detail_only else 1))


# ---------------------------------------------------------------------------
# GRF-spectrum prior via whitening reparameterisation
# ---------------------------------------------------------------------------

def _spacings(spacing, ndim: int):
    if np.ndim(spacing) == 0:
        return (float(spacing),) * ndim
    return tuple(float(s) for s in spacing)


def make_grf_whitener(shape: Tuple[int, ...], spacing, k_func: Callable,
                      l_max: float | None = None, l_min: float | None = None,
                      device="cuda"):
    """``(colorize, n_active)``: ``colorize(theta)`` filters a real field
    ``theta`` of ``shape`` by sqrt(E(|k|)) in Fourier space (|k| in
    rad/length from ``spacing``, band-limited to [2 pi / l_max, 2 pi /
    l_min] when given, the DC mode zeroed), normalised so that
    standard-normal theta gives a unit-variance field. A band with no mode
    raises."""
    dev = _device.resolve(device)
    ndim = len(shape)
    ks = [2 * math.pi * dft.fftfreq(n, d=s, device=dev)
          for n, s in zip(shape, _spacings(spacing, ndim))]
    kgrids = torch.meshgrid(*ks, indexing="ij")
    k = torch.sqrt(sum(g ** 2 for g in kgrids))
    S = _safe_spectrum(k_func, k)
    if l_max is not None:
        S = torch.where(k >= 2 * math.pi / l_max, S, torch.zeros_like(S))
    if l_min is not None:
        S = torch.where(k <= 2 * math.pi / l_min, S, torch.zeros_like(S))
    amp = torch.sqrt(S)
    n_active = int((S > 0).sum())
    if n_active == 0:
        raise ValueError("GRF prior band contains no modes: check "
                         "l_max/l_min against the grid Nyquist range")
    # var(g) = mean(amp^2) var(theta) with numpy-convention fftn/ifftn
    amp = amp / torch.sqrt(torch.mean(amp ** 2))

    def colorize(theta: torch.Tensor) -> torch.Tensor:
        F = dft.fftn(theta.to(torch.float32))
        return torch.real(dft.ifftn(F * amp))

    return colorize, n_active


def make_grf_modal(shape: Tuple[int, ...], spacing, k_func: Callable,
                   l_max: float | None = None, l_min: float | None = None,
                   device="cuda"):
    """``(synth, n_modes)``: a GP prior in mode space. ``synth(u)`` maps a
    real (n_modes, 2) array of (cos, -sin) coefficients of the canonical
    half of the band's active modes, in prior-scaled units, to the field
    sum_k tau_k [u_k0 cos(kx) - u_k1 sin(kx)], tau_k ~ sqrt(E(|k|))
    normalised so that standard-normal u gives a unit-variance field;
    ``white_l2(u)`` is then the Gaussian log-prior. A step of lr moves mode
    k by tau_k lr <= lr, whatever the resolution. The mode selection runs
    on the host in float64, as in the JAX package."""
    dev = _device.resolve(device)
    ndim = len(shape)
    ks = [2 * np.pi * np.fft.fftfreq(n, d=s)
          for n, s in zip(shape, _spacings(spacing, ndim))]
    kgrids = np.meshgrid(*ks, indexing="ij")
    k = np.sqrt(sum(g ** 2 for g in kgrids))
    # the spectrum of a float32 |k|, as the JAX package evaluates it
    S = _safe_spectrum(k_func, torch.from_numpy(k.astype(np.float32))
                       ).double().numpy()
    if l_max is not None:
        S = np.where(k >= 2 * np.pi / l_max, S, 0.0)
    if l_min is not None:
        S = np.where(k <= 2 * np.pi / l_min, S, 0.0)
    S[(0,) * ndim] = 0.0
    # canonical half-spectrum: first nonzero signed frequency positive
    half = np.zeros(shape, bool)
    cond = np.ones(shape, bool)
    for g in kgrids:
        half |= cond & (g > 1e-12)
        cond &= np.abs(g) <= 1e-12
    sel = (S > 0) & half
    n_modes = int(sel.sum())
    if n_modes == 0:
        raise ValueError("GRF modal band contains no modes: check "
                         "l_max/l_min against the grid Nyquist range")
    idx = np.flatnonzero(sel.ravel())
    tau = np.sqrt(S.ravel()[idx])
    tau = tau / np.sqrt((tau ** 2).sum())   # var(g) = sum tau^2 = 1
    n_tot = int(np.prod(shape))
    idx_t = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    tau_t = torch.as_tensor(tau, dtype=torch.float32, device=dev)

    def synth(u: torch.Tensor) -> torch.Tensor:
        coef = torch.complex(tau_t * u[:, 0], tau_t * u[:, 1]) * n_tot
        C = torch.zeros(n_tot, dtype=torch.complex64, device=u.device)
        C = C.index_put((idx_t,), coef)
        return torch.real(dft.ifftn(C.reshape(shape)))

    return synth, n_modes


def white_l2(theta: torch.Tensor) -> torch.Tensor:
    """Standard-normal negative log-prior (per element): mean(theta^2)/2."""
    return 0.5 * torch.mean(theta ** 2)
