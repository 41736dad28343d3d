"""Fresnel diffraction propagation (PyTorch port of
``synthpy_tpu.ops.fresnel``).

Reflect-pad and 2-D Tukey window, FFT2, the Fresnel transfer function
H = exp(-i pi lambda z (fx^2 + fy^2)), an optional Gaussian LANEX PSF in
the Fourier domain, inverse FFT, crop. ``propagate`` first deposits the
rays' amplitude and phase on the grid by cloud-in-cell (``deposit_cic``:
kernel K8 on the card, both values in one pass).

Every step is float32 / complex64 as in the JAX package, and phases are
rounded where it rounds them, so the tests compare the field ``U`` itself:
see each function for where.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from synthpy_tpu_torch.kernels.deposit import deposit
from synthpy_tpu_torch.ops import dft


def _div(a: torch.Tensor, v: float) -> torch.Tensor:
    """a / f32(v), an IEEE division on every device (PyTorch on CUDA
    divides by a Python scalar through its reciprocal)."""
    return a / torch.tensor(v, dtype=a.dtype, device=a.device)


def unit_phasor(theta: float) -> complex:
    """exp(i theta) of a float32 phase, as complex64: the JAX package
    evaluates exp of a Python complex scalar in complex64 after rounding
    its argument to float32, and XLA's result is cos and sin of that
    float32 argument correctly rounded, which float64 gives here."""
    t = float(np.float32(theta))
    return complex(np.complex64(complex(math.cos(t), math.sin(t))))


def tukey(M: int, alpha: float = 0.5, device="cpu") -> torch.Tensor:
    """Tukey (tapered cosine) window of M points, float32, matching
    scipy.signal.windows.tukey and the JAX package's float32 arithmetic."""
    if alpha <= 0:
        return torch.ones(M, device=device)
    if alpha >= 1:
        alpha = 1.0
    n = torch.arange(M, dtype=torch.float32, device=device)
    width = alpha * (M - 1) / 2.0
    rising = 0.5 * (1.0 + torch.cos(math.pi * (_div(n, width) - 1.0)))
    falling = 0.5 * (1.0 + torch.cos(
        math.pi * _div(n - float(np.float32(M - 1 - width)), width)))
    w = torch.ones(M, device=device)
    w = torch.where(n < float(np.float32(width)), rising, w)
    return torch.where(n > float(np.float32((M - 1) - width)), falling, w)


def reflect_index(n: int, before: int, after: int,
                  device="cpu") -> torch.Tensor:
    """Source index of each element of an axis of length n reflect-padded
    by ``before`` / ``after`` (``numpy.pad(mode="reflect")``): the pattern
    repeats with period 2 (n - 1), so pads as wide as the axis or wider
    are fine (``torch.nn.functional.pad`` refuses them)."""
    j = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(j)
    m = torch.remainder(j, 2 * (n - 1))
    return torch.where(m < n, m, 2 * (n - 1) - m)


def prepare_field_for_propagation(U0: torch.Tensor, pad_factor: int = 2,
                                  alpha: float = 0.4) -> torch.Tensor:
    """Reflect-pad by pad_factor * shape a side and apply a 2-D Tukey
    window."""
    nx, ny = U0.shape
    px, py = nx * pad_factor, ny * pad_factor
    ix = reflect_index(nx, px, px, U0.device)
    iy = reflect_index(ny, py, py, U0.device)
    U = U0[ix][:, iy]
    w2d = torch.outer(tukey(U.shape[0], alpha, U0.device),
                      tukey(U.shape[1], alpha, U0.device))
    return U * w2d


def fresnel_propagate(
    U0_prepared: torch.Tensor,
    L: Tuple[float, float],
    wavelength: float,
    z: float,
    original_shape: Tuple[int, int],
    pad_factor: int = 2,
    lanex_fwhm_m: Optional[float] = None,
) -> torch.Tensor:
    """Propagate a prepared (padded, windowed) complex field a distance z
    [m] and crop it back to ``original_shape``; ``L`` = (Lx, Ly) are the
    side lengths of the original field [m]; ``lanex_fwhm_m`` an optional
    Gaussian PSF FWHM applied in Fourier space.

    Rounding, as the JAX package's: the transfer function's phase is
    -f32(pi lambda z) (fx^2 + fy^2) in float32; the PSF's exponent is
    built from float32 scalars (log 2 included); the carrier
    exp(i (2 pi / lambda) z) has its argument (~1.8e6 rad at 1064 nm and
    0.3 m) rounded to float32 before the exponential, which moves it by up
    to ~0.06 rad; the division by (i lambda z) is by f32(lambda z).
    """
    Nx, Ny = original_shape
    dev = U0_prepared.device
    fx = dft.fftfreq(U0_prepared.shape[0], d=L[0] / Nx, device=dev)
    fy = dft.fftfreq(U0_prepared.shape[1], d=L[1] / Ny, device=dev)
    Q = fx[:, None] ** 2 + fy[None, :] ** 2
    theta = Q * float(np.float32(-(math.pi * wavelength) * z))
    Uz_ft = dft.fft2(U0_prepared) * torch.complex(torch.cos(theta),
                                                  torch.sin(theta))
    if lanex_fwhm_m is not None and lanex_fwhm_m > 0:
        f = np.float32
        sigma = f(lanex_fwhm_m) / (f(2) * np.sqrt(f(2) * np.log(f(2.0))))
        ps = f(np.pi) * sigma
        Uz_ft = Uz_ft * torch.exp(Q * float(f(-2) * (ps * ps)))
    Uz = dft.ifft2(Uz_ft) * unit_phasor((2 * math.pi / wavelength) * z)
    # / (i d) = (im / d, -re / d), d = f32(lambda z)
    d = torch.tensor(float(np.float32(wavelength * z)), device=dev)
    Uz = torch.complex(Uz.imag / d, -Uz.real / d)
    sx, sy = Nx * pad_factor, Ny * pad_factor
    return Uz[sx:sx + Nx, sy:sy + Ny]


def propagate(
    lwl: float,
    x: torch.Tensor,
    y: torch.Tensor,
    x_length: float,
    y_length: float,
    rays: torch.Tensor,
    amplitudes: torch.Tensor,
    phases: torch.Tensor,
    z: float,
    pad_factor: int = 2,
) -> torch.Tensor:
    """Deposit per-ray amplitude and phase on the (x, y) grid nodes (rows 0
    and 2 of ``rays`` are the positions, in the grid's unit), combine them
    as U0 = A exp(-i phase) and Fresnel-propagate a distance z [m] over
    side lengths (x_length, y_length) [m]. Returns the complex field on
    the grid. Both values go through one deposit (one weight channel), as
    the JAX package's two deposits at the same positions give."""
    g = deposit(rays[0].contiguous(), rays[2].contiguous(),
                torch.stack([amplitudes, phases], dim=1), x, y)
    amp_grid, phase_grid = g[..., 0], g[..., 1]
    U0 = amp_grid * torch.complex(torch.cos(phase_grid),
                                  -torch.sin(phase_grid))
    U0p = prepare_field_for_propagation(U0, pad_factor=pad_factor)
    return fresnel_propagate(U0p, (x_length, y_length), lwl, z,
                             tuple(U0.shape), pad_factor=pad_factor)


def fresnel_number(x_length: float, lwl: float, z: float) -> float:
    """N_f = a^2 / (lambda z)."""
    return x_length**2 / (lwl * z)
