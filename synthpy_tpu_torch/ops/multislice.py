"""Multi-slice (split-step) wave propagation through a plasma volume
(PyTorch port of ``synthpy_tpu.ops.multislice``).

The volume is a stack of thin phase screens phi = k (n - 1) dz with
angular-spectrum free-space propagation between them: the full-wave
companion of the ray tracer. The JAX package's ``lax.scan`` over planes is
a Python loop here; each step is elementwise tensor code around a cuFFT
pair on the card.

Rounding, as the JAX package's (see each function): phases are float32
products of float32-rounded wavenumbers and the coordinate steps, which
are float32 tensors; the carrier removed at the end has its argument
(~k times the probing length, ~6e4 rad at 1064 nm over 1 cm) rounded to
float32 before the exponential.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from synthpy_tpu_torch import constants
from synthpy_tpu_torch.ops import dft
from synthpy_tpu_torch.ops.fresnel import unit_phasor


def transfer_function(shape: Tuple[int, int], dz: torch.Tensor, lwl: float,
                      dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """The angular-spectrum transfer function exp(i kz dz) over an (nx, ny)
    grid of steps (dx, dy) (float32 tensors), with evanescent components
    set to 0: kz^2 = f32(k^2) - (f32(2 pi) fx)^2 - (f32(2 pi) fy)^2 in
    float32."""
    fx = dft.fftfreq(shape[0], d=dx)
    fy = dft.fftfreq(shape[1], d=dy)
    k = 2 * math.pi / lwl
    kz_sq = (k**2 - (2 * math.pi * fx[:, None]) ** 2) \
        - (2 * math.pi * fy[None, :]) ** 2
    kz = torch.sqrt(torch.clamp_min(kz_sq, 0.0))
    theta = kz * dz
    H = torch.complex(torch.cos(theta), torch.sin(theta))
    return torch.where(kz_sq > 0, H, torch.zeros_like(H))


def angular_spectrum_step(U: torch.Tensor, dz, lwl: float, dx,
                          dy) -> torch.Tensor:
    """Exact free-space angular-spectrum propagation of U over dz."""
    as_t = [v if isinstance(v, torch.Tensor)
            else torch.tensor(v, dtype=torch.float32, device=U.device)
            for v in (dz, dx, dy)]
    H = transfer_function(tuple(U.shape), *as_t[:1], lwl, *as_t[1:])
    return dft.ifft2(dft.fft2(U) * H)


def multislice_propagate(
    ne: torch.Tensor,
    coords: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    lwl: float = constants.DEFAULT_LWL,
    *,
    input_field: Optional[torch.Tensor] = None,
    probing_direction: str = "z",
    remove_carrier: bool = True,
) -> torch.Tensor:
    """Propagate a coherent field through an (nx, ny, nz) n_e volume
    [m^-3], slice by slice along ``probing_direction``; ``coords`` are the
    per-axis coordinate vectors (float32, on ne's device), ``input_field``
    the (na, nb) complex entry field (default: a unit plane wave). With
    ``remove_carrier`` the vacuum carrier exp(i k z) is divided out, so
    the (na, nb) complex64 exit field holds only the plasma's modulation.

    Each slab between consecutive planes is a screen of the planes' mean
    n - 1 (``constants.n_refrac(ne, omega) - 1``, in float32 as in JAX),
    applied as exp(i (f32(k) dz) screen), then one angular-spectrum step
    of dz.
    """
    ax = {"x": 0, "y": 1, "z": 2}[probing_direction]
    trans = [a for a in range(3) if a != ax]
    vol = torch.movedim(ne, ax, -1)
    ca, cb, cp = coords[trans[0]], coords[trans[1]], coords[ax]
    dx, dy, dz = ca[1] - ca[0], cb[1] - cb[0], cp[1] - cp[0]
    omega = constants.omega_from_lwl(lwl)
    k = 2 * math.pi / lwl
    planes = torch.movedim(constants.n_refrac(vol, omega) - 1.0, -1,
                          0).contiguous()
    na, nb = vol.shape[0], vol.shape[1]
    U = (torch.ones((na, nb), dtype=torch.complex64, device=ne.device)
         if input_field is None
         else torch.as_tensor(input_field).to(ne.device, torch.complex64))
    kdz = dz * float(np.float32(k))
    H = transfer_function((na, nb), dz, lwl, dx, dy)
    n_slabs = planes.shape[0] - 1
    for i in range(n_slabs):
        screen = 0.5 * (planes[i] + planes[i + 1])
        theta = kdz * screen
        U = U * torch.complex(torch.cos(theta), torch.sin(theta))
        U = dft.ifft2(dft.fft2(U) * H)
    if remove_carrier:
        f = np.float32
        arg = (f(-k) * f(dz.item())) * f(n_slabs)
        U = U * unit_phasor(float(arg))
    return U


def exit_intensity(U: torch.Tensor) -> torch.Tensor:
    """|U|^2: the wave-optics shadowgram at the volume exit."""
    return U.abs() ** 2


def exit_phase(U: torch.Tensor) -> torch.Tensor:
    """The exit phase angle(U) of the modulation field (wrapped)."""
    return torch.angle(U)
