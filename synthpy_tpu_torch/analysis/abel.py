"""Abel transform pair: axisymmetric density profiles from phase maps
(PyTorch port of ``synthpy_tpu.analysis.abel``).

The onion-peeling matrix method: the transform is one upper-triangular
(n, n) matrix of chord lengths shared by every axial row, so a whole map
inverts as one triangular solve (``torch.linalg.solve_triangular``) with a
batched right-hand side, or, Tikhonov-regularised, one ``torch.linalg.
solve``. Everything is float32, as in the JAX package. Each function runs
on the device of a tensor argument; an array goes to ``device`` (default
``"cuda"``; pass ``device="cpu"`` on a host without a card).

``phase_to_line_density`` converts tracer or fringe phase to the
integrated electron line density with the tracer's linearised
refractive-index convention (phase' = omega (n - 1) / c per unit path,
n - 1 ~= -ne / (2 n_c)).
"""

from __future__ import annotations

import torch

from synthpy_tpu_torch import _device
from synthpy_tpu_torch.constants import C, critical_density, omega_from_lwl


def _f32(a, device) -> torch.Tensor:
    """``a`` as a float32 tensor: on its own device when it is a tensor,
    else on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32)
    return torch.as_tensor(a, dtype=torch.float32,
                           device=_device.resolve(device))


def chord_matrix(n: int, dr: float = 1.0, device="cuda") -> torch.Tensor:
    """(n, n) upper-triangular onion-peeling chord-length matrix: shell j
    spans [j dr, (j + 1) dr), sight i passes at y_i = (i + 1/2) dr, and
    entry (i, j) = 2 (sqrt(r_{j+1}^2 - y_i^2) - sqrt(max(r_j, y_i)^2 -
    y_i^2)), in float32."""
    dev = _device.resolve(device)
    j = torch.arange(n + 1, dtype=torch.float32, device=dev) * dr
    y = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) * dr
    y2 = y[:, None] ** 2
    outer = torch.sqrt(torch.clamp_min(j[None, 1:] ** 2 - y2, 0.0))
    inner = torch.sqrt(torch.clamp_min(j[None, :-1] ** 2 - y2, 0.0))
    return 2.0 * (outer - inner)


def abel_forward(f, dr: float, device="cuda") -> torch.Tensor:
    """Project radial profile(s) f(r), (..., n) shell values at
    r = (i + 1/2) dr, to line integrals F(y) at the same points."""
    f = _f32(f, device)
    L = chord_matrix(f.shape[-1], float(dr), f.device)
    return f @ L.T


def abel_invert(F, dr: float, reg: float = 0.0,
                device="cuda") -> torch.Tensor:
    """Inverse Abel transform of projection(s) F(y), (..., n) at
    y = (i + 1/2) dr. ``reg == 0`` is the exact back-substitution inverse
    of ``abel_forward`` (onion peeling); ``reg > 0`` solves the Tikhonov
    system (L^T L + reg s D^T D) f = L^T F with a second-difference D
    (mirror row at the axis, free outer edge) and s = tr(L^T L) / n."""
    F = _f32(F, device)
    n = F.shape[-1]
    L = chord_matrix(n, float(dr), F.device)
    rhs = F.reshape(-1, n).T
    if reg == 0.0:
        sol = torch.linalg.solve_triangular(L, rhs, upper=True)
        return sol.T.reshape(F.shape)
    eye = torch.eye(n, dtype=torch.float32, device=F.device)
    D = eye * -2.0 + torch.diag(torch.ones(n - 1, device=F.device), 1) \
        + torch.diag(torch.ones(n - 1, device=F.device), -1)
    D[0] = 0.0
    D[0, 0], D[0, 1] = -2.0, 2.0
    D[n - 1] = 0.0
    G = L.T @ L
    scale = torch.trace(G) / torch.tensor(float(n), device=F.device)
    A = G + torch.tensor(reg, dtype=torch.float32) * scale * (D.T @ D)
    sol = torch.linalg.solve(A, L.T @ rhs)
    return sol.T.reshape(F.shape)


def phase_to_line_density(phase, lwl: float,
                          device="cuda") -> torch.Tensor:
    """Integrated line density [m^-2] from accumulated phase:
    -2 n_c c phase / omega (exact to first order in n_e / n_c). Physical
    plasma phase is negative, so the line density comes out positive."""
    omega = omega_from_lwl(lwl)
    n_c = critical_density(omega)
    phase = _f32(phase, device)
    return (-2.0 * n_c * C) * phase / torch.tensor(
        omega, dtype=torch.float32, device=phase.device)


def invert_phase_map(phase_map, dr: float, lwl: float,
                     axis_index: int | None = None, reg: float = 0.0,
                     device="cuda") -> torch.Tensor:
    """Phase map (rows across the symmetry axis, spacing ``dr`` [m]) ->
    radial n_e(r) per row [m^-3] at r = (i + 1/2) dr: each row is split
    about ``axis_index`` (default the centre), the two halves averaged,
    converted to line density and Abel-inverted. Expects the physical
    phase sign (in-plasma phase < 0)."""
    phase_map = _f32(phase_map, device)
    n_y = phase_map.shape[-1]
    c = n_y // 2 if axis_index is None else int(axis_index)
    right = phase_map[:, c:]
    left = phase_map[:, :c].flip(-1)
    n = min(left.shape[-1], right.shape[-1])
    sym = 0.5 * (left[:, :n] + right[:, :n])
    F = phase_to_line_density(sym, lwl)
    return abel_invert(F, dr, reg=reg)
