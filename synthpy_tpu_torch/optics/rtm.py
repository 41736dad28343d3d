"""Ray-transfer-matrix optics primitives (PyTorch port of
``synthpy_tpu.optics.rtm``).

Operates on (4, N) ray matrices [x, theta, y, phi] in mm/radians. Filters
kill rays by setting all four rows to NaN. A 4x4 matrix is applied as four
explicit multiply-add chains in a fixed order (``matvec``), so that the
detector kernel (``kernels.detector``) can repeat the arithmetic bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def m_to_mm(r: torch.Tensor) -> torch.Tensor:
    """Scale position rows (0 and 2) from metres to mm."""
    return r * torch.tensor((1e3, 1.0, 1e3, 1.0), dtype=r.dtype,
                            device=r.device)[:, None]


def matvec(M, r: torch.Tensor) -> torch.Tensor:
    """``M @ r`` for a 4x4 matrix (cast to r's dtype) and (4, N) rays:
    row i is ((M[i,0] r0 + M[i,1] r1) + M[i,2] r2) + M[i,3] r3. Every
    term is kept, so a NaN ray stays NaN in every row, as in a matmul."""
    Mf = np.asarray(M, np.float64).astype(
        np.float32 if r.dtype == torch.float32 else np.float64)
    rows = []
    for i in range(4):
        acc = float(Mf[i, 0]) * r[0]
        for j in range(1, 4):
            acc = acc + float(Mf[i, j]) * r[j]
        rows.append(acc)
    return torch.stack(rows)


def lens_matrix(f1: float, f2: float) -> np.ndarray:
    L = np.eye(4)
    L[1, 0] = -1.0 / f1
    L[3, 2] = -1.0 / f2
    return L


def travel_matrix(d: float) -> np.ndarray:
    L = np.eye(4)
    L[0, 1] = d
    L[2, 3] = d
    return L


def lens(r, f1, f2):
    """Thin lens with focal lengths f1 (x) and f2 (y)."""
    return matvec(lens_matrix(f1, f2), r)


def sym_lens(r, f):
    """Axisymmetric thin lens."""
    return lens(r, f, f)


def travel(r, d):
    """Free-space propagation over distance d."""
    return matvec(travel_matrix(d), r)


def _kill(r, filt):
    """NaN-out the rays selected by ``filt`` (broadcast over rows)."""
    return torch.where(filt[None, :], torch.full_like(r, float("nan")), r)


def circular_aperture(r, R, E=None):
    """Reject rays outside radius R; with Jones vectors ``E`` (2, N), also
    turn theirs to NaN (NaN + 0j, as the JAX package) and return (r, E)."""
    filt = r[0] ** 2 + r[2] ** 2 > R**2
    if E is None:
        return _kill(r, filt)
    dead = torch.complex(torch.tensor(float("nan"), dtype=r.dtype),
                         torch.tensor(0.0, dtype=r.dtype)).to(r.device)
    return _kill(r, filt), torch.where(filt[None, :], dead, E)


def circular_stop(r, R):
    """Reject rays inside radius R (dark-field stop)."""
    return _kill(r, r[0] ** 2 + r[2] ** 2 < R**2)


def annular_stop(r, R1, R2):
    """Reject rays between radii R1 and R2."""
    rho2 = r[0] ** 2 + r[2] ** 2
    return _kill(r, (rho2 > R1**2) & (rho2 < R2**2))


def rect_aperture(r, Lx, Ly, exact: bool = False):
    """Reject rays outside the 2*Lx x 2*Ly rectangle.

    The default ANDs the two out-of-bounds tests, as the reference and the
    JAX package do (only the corners are clipped); ``exact=True`` ORs them.
    """
    out_x = r[0] ** 2 > Lx**2
    out_y = r[2] ** 2 > Ly**2
    return _kill(r, (out_x | out_y) if exact else (out_x & out_y))


def knife_edge(r, offset, axis: str = "y", direction: int = 1):
    """Knife edge along ``axis`` ('x' -> row 0, 'y' -> row 2)."""
    a = {"x": 0, "y": 2}[axis]
    if direction == 0:
        raise ValueError("direction must be > 0 or < 0")
    return _kill(r, r[a] > offset if direction > 0 else r[a] < offset)
