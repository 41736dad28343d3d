"""Precomposed optical trains (PyTorch port of ``synthpy_tpu.optics.compose``).

Each run of lens/travel elements is folded on the host (numpy) into one
4x4 ABCD matrix; filters stay separate stages. Two coherent bookkeeping
stages carry the Jones field ``E`` of the coherent benches: ("phase",)
advances it by k |transverse path| since the last checkpoint (lenses and
apertures do not move rays, so only the travels count) and ("mark",)
moves the checkpoint without adding phase. ``apply_stages(..., E=)`` is
the plain version of the coherent detector kernel's stage loop
(``kernels.detector.detect_field``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from synthpy_tpu_torch import _device
from synthpy_tpu_torch.optics import rtm

MATRIX_ELEMENTS = ("lens", "sym_lens", "travel")


def element_matrix(element: Tuple) -> np.ndarray:
    """4x4 ABCD matrix of a non-filtering element (host-side, numpy)."""
    kind = element[0]
    if kind == "travel":
        return rtm.travel_matrix(element[1])
    if kind == "lens":
        return rtm.lens_matrix(element[1], element[2])
    if kind == "sym_lens":
        return rtm.lens_matrix(element[1], element[1])
    raise ValueError(f"{kind!r} is not a matrix element")


def compose(elements: Sequence[Tuple]) -> List[Tuple]:
    """Fold consecutive matrix elements into single ("matrix", M) stages,
    in application order."""
    stages: List[Tuple] = []
    acc = None
    for el in elements:
        if el[0] in MATRIX_ELEMENTS:
            M = element_matrix(el)
            acc = M if acc is None else M @ acc
        else:
            if acc is not None:
                stages.append(("matrix", acc))
                acc = None
            stages.append(el)
    if acc is not None:
        stages.append(("matrix", acc))
    return stages


def apply_stages(r: torch.Tensor, stages: Sequence[Tuple],
                 E: Optional[torch.Tensor] = None,
                 wavelength: Optional[float] = None):
    """Apply a composed stage list to (4, N) rays [mm]; filters NaN the
    rays they stop. With (2, N) complex Jones vectors ``E``, returns
    (r, E): apertures NaN E too, and ("phase",) stages, which need
    ``wavelength`` [m], advance it."""
    r_mark = r
    for st in stages:
        kind = st[0]
        if kind == "matrix":
            r = rtm.matvec(st[1], r)
        elif kind == "mark":
            r_mark = r
        elif kind == "phase":
            if E is None or wavelength is None:
                raise ValueError("a ('phase',) stage needs E and wavelength")
            E = advance_phase(E, r, r_mark, wavelength)
            r_mark = r
        elif kind == "aperture":
            if E is not None:
                r, E = rtm.circular_aperture(r, st[1], E=E)
            else:
                r = rtm.circular_aperture(r, st[1])
        elif kind == "stop":
            r = rtm.circular_stop(r, st[1])
        elif kind == "rect":
            r = rtm.rect_aperture(r, st[1], st[2])
        elif kind == "knife":
            r = rtm.knife_edge(r, st[1], st[2], st[3])
        else:
            raise ValueError(f"unknown stage {kind!r}")
    if E is not None:
        return r, E
    return r


def advance_phase(E: torch.Tensor, r: torch.Tensor, r_mark: torch.Tensor,
                  wavelength: float) -> torch.Tensor:
    """E * exp(i k path), path the transverse distance [m] from the
    checkpoint rays ``r_mark`` to ``r`` [mm], k = 2 pi / wavelength in r's
    dtype. The product is written out in real arithmetic, so that CUDA
    rounds it as the CPU does, and the norm is the JAX package's safe one
    (0 for a ray that did not move)."""
    k = 2.0 * np.pi / wavelength
    if r.dtype == torch.float32:
        k = float(np.float32(k))
    dx = (r[0] - r_mark[0]) * 1e-3
    dy = (r[2] - r_mark[2]) * 1e-3
    d2 = dx * dx + dy * dy
    pos = d2 > 0
    path = torch.where(pos, torch.sqrt(torch.where(pos, d2,
                                                   torch.ones_like(d2))),
                       torch.zeros_like(d2))
    kp = k * path
    c, s = torch.cos(kp), torch.sin(kp)
    re, im = E.real, E.imag
    return torch.complex(re * c - im * s, re * s + im * c)


def ref_beam(n_fringes: float, deg: float, dtype=np.float32):
    """(2 n_fringes / 3, cos(rad), sin(rad)) of the tilted reference beam,
    in ``dtype``, with the reference's deg >= 45 flip."""
    if deg >= 45:
        deg = -abs(deg - 90)
    rad = dtype(deg * np.pi / 180.0)
    return (float(dtype(2 * n_fringes / 3)), float(np.cos(rad)),
            float(np.sin(rad)))


def interfere_ref_beam(r_mm: torch.Tensor, Jf: torch.Tensor,
                       n_fringes: float, deg: float) -> torch.Tensor:
    """Add the reference exp(i (2 n_fringes / 3) (cos(rad) x + sin(rad)
    y)) to the y polarisation (x, y in mm; ``ref_beam``)."""
    fr, cr, sr = ref_beam(n_fringes, deg, np.float32
                          if r_mm.dtype == torch.float32 else np.float64)
    arg = fr * (cr * r_mm[0] + sr * r_mm[2])
    out = Jf.clone()
    out[1] = Jf[1] + torch.complex(torch.cos(arg), torch.sin(arg))
    return out


def analyser_weight(Jf: torch.Tensor, beta_deg: float,
                    dtype=None) -> torch.Tensor:
    """Per-ray intensity |Jx sin(beta) + Jy cos(beta)|^2 behind a linear
    analyser at ``beta_deg``. The angle is held in ``dtype`` (float32 or
    float64), by default in the real dtype of ``Jf`` (as the JAX package
    takes it in its default float); a float64 angle with float32 Jones
    vectors gives a float64 weight, as JAX's type promotion does."""
    if dtype is None:
        f = np.float64 if Jf.dtype == torch.complex128 else np.float32
    else:
        dt = _device.torch_dtype(dtype)
        if dt not in (torch.float32, torch.float64):
            raise ValueError(f"dtype={dtype!r}: the analyser angle is "
                             "float32 or float64 (ROADMAP C.10)")
        f = np.float64 if dt == torch.float64 else np.float32
        if f is np.float64:
            Jf = Jf.to(torch.complex128)
    beta = f(np.deg2rad(f(beta_deg)))
    # sin and cos in the angle's type, as JAX computes them
    t = Jf[0] * float(f(np.sin(beta))) + Jf[1] * float(f(np.cos(beta)))
    return t.real**2 + t.imag**2


# -- the standard benches (geometry identical to the JAX package) ----------

def shadowgraphy_two_lens(L: float = 400, R: float = 25,
                          focal_plane: float = 0) -> List[Tuple]:
    return compose([
        ("travel", L - focal_plane), ("aperture", R), ("sym_lens", L / 2),
        ("travel", 2 * L), ("aperture", R), ("sym_lens", L / 2),
        ("travel", L),
    ])


def shadowgraphy_single_lens(L: float = 400, R: float = 25,
                             focal_plane: float = 0) -> List[Tuple]:
    return compose([
        ("travel", 3 * L / 4 - focal_plane), ("aperture", R),
        ("sym_lens", L / 2), ("travel", 3 * L / 2),
    ])


def schlieren_df(L: float = 400, R: float = 25, stop_R: float = 1,
                 focal_plane: float = 0) -> List[Tuple]:
    return compose([
        ("travel", L - focal_plane), ("aperture", R), ("sym_lens", L),
        ("travel", L), ("stop", stop_R), ("travel", L), ("aperture", R),
        ("sym_lens", L), ("travel", L),
    ])


def refractometer(L: float = 400, R: float = 25,
                  focal_plane: float = 0) -> List[Tuple]:
    return compose([
        ("travel", 3 * L / 4 - focal_plane), ("aperture", R),
        ("sym_lens", L / 2), ("travel", 3 * L / 2), ("rect", 15, 30),
        ("aperture", R), ("lens", L / 3, L / 2), ("travel", L),
    ])


def shadowgraphy_single_exp(L: float = 400, R: float = 25,
                            detL: float = 400,
                            focal_plane: float = 0) -> List[Tuple]:
    """Single lens with a variable detector arm; ``focal_plane`` is unused
    and kept for a uniform signature."""
    return compose([
        ("travel", L), ("aperture", R), ("sym_lens", L / 2),
        ("travel", detL),
    ])


def schlieren_lf(L: float = 400, R: float = 25, aperture_R: float = 1,
                 focal_plane: float = 0) -> List[Tuple]:
    """Light-field schlieren: an aperture at the focal plane passes only
    undeflected rays."""
    return compose([
        ("travel", L - focal_plane), ("aperture", R), ("sym_lens", L),
        ("travel", L), ("aperture", aperture_R), ("travel", L),
        ("aperture", R), ("sym_lens", L), ("travel", L),
    ])


def interferometry_two_lens(L: float = 400, R: float = 25,
                            focal_plane: float = 0) -> List[Tuple]:
    """M = 1 telescope with per-travel Jones phase advance (coherent)."""
    return compose([
        ("travel", L - focal_plane), ("phase",),
        ("aperture", R),
        ("sym_lens", L / 2), ("travel", 2 * L), ("phase",),
        ("aperture", R),
        ("sym_lens", L / 2), ("travel", L), ("phase",),
    ])


def polarimetry_two_lens(L: float = 400, R: float = 25,
                         focal_plane: float = 0) -> List[Tuple]:
    """The two-lens imaging telescope; the analyser is a per-ray detector
    weight (``analyser_weight``), not a ray-transfer element."""
    return shadowgraphy_two_lens(L=L, R=R, focal_plane=focal_plane)


def refractometer_coherent(L: float = 400, R: float = 25,
                           focal_plane: float = 0) -> List[Tuple]:
    """Coherent imaging refractometer (coherent)."""
    return compose([
        ("travel", 3 * L / 4 - focal_plane), ("mark",),
        ("aperture", R),
        ("sym_lens", L / 2), ("travel", 3 * L / 2), ("phase",),
        ("aperture", R),
        ("lens", L / 3, L / 2), ("travel", L), ("phase",),
    ])


# Benches that are incoherent but read the Jones vectors for a per-ray
# detector weight.
NEEDS_JONES = frozenset({"polarimetry"})

# name -> (builder, coherent), keyed like the JAX package's BENCHES
BENCHES = {
    "shadowgraphy": (shadowgraphy_two_lens, False),
    "shadowgraphy_single": (shadowgraphy_single_lens, False),
    "shadowgraphy_exp": (shadowgraphy_single_exp, False),
    "schlieren_df": (schlieren_df, False),
    "schlieren_lf": (schlieren_lf, False),
    "refractometry": (refractometer, False),
    "refractometry_coherent": (refractometer_coherent, True),
    "interferometry": (interferometry_two_lens, True),
    "polarimetry": (polarimetry_two_lens, False),
}
