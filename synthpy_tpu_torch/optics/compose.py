"""Precomposed optical trains (PyTorch port of ``synthpy_tpu.optics.compose``).

Each run of lens/travel elements is folded on the host (numpy) into one
4x4 ABCD matrix; filters stay separate stages. ``apply_stages`` runs the
incoherent path; the coherent bookkeeping stages ("phase", "mark") belong
to the coherent detectors, which are not ported yet (ROADMAP A.6).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

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


def apply_stages(r: torch.Tensor, stages: Sequence[Tuple]) -> torch.Tensor:
    """Apply a composed stage list to (4, N) rays [mm]; filters NaN the
    rays they stop."""
    for st in stages:
        kind = st[0]
        if kind == "matrix":
            r = rtm.matvec(st[1], r)
        elif kind == "aperture":
            r = rtm.circular_aperture(r, st[1])
        elif kind == "stop":
            r = rtm.circular_stop(r, st[1])
        elif kind == "rect":
            r = rtm.rect_aperture(r, st[1], st[2])
        elif kind == "knife":
            r = rtm.knife_edge(r, st[1], st[2], st[3])
        elif kind in ("phase", "mark"):
            raise NotImplementedError(
                "coherent stages are not ported yet (ROADMAP A.6)")
        else:
            raise ValueError(f"unknown stage {kind!r}")
    return r


def analyser_weight(Jf: torch.Tensor, beta_deg: float) -> torch.Tensor:
    """Per-ray intensity |Jx sin(beta) + Jy cos(beta)|^2 behind a linear
    analyser at ``beta_deg``."""
    beta = float(np.deg2rad(np.float32(beta_deg)))
    t = Jf[0] * np.sin(beta) + Jf[1] * np.cos(beta)
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
