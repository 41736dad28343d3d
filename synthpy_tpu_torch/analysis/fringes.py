"""Interferogram fringe analysis: carrier-sideband phase extraction
(port of ``synthpy_tpu.analysis.fringes``).

Given a fringe image I = A + B cos(k_c . r + phi(r)), the Takeda FFT method
isolates the +k_c sideband, shifts it to DC and returns the wrapped phase
phi, the line-integrated plasma density map up to a constant. As in the
JAX package this runs in numpy (float64) on the host: every function takes
a tensor (on any device) or an array and returns numpy arrays.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _host(a) -> np.ndarray:
    """A tensor (any device) or array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def carrier_frequency(H) -> Tuple[int, int]:
    """Locate the fringe carrier peak in the 2-D spectrum (host-side).

    Returns integer frequency indices (fi, fj) of the strongest
    non-DC component in the upper half-plane.
    """
    F = np.fft.fft2(_host(H))
    mag = np.abs(F)
    ny, nx = mag.shape
    # mask the DC neighbourhood (wrapped 5x5)
    for di in (-2, -1, 0, 1, 2):
        for dj in (-2, -1, 0, 1, 2):
            mag[di % ny, dj % nx] = 0
    # keep one half-plane (the other holds the conjugate sideband):
    # rows ny//2.. are the negative-fi half; on the fi = 0 row keep only
    # positive fj
    mag[ny // 2 + 1:, :] = 0
    mag[0, nx // 2 + 1:] = 0
    fi, fj = np.unravel_index(np.argmax(mag), mag.shape)
    return int(fi), int(fj)


def extract_phase(
    H,
    carrier: Optional[Tuple[int, int]] = None,
    filter_radius: float = 0.5,
    return_amplitude: bool = False,
) -> np.ndarray:
    """Wrapped phase map from a fringe image (Takeda et al. 1982).

    Args:
        H: (ny, nx) interferogram.
        carrier: integer carrier frequency indices; auto-detected if None.
        filter_radius: sideband filter half-width as a fraction of the
            carrier frequency magnitude.
        return_amplitude: also return |analytic| — the local fringe
            (half-)modulation amplitude. Pixels where refraction has
            depleted the rays or folded fringes past Nyquist demodulate
            to garbage phase BUT near-zero amplitude, so this is the
            natural confidence weight for downstream fits (used by the
            tomography example's visibility-masked circular loss).

    Returns:
        (ny, nx) wrapped phase in (-pi, pi]; with ``return_amplitude``,
        the tuple ``(phase, amplitude)``.
    """
    H = np.asarray(_host(H), np.float64)
    ny, nx = H.shape
    if carrier is None:
        carrier = carrier_frequency(H)
    fi, fj = carrier

    F = np.fft.fft2(H - H.mean())
    # band-pass around the carrier
    wy = np.fft.fftfreq(ny)[:, None]
    wx = np.fft.fftfreq(nx)[None, :]
    cy = np.fft.fftfreq(ny)[fi]
    cx = np.fft.fftfreq(nx)[fj]
    rad = filter_radius * np.hypot(cy, cx)
    mask = ((wy - cy) ** 2 + (wx - cx) ** 2) < rad**2
    side = F * mask

    # shift carrier to DC by rolling the spectrum
    side = np.roll(np.roll(side, -fi, axis=0), -fj, axis=1)
    analytic = np.fft.ifft2(side)
    if return_amplitude:
        return np.angle(analytic), np.abs(analytic)
    return np.angle(analytic)


def unwrap_1d(phase, axis: int = -1) -> np.ndarray:
    """Simple 1-D phase unwrapping along an axis (numpy.unwrap wrapper)."""
    return np.unwrap(_host(phase), axis=axis)


def unwrap_2d(phase,
              anchor: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Sequential 2-D phase unwrapping for smooth maps.

    ``anchor=None``: unwrap the first column, then every row from its
    (now absolute) first element — exact whenever neighbouring-pixel
    true phase differences stay below pi, and absolute when the (0, 0)
    corner sits outside the phase object.

    ``anchor=(i0, j0)``: unwrap OUTWARD from that pixel — its row in
    both directions, then every column up and down from the row. Use
    this when the detector's margins carry no fringe power (a beam
    smaller than the detector): every unwrap path to an in-beam pixel
    then stays inside the beam, so the garbage phase of fringeless
    pixels cannot corrupt in-beam values. The result is offset by an
    unknown constant 2*pi*k (the anchor's own wrap count); rectify it
    against pixels of known true phase with
    :func:`rectify_phase_offset`. Not a quality-guided unwrapper — for
    noisy or undersampled fringes use a dedicated tool.
    """
    p = np.asarray(_host(phase), np.float64)
    if anchor is None:
        col0 = np.unwrap(p[:, 0])
        rows = np.unwrap(p, axis=1)
        return rows + (col0 - rows[:, 0])[:, None]

    i0, j0 = anchor
    row = np.empty(p.shape[1])
    row[j0:] = np.unwrap(p[i0, j0:])
    row[: j0 + 1] = np.unwrap(p[i0, j0::-1])[::-1]
    out = np.empty_like(p)
    out[i0:] = np.unwrap(np.vstack([row, p[i0 + 1:]]), axis=0)
    if i0 > 0:
        up = np.unwrap(np.vstack([row, p[i0 - 1::-1]]), axis=0)[1:]
        out[:i0] = up[::-1]
    return out


def rectify_phase_offset(unwrapped, zero_mask) -> np.ndarray:
    """Remove the global 2*pi*k offset of an anchored unwrap.

    ``zero_mask`` selects pixels whose TRUE phase is known to be ~0
    (e.g. an annulus at the beam edge, outside the phase object but
    still carrying fringes). The median unwrapped value there is
    rounded to the nearest multiple of 2*pi and subtracted everywhere.
    """
    unwrapped, zero_mask = _host(unwrapped), _host(zero_mask)
    med = float(np.median(unwrapped[zero_mask]))
    return unwrapped - 2.0 * np.pi * np.round(med / (2.0 * np.pi))


def phase_difference(H_shot, H_bkg,
                     carrier: Optional[Tuple[int, int]] = None,
                     return_visibility: bool = False,
                     ) -> np.ndarray:
    """Background-subtracted wrapped phase: the plasma-only contribution.

    Uses the background interferogram's carrier for both extractions so
    the reference tilt cancels exactly (the standard shot/bkg workflow the
    reference's Interferometry.bkg supports).

    ``return_visibility``: also return the shot's sideband amplitude
    normalised by the background's (a per-pixel fringe-visibility ratio
    in [0, ~1]); low values mark pixels whose phase is demodulation
    noise (refraction-depleted or Nyquist-folded fringes).
    """
    if carrier is None:
        carrier = carrier_frequency(H_bkg)
    p_shot, a_shot = extract_phase(H_shot, carrier, return_amplitude=True)
    p_bkg, a_bkg = extract_phase(H_bkg, carrier, return_amplitude=True)
    dphi = np.angle(np.exp(1j * (p_shot - p_bkg)))
    if return_visibility:
        return dphi, a_shot / (a_bkg + 1e-30 * a_bkg.max() + 1e-300)
    return dphi
