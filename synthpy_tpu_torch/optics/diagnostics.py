"""Synthetic diagnostics: optical trains and detectors (PyTorch port of
``synthpy_tpu.optics.diagnostics``).

``Shadowgraphy``, ``Polarimetry``, ``Schlieren`` (dark and light field),
``Refractometry`` (incoherent, coherent, Fresnel) and ``Interferometry``
on a shared ``Diagnostic`` base holding the bench geometry (lens scale L,
lens radius R, detector Lx x Ly in mm; the defaults model a KAF-8300
sensor behind f = L/2 optics). Ray positions are in mm on the bench
(converted from the tracer's metres on entry), the wavelength in metres.

The element chains run eagerly, element by element, through
``optics.rtm`` as in the JAX package. The detectors bin through
``ops.histogram``: on CUDA tensors ``histogram`` and ``polarogram``
launch K3's ``bin_image`` and ``coherent_histogram`` its ``bin_field``
(``kernels.binning``); ``fresnel_solve`` deposits by K8
(``kernels.deposit``) and propagates through ``torch.fft``. Everything
runs on the device of ``rf`` when it is a tensor, else on ``device``
(default ``"cuda"``); pass CPU tensors or ``device="cpu"`` for the plain
versions on the host.

The JAX package's deliberate deviations from the reference are kept:
``propagate_E`` converts the transverse path to metres (unless
``legacy_mm_wavenumber``), coherent binning is symmetric about 0,
``Interferometry.bkg`` synthesises the unperturbed beam, and
``fresnel_solve`` stores the intensity on the deposition grid.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from synthpy_tpu_torch import _device
from synthpy_tpu_torch import random as jrandom
from synthpy_tpu_torch.ops import fresnel as fresnel_ops
from synthpy_tpu_torch.ops.histogram import complex_histogram, histogram2d
from synthpy_tpu_torch.optics import compose
from synthpy_tpu_torch.optics.rtm import (circular_aperture, circular_stop,
                                          lens, m_to_mm, rect_aperture,
                                          sym_lens, travel)


def _on(v, dev: torch.device):
    """``v`` (a tensor, or anything ``np.asarray`` takes) on ``dev``."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return torch.from_numpy(np.array(v)).to(dev)


class Diagnostic:
    """Base class: bench geometry, detector, and E-field bookkeeping.

    Args:
        wavelength: probe wavelength [m].
        rf: (4, N) exit rays [x, theta, y, phi] in metres / radians.
        Jf: optional (2, N) complex Jones vectors (coherent diagnostics).
        focal_plane: object-plane offset [mm].
        L: bench length scale [mm]; the first lens sits at L.
        R: lens radius [mm].
        Lx, Ly: detector size [mm] (KAF-8300: 18 x 13.5).
        x, y, x_l, y_l, amp, phase: the deposition grid (node coordinates
            in mm), its side lengths [m] and the per-ray amplitude and
            phase of the Fresnel refractometer.
        legacy_mm_wavenumber: multiply the wavenumber by the path in mm in
            ``propagate_E``, as the reference does (phases 1e3 too large).
        device: where to run when ``rf`` is not a tensor (default
            ``"cuda"``); a tensor ``rf`` keeps its device.
    """

    def __init__(self, wavelength, rf, Jf=None, *, focal_plane: float = 0,
                 L: float = 400, R: float = 25, Lx: float = 18,
                 Ly: float = 13.5, x=None, y=None, x_l=None, y_l=None,
                 amp=None, phase=None, legacy_mm_wavenumber: bool = False,
                 device=None):
        if rf is None:
            raise ValueError("rf must not be None")
        if device is not None:
            dev = _device.resolve(device)
        elif isinstance(rf, torch.Tensor):
            dev = rf.device
        else:
            dev = _device.resolve("cuda")
        self.device = dev
        self.wavelength = wavelength
        self.focal_plane, self.L, self.R = focal_plane, L, R
        self.Lx, self.Ly = Lx, Ly
        self.x, self.y = _on(x, dev), _on(y, dev)
        self.x_l, self.y_l = x_l, y_l
        self.amp, self.phase = _on(amp, dev), _on(phase, dev)
        self.legacy_mm_wavenumber = legacy_mm_wavenumber

        self.Jf = _on(Jf, dev)
        self.r0 = m_to_mm(_on(rf, dev))
        self.rf = self.r0
        self.H = None
        self.xedges = None
        self.yedges = None

    # -- E-field propagation between elements --------------------------------

    def propagate_E(self, r1, r0):
        """Advance the Jones phases by k |transverse path| between two
        planes: the path (in m, or mm with ``legacy_mm_wavenumber``) in
        the rays' dtype, its phase f32(k) * path for float32 rays."""
        scale = 1.0 if self.legacy_mm_wavenumber else 1e-3  # mm -> m
        dx = (r1[0] - r0[0]) * scale
        dy = (r1[2] - r0[2]) * scale
        k = 2 * math.pi / self.wavelength
        theta = torch.sqrt(dx**2 + dy**2) * k
        self.Jf = self.Jf * torch.complex(torch.cos(theta), torch.sin(theta))

    # -- detectors ------------------------------------------------------------

    def _range(self):
        return ((-self.Lx / 2, self.Lx / 2), (-self.Ly / 2, self.Ly / 2))

    def histogram(self, bin_scale: int = 1, pix_x: int = 3448,
                  pix_y: int = 2574, clear_mem: bool = False):
        """Incoherent ray-count detector image, (pix_y // bin_scale,
        pix_x // bin_scale)."""
        self.H, self.xedges, self.yedges = histogram2d(
            self.rf[0], self.rf[2],
            bins=(pix_x // bin_scale, pix_y // bin_scale),
            range_=self._range())
        if clear_mem:
            self.clear_rays()
        return self.H

    def coherent_histogram(self, bin_scale: int = 1, pix_x: int = 3448,
                           pix_y: int = 2574, clear_mem: bool = False,
                           convention: str = "legacy"):
        """Coherent complex-amplitude detector image in
        ``complex_histogram``'s layout (pix // bin_scale edges an axis):
        ``"legacy"`` is the reference's sqrt(Re^2 + Re^2) amplitude,
        ``"intensity"`` |sum a|^2."""
        if self.Jf is None:
            raise RuntimeError("coherent detector requires Jones vectors")
        self.H = complex_histogram(
            self.rf[0], self.rf[2], self.Jf[0], self.Jf[1],
            pix_x // bin_scale, pix_y // bin_scale, self.Lx, self.Ly,
            convention=convention)
        if clear_mem:
            self.clear_rays()
        return self.H

    # kept under the reference's name
    histogram_legacy = coherent_histogram

    def plot(self, ax, clim=None, cmap=None):
        extent = None
        if self.xedges is not None:
            extent = [float(self.xedges[0]), float(self.xedges[-1]),
                      float(self.yedges[0]), float(self.yedges[-1])]
        return ax.imshow(self.H.detach().cpu().numpy(),
                         interpolation="nearest", origin="lower", clim=clim,
                         cmap=cmap, extent=extent)

    def clear_rays(self):
        self.r0 = None
        self.rf = None
        self.Jf = None


class Shadowgraphy(Diagnostic):
    """Shadowgraphy bench."""

    def single_lens_solve(self):
        """Single lens, M ~ 2 (the real experimental layout)."""
        r1 = travel(self.r0, 3 * self.L / 4 - self.focal_plane)
        r2 = circular_aperture(r1, self.R)
        r3 = sym_lens(r2, self.L / 2)
        self.rf = travel(r3, 3 * self.L / 2)
        return self.rf

    def two_lens_solve(self):
        """Two-lens telescope, M = 1."""
        r1 = travel(self.r0, self.L - self.focal_plane)
        r2 = circular_aperture(r1, self.R)
        r3 = sym_lens(r2, self.L / 2)
        r4 = travel(r3, self.L * 2)
        r5 = circular_aperture(r4, self.R)
        r6 = sym_lens(r5, self.L / 2)
        self.rf = travel(r6, self.L)
        return self.rf

    def single_exp_solve(self, detL: float = 400):
        """Single lens with a variable detector arm (object plane at L, no
        focal_plane offset)."""
        r1 = travel(self.r0, self.L)
        r2 = circular_aperture(r1, self.R)
        r3 = sym_lens(r2, self.L / 2)
        self.rf = travel(r3, detL)
        return self.rf

    solve = single_lens_solve


class Polarimetry(Diagnostic):
    """Faraday-rotation imaging polarimeter: the M = 1 telescope with a
    linear analyser in front of the detector, a per-ray intensity weight
    |Jx sin(beta) + Jy cos(beta)|^2 at binning time (beta = 90 deg is
    crossed)."""

    def two_lens_solve(self):
        """M = 1 imaging telescope (the shadowgraphy train)."""
        r1 = travel(self.r0, self.L - self.focal_plane)
        r2 = circular_aperture(r1, self.R)
        r3 = sym_lens(r2, self.L / 2)
        r4 = travel(r3, self.L * 2)
        r5 = circular_aperture(r4, self.R)
        r6 = sym_lens(r5, self.L / 2)
        self.rf = travel(r6, self.L)
        return self.rf

    solve = two_lens_solve

    def polarogram(self, beta_deg: float = 85.0, bin_scale: int = 1,
                   pix_x: int = 3448, pix_y: int = 2574,
                   clear_mem: bool = False):
        """Analyser-weighted detector image at analyser angle
        ``beta_deg`` (a weighted incoherent histogram: linear in rays)."""
        if self.Jf is None:
            raise RuntimeError("polarogram requires Jones vectors "
                               "(trace with return_E=True and B_on)")
        w = compose.analyser_weight(self.Jf, beta_deg).to(self.rf.dtype)
        self.H, self.xedges, self.yedges = histogram2d(
            self.rf[0], self.rf[2],
            bins=(pix_x // bin_scale, pix_y // bin_scale),
            range_=self._range(), weights=w)
        if clear_mem:
            self.clear_rays()
        return self.H


class Schlieren(Diagnostic):
    """Dark- and light-field schlieren bench."""

    def DF_solve(self, R: float = 1):
        """Dark field: a stop of radius R at the first lens's focal plane
        blocks undeflected rays."""
        r1 = travel(self.r0, self.L - self.focal_plane)
        r2 = circular_aperture(r1, self.R)
        r3 = sym_lens(r2, self.L)
        r4 = travel(r3, self.L)
        r5 = circular_stop(r4, R=R)
        r6 = travel(r5, self.L)
        r7 = circular_aperture(r6, self.R)
        r8 = sym_lens(r7, self.L)
        self.rf = travel(r8, self.L)
        return self.rf

    def LF_solve(self, R: float = 1):
        """Light field: an aperture instead of the stop passes only
        undeflected rays."""
        r1 = travel(self.r0, self.L - self.focal_plane)
        r2 = circular_aperture(r1, self.R)
        r3 = sym_lens(r2, self.L)
        r4 = travel(r3, self.L)
        r5 = circular_aperture(r4, R)
        r6 = travel(r5, self.L)
        r7 = circular_aperture(r6, self.R)
        r8 = sym_lens(r7, self.L)
        self.rf = travel(r8, self.L)
        return self.rf

    solve = DF_solve


class Refractometry(Diagnostic):
    """Imaging refractometer: a spherical lens, then a hybrid astigmatic
    lens (the spatial axis imaged, the angular axis dispersed)."""

    def incoherent_solve(self):
        r1 = travel(self.r0, 3 * self.L / 4 - self.focal_plane)
        r2 = circular_aperture(r1, self.R)
        r3 = sym_lens(r2, self.L / 2)
        r4 = travel(r3, 3 * self.L / 2)
        r5 = rect_aperture(r4, 15, 30)
        r6 = circular_aperture(r5, self.R)
        r7 = lens(r6, self.L / 3, self.L / 2)
        self.rf = travel(r7, self.L)
        return self.rf

    def coherent_solve(self):
        """As ``incoherent_solve``, advancing the Jones phase between
        elements (no rectangular aperture, as in the JAX package)."""
        r1 = travel(self.r0, 3 * self.L / 4 - self.focal_plane)
        r2, self.Jf = circular_aperture(r1, self.R, E=self.Jf)
        self.propagate_E(r2, r1)
        r3 = sym_lens(r2, self.L / 2)
        self.propagate_E(r3, r2)
        r4 = travel(r3, 3 * self.L / 2)
        self.propagate_E(r4, r3)
        r5, self.Jf = circular_aperture(r4, self.R, E=self.Jf)
        r6 = lens(r5, self.L / 3, self.L / 2)
        self.propagate_E(r6, r5)
        self.rf = travel(r6, self.L)
        self.propagate_E(self.rf, r6)
        return self.rf

    def refractogram(self, bin_scale: int = 1, pix_x: int = 3448,
                     pix_y: int = 2574, clear_mem: bool = False,
                     speckle_phase: float = 0.0,
                     key=None,
                     convention: str = "legacy"):
        """Coherent refractogram. ``speckle_phase`` > 0 multiplies each
        ray's field by exp(i speckle_phase g), g standard normal drawn
        from ``key``: a key of ``synthpy_tpu_torch.random`` draws the JAX
        package's threefry stream (float32, as JAX draws it); a
        ``torch.Generator`` on the rays' device (default: one seeded with
        0) draws PyTorch's."""
        if speckle_phase > 0.0:
            if key is None:
                key = torch.Generator(self.device).manual_seed(0)
            if isinstance(key, torch.Generator):
                g = torch.randn(self.Jf.shape[1:], generator=key,
                                device=self.device,
                                dtype=self.Jf.real.dtype)
            else:
                g = jrandom.normal(key, self.Jf.shape[1:],
                                   device=self.device).to(
                    self.Jf.real.dtype)
            theta = g * speckle_phase
            self.Jf = self.Jf * torch.complex(torch.cos(theta),
                                              torch.sin(theta))
        return self.coherent_histogram(bin_scale=bin_scale, pix_x=pix_x,
                                       pix_y=pix_y, clear_mem=clear_mem,
                                       convention=convention)

    def fresnel_solve(self, z: Optional[float] = None, pad_factor: int = 2):
        """Full-wave hybrid: deposit the per-ray amplitude and phase on the
        (x, y) grid (K8 on the card), Fresnel-propagate a distance z [m]
        (default the first travel, 3 L / 4 - focal_plane, in m) and keep
        the field as ``U`` and its intensity as ``H`` (grid layout)."""
        if any(v is None for v in (self.x, self.y, self.x_l, self.y_l,
                                   self.amp, self.phase)):
            raise RuntimeError(
                "fresnel_solve needs x, y, x_l, y_l, amp, phase at init")
        if z is None:
            z = (3 * self.L / 4 - self.focal_plane) * 1e-3
        U = fresnel_ops.propagate(
            self.wavelength, self.x, self.y, self.x_l, self.y_l,
            self.r0, self.amp, self.phase, z, pad_factor=pad_factor)
        self.U = U
        self.H = U.abs() ** 2
        return self.H

    def resample_to_detector(self, bin_scale: int = 1, pix_x: int = 3448,
                             pix_y: int = 2574):
        """Bilinear resample of the Fresnel intensity (on the deposition
        grid, indexed H[ix, iy]) onto the (ny, nx) detector pixels of
        ``histogram``; pixels outside the grid read 0."""
        if self.H is None or self.x is None or self.y is None:
            raise RuntimeError("run fresnel_solve first")
        dev = self.H.device
        nx_px, ny_px = pix_x // bin_scale, pix_y // bin_scale

        def centres(n, length):
            a = torch.arange(n, dtype=torch.float32, device=dev)
            return ((a + 0.5) / torch.tensor(float(n), device=dev) - 0.5) \
                * length

        xq, yq = centres(nx_px, self.Lx), centres(ny_px, self.Ly)
        tx = (xq - self.x[0]) / (self.x[1] - self.x[0])
        ty = (yq - self.y[0]) / (self.y[1] - self.y[0])
        nx_g, ny_g = self.H.shape
        TX, TY = torch.meshgrid(tx, ty, indexing="xy")   # (ny_px, nx_px)
        valid = ((TX >= 0) & (TX <= nx_g - 1) & (TY >= 0)
                 & (TY <= ny_g - 1))
        ix = torch.floor(TX).nan_to_num(0.0).clamp(0, nx_g - 2)
        iy = torch.floor(TY).nan_to_num(0.0).clamp(0, ny_g - 2)
        fx = (TX - ix).clamp(0.0, 1.0)
        fy = (TY - iy).clamp(0.0, 1.0)
        ix, iy = ix.long(), iy.long()
        H = self.H
        img = ((1 - fx) * (1 - fy) * H[ix, iy]
               + fx * (1 - fy) * H[ix + 1, iy]
               + (1 - fx) * fy * H[ix, iy + 1]
               + fx * fy * H[ix + 1, iy + 1])
        return torch.where(valid, img, torch.zeros_like(img))


class Interferometry(Diagnostic):
    """Mach-Zehnder-style interferometry."""

    def interfere_ref_beam(self, n_fringes: float, deg: float):
        """Add a tilted plane-wave reference beam to the y polarisation:
        ``deg`` is the fringe angle from vertical (with the reference's
        deg >= 45 flip), ``n_fringes`` sets the fringe frequency
        2 n_fringes / 3 rad/mm on the detector."""
        if self.Jf is None:
            raise RuntimeError("interferometry requires Jones vectors")
        self.Jf = compose.interfere_ref_beam(self.rf, self.Jf, n_fringes,
                                             deg)
        return self.Jf

    def two_lens_solve(self, n_fringes: float = 10, deg: float = 20,
                       interfere: bool = True):
        """Recombine with the reference beam at the domain exit, then image
        through the M = 1 telescope with phase propagation."""
        if interfere:
            self.interfere_ref_beam(n_fringes, deg)
        r1 = travel(self.r0, self.L - self.focal_plane)
        self.propagate_E(r1, self.r0)
        r2, self.Jf = circular_aperture(r1, self.R, E=self.Jf)
        r3 = sym_lens(r2, self.L / 2)
        self.propagate_E(r3, r2)
        r4 = travel(r3, self.L * 2)
        self.propagate_E(r4, r3)
        r5, self.Jf = circular_aperture(r4, self.R, E=self.Jf)
        r6 = sym_lens(r5, self.L / 2)
        self.propagate_E(r6, r5)
        r7 = travel(r6, self.L)
        self.propagate_E(r7, r6)
        self.rf = r7
        return self.rf

    def bkg(self, n_fringes: float = 10, deg: float = 20,
            bin_scale: int = 1, pix_x: int = 3448, pix_y: int = 2574):
        """Background fringe pattern: the same bench fed with
        unit-amplitude, zero-phase light at the same ray positions."""
        E_saved, rf_saved = self.Jf, self.rf
        n = self.r0.shape[1]
        self.rf = self.r0
        self.Jf = torch.stack([
            torch.zeros(n, dtype=torch.complex64, device=self.device),
            torch.ones(n, dtype=torch.complex64, device=self.device)])
        self.two_lens_solve(n_fringes=n_fringes, deg=deg)
        self.coherent_histogram(bin_scale=bin_scale, pix_x=pix_x,
                                pix_y=pix_y)
        self.bkg_signal = self.H
        self.Jf, self.rf = E_saved, rf_saved
        return self.bkg_signal

    def interferogram(self, bin_scale: int = 1, pix_x: int = 3448,
                      pix_y: int = 2574, clear_mem: bool = False,
                      convention: str = "legacy"):
        return self.coherent_histogram(bin_scale=bin_scale, pix_x=pix_x,
                                       pix_y=pix_y, clear_mem=clear_mem,
                                       convention=convention)
