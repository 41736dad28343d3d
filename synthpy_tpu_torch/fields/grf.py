"""Gaussian-random-field generators for turbulent electron density (PyTorch
port of ``synthpy_tpu.fields.grf``).

Three families per dimensionality, as in the JAX package:

* ``grf_fft``: Timmer & Koenig power-law noise on a (2N+1)^d grid with the
  flip-based Hermitian symmetrisation;
* ``grf_domain_fft``: a band-limited spectrum, non-zero for k in
  [2 pi / l_max, 2 pi / l_min], normalised to max |f| = 1, with an
  optional stretch of the last axis;
* ``grf_cos_1d/2d/3d``: randomised cosine-mode sums, the mode sum made
  separable per axis by the angle-addition identity and contracted with
  ``torch.einsum`` / matmuls.

The noise is drawn from the caller's key with JAX's threefry stream
(``synthpy_tpu_torch.random``: kernel K10 on the card), so the same key
gives the JAX package's field, to the order of the FFT and contraction
sums and the normals' last few places. FFTs run on ``torch.fft`` (cuFFT on
the card). Generators take ``device=`` (default ``"cuda"``).
``grf_domain_fft(mesh=)`` synthesises the field split over a mesh axis,
never whole on one device (a pencil FFT with the mesh's all-to-alls).
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from synthpy_tpu_torch import _device
from synthpy_tpu_torch import random as jrandom
from synthpy_tpu_torch.kernels import random as _krandom
from synthpy_tpu_torch.ops import dft


def kolmogorov(k):
    """E(k) ~ k^-5/3."""
    return k ** (-5.0 / 3.0)


def power_law(p: float) -> Callable:
    """E(k) ~ k^-p."""
    return lambda k: k ** (-p)


def _safe_spectrum(k_func, k: torch.Tensor) -> torch.Tensor:
    """E(k) with E(0) := 0 (the DC mode is always zeroed)."""
    k_safe = torch.where(k > 0, k, torch.ones_like(k))
    S = torch.where(k > 0, k_func(k_safe), torch.zeros_like(k))
    return torch.clamp_min(S, 0.0)


def grf_fft(key, N: int, k_func: Callable, ndim: int = 3, d: float = 1.0,
            device="cuda") -> torch.Tensor:
    """Power-law GRF on a (2N+1)^ndim grid: |k| from fftfreq (cycles),
    fftshifted; Gaussian white noise symmetrised as W_r + flip(W_r),
    W_i - flip(W_i); the spectrum applied as sqrt(E); DC zeroed; the real
    part of the inverse FFT."""
    dev = _device.resolve(device)
    M = 2 * N + 1
    k1 = dft.fftfreq(M, d, device=dev)
    grids = torch.meshgrid(*([k1] * ndim), indexing="ij")
    K = torch.sqrt(sum(g**2 for g in grids))
    K = torch.fft.fftshift(K)
    kr, ki = jrandom.split(key)
    shape = (M,) * ndim
    amp = torch.sqrt(_safe_spectrum(k_func, K))
    Wr, Wi = (w.reshape(shape) for w in _krandom.draw_many(
        [jrandom.key_data(kr), jrandom.key_data(ki)], M ** ndim,
        ["normal", "normal"], device=dev))
    dims = tuple(range(ndim))
    Wr = Wr + torch.flip(Wr, dims)
    Wi = Wi - torch.flip(Wi, dims)
    F = torch.complex(Wr, Wi) * amp
    F = torch.fft.ifftshift(F)
    F[(0,) * ndim] = 0.0
    return dft.ifftn(F).real


def _band_amplitude(k_func: Callable, ks, k_min: float,
                    k_max: float) -> torch.Tensor:
    """sqrt of the band-limited spectrum on the grid of the 1-D wave
    vectors ``ks`` (|k| by broadcasting, never ndim full meshgrids)."""
    ndim = len(ks)
    k2 = sum(kv.reshape((1,) * i + (-1,) + (1,) * (ndim - 1 - i)) ** 2
             for i, kv in enumerate(ks))
    k = torch.sqrt(k2).to(torch.float32)
    S = torch.where((k >= k_min) & (k <= k_max), _safe_spectrum(k_func, k),
                    torch.zeros_like(k))
    return torch.sqrt(S)


def grf_domain_fft(key, k_func: Callable, l_max: float, l_min: float,
                   extent: float, res: int, factor: float = 1.0,
                   ndim: int = 3, mesh=None, mesh_axis: str = "grid",
                   device="cuda"):
    """Band-limited GRF over [-extent, extent)^ndim: the spectrum is
    k_func(k) for k in [2 pi / l_max, 2 pi / l_min] and zero outside; the
    field is normalised to max |f| = 1. For ndim == 3 the last axis is
    stretched by ``factor``. Returns (coords, field), the coordinates on
    ``device``.

    ``mesh`` (a ``parallel.Mesh``): the field is a ``parallel.Sharded`` of
    axis-0 row blocks over ``mesh_axis``, each on its shard's device (the
    JAX package's sharded jit), equal to the single-device field to the
    order of the FFT sums. Each shard draws its rows of the complex noise
    (one K10 launch at the rows' flat offset: the bits of an index do not
    depend on the split) and transforms them along axes 1.. with
    ``torch.fft``; an all-to-all splits the blocks along axis 1 for the
    transform along axis 0, and a second brings the real part back to
    axis-0 blocks, divided by the max |f| over the axis. No device holds
    the whole field. Needs ndim >= 2 and axes 0 and 1 dividing over the
    axis."""
    dev = _device.resolve(device)
    dx = extent / res
    n = 2 * res
    coords, ks = [], []
    for axis in range(ndim):
        stretch = factor if (ndim == 3 and axis == 2) else 1.0
        n_ax = int(n * stretch)
        lo = -extent * stretch
        step = (extent * stretch - lo) / n_ax
        coords.append((lo + torch.arange(n_ax, dtype=torch.float64,
                                         device=dev) * step).to(
            torch.float32))
        ks.append(2 * math.pi * dft.fftfreq(n_ax, d=dx, device=dev))
    k_min = 2 * math.pi / l_max
    k_max = 2 * math.pi / l_min
    kr, ki = jrandom.split(key)
    if mesh is not None:
        return tuple(coords), _domain_fft_sharded(
            kr, ki, k_func, ks, k_min, k_max, mesh, mesh_axis)
    shape = tuple(kv.shape[0] for kv in ks)
    amp = _band_amplitude(k_func, ks, k_min, k_max)
    noise = _noise(kr, ki, shape, dev)
    field = dft.ifftn(noise * amp).real
    return tuple(coords), field / torch.max(torch.abs(field))


def _noise(kr, ki, shape, dev, offset: int = 0) -> torch.Tensor:
    """normal(kr) + 1j normal(ki) of ``shape`` at flat indices offset ..,
    complex64 (one K10 launch on the card)."""
    return _krandom.draw_pair(jrandom.key_data(kr), jrandom.key_data(ki),
                              math.prod(shape), device=dev,
                              offset=offset).reshape(shape)


def _domain_fft_sharded(kr, ki, k_func, ks, k_min, k_max, mesh, axis):
    """``grf_domain_fft``'s field as axis-0 blocks over ``axis`` of
    ``mesh``: computed on the first line of the axis, each block copied to
    the positions of other lines (a 2-D mesh) that hold it."""
    from synthpy_tpu_torch.parallel.mesh import (Mesh, Sharded, all_to_all,
                                                 local_axis, pmax)

    local_axis(mesh, axis, "the sharded GRF synthesis")
    ndim = len(ks)
    shape = tuple(kv.shape[0] for kv in ks)
    G = mesh.shape[axis]
    if ndim < 2:
        raise ValueError("a sharded synthesis needs ndim >= 2: axis 1 "
                         "carries the split while axis 0 is transformed")
    if shape[0] % G or shape[1] % G:
        raise ValueError(f"axes 0 and 1 of {shape} must divide over the "
                         f"{G}-way {axis!r} axis")
    m = shape[0] // G
    per = m * math.prod(shape[1:])
    devs = [mesh.flat_devices[p] for p in mesh.groups(axis)[0]]
    line = Mesh((G,), (axis,), devices=devs)
    blocks = []
    for g, dev in enumerate(devs):
        kg = [kv.to(dev) for kv in ks]
        kg[0] = kg[0][g * m:(g + 1) * m]
        amp = _band_amplitude(k_func, kg, k_min, k_max)
        spec = _noise(kr, ki, (m, *shape[1:]), dev, offset=g * per) * amp
        del amp
        blocks.append(torch.fft.ifftn(spec, dim=tuple(range(1, ndim))))
        del spec
    cols = all_to_all(blocks, line, axis, split_dim=1, concat_dim=0)
    del blocks
    for g in range(G):
        cols[g] = torch.fft.ifft(cols[g], dim=0).real.contiguous()
    rows = all_to_all(cols, line, axis, split_dim=0, concat_dim=1)
    del cols
    peak = pmax([r.abs().amax() for r in rows], line, axis)
    rows = [r / pk for r, pk in zip(rows, peak)]
    placed = {}
    shards = []
    for p, dev in enumerate(mesh.flat_devices):
        g = mesh.index(p, axis)
        if (g, dev) not in placed:
            placed[(g, dev)] = rows[g].to(dev)
        shards.append(placed[(g, dev)])
    return Sharded(mesh, (axis,) + (None,) * (ndim - 1), shards, shape)


def _cos_modes(key, k_func, wn1, wnn, nmodes, ndim, dev):
    """Mode set-up: wavenumbers, amplitudes, random phases and angles."""
    dk = (wnn - wn1) / nmodes
    wn = wn1 + 0.5 * dk + torch.arange(nmodes, dtype=torch.float32,
                                       device=dev) * dk
    A_m = torch.sqrt(2.0 * _safe_spectrum(k_func, wn) * dk**ndim)
    keys = jrandom.split(key, 2 ** (ndim - 1) + ndim - 1)
    rows = 2 * math.pi * _krandom.draw_many(
        [jrandom.key_data(k) for k in keys], nmodes,
        ["uniform"] * keys.shape[0], device=dev)
    psis = list(rows[:2 ** (ndim - 1)])
    angles = list(rows[2 ** (ndim - 1):])
    return wn, A_m, psis, angles


def _centres(n: int, dx: float, dev) -> torch.Tensor:
    return dx / 2.0 + torch.arange(n, dtype=torch.float32, device=dev) * dx


def _phasor(t: torch.Tensor) -> torch.Tensor:
    """exp(1j t) of a real float32 tensor, complex64."""
    return torch.exp(torch.complex(torch.zeros_like(t), t))


SQRT2 = float(torch.sqrt(torch.tensor(2.0)))


def grf_cos_1d(key, k_func, lx, nx, nmodes, wn1, device="cuda"):
    """1-D randomised cosine sum."""
    dev = _device.resolve(device)
    dx = lx / nx
    wn, A_m, (psi,), _ = _cos_modes(key, k_func, wn1, math.pi / dx, nmodes,
                                    1, dev)
    xc = _centres(nx, dx, dev)
    arg = xc[:, None] * wn[None, :] + psi[None, :]
    field = (SQRT2 * torch.cos(arg)) @ A_m
    return (xc,), field


def grf_cos_2d(key, k_func, lx, ly, nx, ny, nmodes, wn1, device="cuda"):
    """2-D randomised cosine sum: cos(a + b + psi) = Re{e^{i psi} e^{i a}
    e^{i b}} makes the mode sum separable; the sum over modes is a
    matmul."""
    dev = _device.resolve(device)
    dx, dy = lx / nx, ly / ny
    wnn = max(math.pi / dx, math.pi / dy)
    wn, A_m, (phi, psi), (theta,) = _cos_modes(key, k_func, wn1, wnn,
                                               nmodes, 2, dev)
    kx = torch.cos(theta) * wn
    ky = torch.sin(theta) * wn
    xc = _centres(nx, dx, dev)
    yc = _centres(ny, dy, dev)
    Ex = _phasor(xc[:, None] * kx[None, :])            # (nx, m)
    Ey = _phasor(yc[:, None] * ky[None, :])            # (ny, m)
    c1 = SQRT2 * A_m * _phasor(phi)
    c2 = SQRT2 * A_m * _phasor(psi)
    field = ((Ex * c1) @ Ey.T + (Ex * c2) @ torch.conj(Ey).T).real
    return (xc, yc), field


def grf_cos_3d(key, k_func, lx, ly, lz, nx, ny, nz, nmodes, wn1,
               device="cuda"):
    """3-D randomised cosine sum as four complex tensor contractions: the
    four cosine terms with y/z sign flips are conjugations of the
    separable per-axis phase factors."""
    dev = _device.resolve(device)
    dx, dy, dz = lx / nx, ly / ny, lz / nz
    wnn = max(math.pi / dx, math.pi / dy, math.pi / dz)
    wn, A_m, psis, (theta, phi) = _cos_modes(key, k_func, wn1, wnn, nmodes,
                                             3, dev)
    kx = torch.sin(theta) * torch.cos(phi) * wn
    ky = torch.sin(theta) * torch.sin(phi) * wn
    kz = torch.cos(theta) * wn
    xc, yc, zc = (_centres(n, d, dev) for n, d in ((nx, dx), (ny, dy),
                                                   (nz, dz)))
    Ex = _phasor(xc[:, None] * kx[None, :])
    Ey = _phasor(yc[:, None] * ky[None, :])
    Ez = _phasor(zc[:, None] * kz[None, :])
    amp = SQRT2 * A_m
    field = torch.zeros((nx, ny, nz), dtype=torch.float32, device=dev)
    for psi_i, conj_y, conj_z in ((psis[0], False, False),
                                  (psis[1], False, True),
                                  (psis[2], True, False),
                                  (psis[3], True, True)):
        Eyt = torch.conj(Ey) if conj_y else Ey
        Ezt = torch.conj(Ez) if conj_z else Ez
        coef = amp * _phasor(psi_i)
        xy = torch.einsum("im,jm->ijm", Ex * coef, Eyt)
        field = field + torch.einsum("ijm,km->ijk", xy, Ezt).real
    return (xc, yc, zc), field


class _GaussianND:
    """Holds a k_func, a key and the last generated field (the JAX
    package's class shape). Each generation advances the key as JAX's
    classes do: ``key, sub = split(key)``, drawing from ``sub``."""

    ndim: int = 3

    def __init__(self, k_func: Callable, seed: int | None = 0,
                 device="cuda"):
        self.k_func = k_func
        self.key = jrandom.PRNGKey(0 if seed is None else seed)
        self.device = _device.resolve(device)
        self.ne = None
        self.coords = None

    def _next_key(self):
        self.key, sub = jrandom.split(self.key)
        return sub

    def fft(self, N: int, d: float = 1.0):
        self.ne = grf_fft(self._next_key(), N, self.k_func, self.ndim, d,
                          device=self.device)
        self.coords = None
        return self.ne


class gaussian1D(_GaussianND):
    ndim = 1

    def cos(self, lx, nx, nmodes, wn1):
        self.coords, self.ne = grf_cos_1d(
            self._next_key(), self.k_func, lx, nx, nmodes, wn1,
            device=self.device)
        return self.ne

    def domain_fft(self, l_max, l_min, extent, res):
        self.coords, self.ne = grf_domain_fft(
            self._next_key(), self.k_func, l_max, l_min, extent, res,
            ndim=1, device=self.device)
        return self.ne


class gaussian2D(_GaussianND):
    ndim = 2

    def cos(self, lx, ly, nx, ny, nmodes, wn1):
        self.coords, self.ne = grf_cos_2d(
            self._next_key(), self.k_func, lx, ly, nx, ny, nmodes, wn1,
            device=self.device)
        return self.ne

    def domain_fft(self, l_max, l_min, extent, res):
        self.coords, self.ne = grf_domain_fft(
            self._next_key(), self.k_func, l_max, l_min, extent, res,
            ndim=2, device=self.device)
        return self.ne


class gaussian3D(_GaussianND):
    ndim = 3

    def cos(self, lx, ly, lz, nx, ny, nz, nmodes, wn1):
        self.coords, self.ne = grf_cos_3d(
            self._next_key(), self.k_func, lx, ly, lz, nx, ny, nz, nmodes,
            wn1, device=self.device)
        return self.ne

    def domain_fft(self, l_max, l_min, extent, res, factor: float = 1.0):
        self.coords, self.ne = grf_domain_fft(
            self._next_key(), self.k_func, l_max, l_min, extent, res,
            factor=factor, ndim=3, device=self.device)
        return self.ne


def grf_vector_solenoidal(key, k_func: Callable, l_max: float, l_min: float,
                          extent: float, res: int, rms: float = 1.0,
                          device="cuda"):
    """Divergence-free turbulent vector field: three band-limited GRF
    components projected onto their solenoidal part in k-space
    (B - k (k.B) / k^2), normalised to the requested RMS magnitude.
    Returns (coords, B) with B of shape (n, n, n, 3)."""
    dev = _device.resolve(device)
    dx = extent / res
    n = 2 * res
    step = 2 * extent / n
    c = (-extent + torch.arange(n, dtype=torch.float64, device=dev)
         * step).to(torch.float32)
    coords = (c, c.clone(), c.clone())
    k1 = 2 * math.pi * dft.fftfreq(n, d=dx, device=dev)
    kx, ky, kz = torch.meshgrid(k1, k1, k1, indexing="ij")
    kmag = torch.sqrt(kx**2 + ky**2 + kz**2)
    k_min = 2 * math.pi / l_max
    k_max = 2 * math.pi / l_min
    S = torch.where((kmag >= k_min) & (kmag <= k_max),
                    _safe_spectrum(k_func, kmag), torch.zeros_like(kmag))
    amp = torch.sqrt(S)
    keys = jrandom.split(key, 6)
    F = [_noise(keys[2 * i], keys[2 * i + 1], amp.shape, dev) * amp
         for i in range(3)]
    k2 = torch.clamp_min(kx**2 + ky**2 + kz**2, 1e-30)
    kdotF = kx * F[0] + ky * F[1] + kz * F[2]
    F = [F[0] - kx * kdotF / k2, F[1] - ky * kdotF / k2,
         F[2] - kz * kdotF / k2]
    B = torch.stack([dft.ifftn(f).real for f in F], dim=-1)
    return coords, B * (rms / torch.sqrt(torch.mean(torch.sum(B**2,
                                                              dim=-1))))
