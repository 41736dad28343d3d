"""Charged-particle (proton) radiography through gridded B fields (PyTorch
port of ``synthpy_tpu.tracer.particles``).

A point-projection proton cone (``init_proton_beam``) flies freely to the
object's entry face, is marched by a relativistic Boris pusher through the
domain's (nx, ny, nz, 3) B grid (``trace_protons``; kernel K13,
``kernels.boris``) and projected ballistically onto a fluence detector
(``proton_radiograph``; K3's ``bin_image`` on the card). ``build_B_table``
uploads a B grid, host-resident or on the device, into a float32, bfloat16
or int8 table in plane batches (kernel K14, ``kernels.btable``), the
1024^3 lever: the bfloat16 table of a 1024^3 grid is 6 GiB, the int8 one
3 GiB.

State layout: (N, 6) rows [x, y, z, vx, vy, vz] in SI units, or a (6, N)
/ (9, N) column state (the photon convention). The arithmetic follows the
JAX package's on its CPU backend: keys draw JAX's threefry streams
(``synthpy_tpu_torch.random``), the march repeats the fused multiply-adds
of XLA's compiled scan body, and the tables' codes are JAX's bit for bit.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from synthpy_tpu_torch import _device, constants
from synthpy_tpu_torch import random as jrandom
from synthpy_tpu_torch.kernels import boris, btable
from synthpy_tpu_torch.ops.histogram import histogram2d
from synthpy_tpu_torch.ops.interp import fma, grid_geometry

_AXIS_OF = {"x": 0, "y": 1, "z": 2}


class BTable(NamedTuple):
    """A (possibly quantised) device-resident B grid for the pusher.

    ``grid``: (nx, ny, nz, 3) table in float32, bfloat16 or int8.
    ``scale``: (3,) float32 per-component dequantisation factors for int8
    (B = q * scale), or None for the float dtypes.
    """
    grid: torch.Tensor
    scale: Optional[torch.Tensor]


def _is_int8(dtype) -> bool:
    return dtype is torch.int8 or (isinstance(dtype, str)
                                   and dtype == "int8")


def _host_grid(B, dev: torch.device) -> bool:
    """A numpy array, or a CPU tensor of a domain on a card."""
    return isinstance(B, np.ndarray) or (dev.type != "cpu"
                                          and B.device.type == "cpu")


def _np_planes(B, i0: int, i1: int) -> np.ndarray:
    if isinstance(B, np.ndarray):
        return np.asarray(B[i0:i1])
    return B[i0:i1].numpy()


def _amax(B, plane_batch: int) -> np.ndarray:
    """(3,) float64 max |B| per component of a grid (numpy, host or device
    tensor), plane batch by plane batch where the grid lies, so that no
    full-size |B| temporary is made: the per-component min and max of each
    batch."""
    m = np.zeros((3,), np.float64)
    for i0 in range(0, B.shape[0], plane_batch):
        chunk = B[i0:i0 + plane_batch]
        if isinstance(chunk, np.ndarray):
            with warnings.catch_warnings():
                # a read-only array is only read here
                warnings.simplefilter("ignore", UserWarning)
                chunk = torch.from_numpy(np.ascontiguousarray(chunk))
        lo, hi = torch.aminmax(chunk.detach().reshape(-1, 3), dim=0)
        m = np.maximum(m, torch.maximum(lo.abs(), hi.abs()).double()
                       .cpu().numpy())
    return m


def _planes_on(B, i0: int, i1: int, dev: torch.device) -> torch.Tensor:
    """Planes i0 .. i1-1 as a contiguous float32 tensor on ``dev``."""
    if isinstance(B, np.ndarray):
        return torch.from_numpy(np.array(B[i0:i1], np.float32)).to(dev)
    return B[i0:i1].to(dev, torch.float32,
                       non_blocking=B.is_pinned()).contiguous()


def build_B_table(
    domain,
    dtype=torch.bfloat16,
    plane_batch: int = 32,
    dither: Optional[int] = None,
    host_quantize: bool = True,
    verbose: bool = False,
) -> BTable:
    """Upload the domain's B grid into a reduced-dtype table on the
    domain's device, plane batch by plane batch.

    ``domain.B`` is an (nx, ny, nz, 3) grid: on the device, or
    host-resident (``external_B(host=True)``: a pinned CPU tensor for a
    domain on a card; or a numpy array set as ``domain.B``). The table is
    allocated once and each float32 batch is written in place by K14
    (``kernels.btable``): a bfloat16 cast, or int8 codes of the
    per-component scale max|B| / 127 (the maxima taken plane batch by plane
    batch where the grid lies: on the host for a host grid), dithered
    by ``uniform(fold_in(PRNGKey(dither), i0), -0.5, 0.5)`` when
    ``dither`` is set; a float32 table takes plain copies.

    ``host_quantize`` (int8, host grid): quantise each batch in numpy
    before the copy, as the JAX package does (an f32 divide, round half to
    even, clip; with ``dither`` a numpy Philox stream keyed by (dither,
    plane)), so the codes are JAX's host route's bit for bit; undithered
    they equal the device route's.
    """
    B = domain.B
    if B is None:
        raise RuntimeError("build_B_table needs domain.external_B")
    dev = domain.device
    nx, ny, nz, _ = B.shape
    host = _host_grid(B, dev)
    is_int8 = _is_int8(dtype)
    scale = None
    if is_int8:
        m = _amax(B, plane_batch)
        scale_np = (np.maximum(m, 1e-30) / 127.0).astype(np.float32)
        scale = torch.from_numpy(scale_np).to(dev)
        out_dtype = torch.int8
    else:
        out_dtype = dtype
    tab = torch.empty((nx, ny, nz, 3), dtype=out_dtype, device=dev)

    if is_int8 and host_quantize and host:
        for i0 in range(0, nx, plane_batch):
            t0 = time.perf_counter()
            q = _np_planes(B, i0, i0 + plane_batch).astype(
                np.float32) / scale_np
            if dither is not None:
                rng = np.random.Generator(
                    np.random.Philox(key=[int(dither), i0]))
                q = q + (rng.random(q.shape, dtype=np.float32)
                         - np.float32(0.5))
            b = np.clip(np.round(q), -127, 127).astype(np.int8)
            tab[i0:i0 + b.shape[0]].copy_(torch.from_numpy(b))
            if verbose:
                print(f"  B planes {i0}..{min(i0 + plane_batch, nx)} "
                      f"host-q ({time.perf_counter() - t0:.1f}s)",
                      flush=True)
        return BTable(tab, scale)

    for i0 in range(0, nx, plane_batch):
        t0 = time.perf_counter()
        batch = _planes_on(B, i0, i0 + plane_batch, dev)
        key = None
        if is_int8 and dither is not None:
            key = jrandom.key_data(jrandom.fold_in(jrandom.PRNGKey(dither),
                                                   i0))
        btable.write(tab, batch, i0, scale, key)
        if verbose:
            print(f"  B planes {i0}..{min(i0 + plane_batch, nx)} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    return BTable(tab, scale)


def proton_speed(energy_MeV: float) -> Tuple[float, float]:
    """(speed [m/s], gamma) of a proton of the given kinetic energy:
    gamma = 1 + T / (m c^2), v = c sqrt(1 - 1 / gamma^2)."""
    gamma = 1.0 + energy_MeV / constants.PROTON_REST_MEV
    v = constants.C * math.sqrt(1.0 - 1.0 / (gamma * gamma))
    return v, gamma


def init_proton_beam(
    key,
    Np: int,
    energy_MeV: float,
    source_distance: float,
    extent: float,
    cone_radius: Optional[float] = None,
    probing_direction: str = "z",
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """Point-projection proton source: (N, 6) float32 rows aimed at the
    object.

    The source sits at ``-(extent + source_distance)`` on the probing
    axis; each proton is launched toward a uniformly sampled point of the
    disc of radius ``cone_radius`` (default ``extent``) on the entry plane.
    The two uniforms come from ``split(key)`` as in JAX, so a key gives
    the JAX package's positions and directions (the directions within the
    last place of cos and sin, whose libraries differ); all protons share
    the speed of ``proton_speed``.
    """
    if dtype != torch.float32:
        raise ValueError("the port draws float32 proton beams only")
    dev = _device.resolve(device)
    v, _ = proton_speed(energy_MeV)
    if cone_radius is None:
        cone_radius = extent
    k_r, k_t = jrandom.split(key)
    f32 = torch.float32
    r = float(np.float32(cone_radius)) * torch.sqrt(
        jrandom.uniform(k_r, (Np,), device=dev))
    th = float(np.float32(2 * math.pi)) * jrandom.uniform(k_t, (Np,),
                                                          device=dev)
    a_hit, b_hit = r * torch.cos(th), r * torch.sin(th)

    p_ax = _AXIS_OF[probing_direction]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    d = torch.stack([a_hit, b_hit, torch.full((Np,), source_distance,
                                              dtype=f32, device=dev)], 1)
    # jnp.linalg.norm as XLA's CPU compiler reduces it: a chain of fused
    # multiply-adds
    norm = torch.sqrt(fma(d[:, 2:3], d[:, 2:3], fma(
        d[:, 1:2], d[:, 1:2], d[:, 0:1] * d[:, 0:1])))
    d = d / norm

    v32 = float(np.float32(v))
    s = torch.zeros((Np, 6), dtype=f32, device=dev)
    s[:, p_ax] = float(np.float32(-(extent + source_distance)))
    s[:, 3 + a_ax] = v32 * d[:, 0]
    s[:, 3 + b_ax] = v32 * d[:, 1]
    s[:, 3 + p_ax] = v32 * d[:, 2]
    return s


def _tensor(a) -> torch.Tensor:
    """A tensor as it is; an array (numpy, or what ``np.array`` takes) as
    a float32 CPU tensor of a writable copy."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.array(a, np.float32))


def _rows_of(s: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(N, >=6) rows of an (N, 6) row state or a (6|9, N) column state,
    and whether it was columns."""
    transposed = s.shape[0] in (6, 9) and s.shape[1] not in (6, 9)
    return (s.T if transposed else s), transposed


def boris_inputs(
    s0,
    domain,
    energy_MeV: float,
    steps_per_cell: float = 2.0,
    charge_sign: float = 1.0,
    B_table: Optional[BTable] = None,
):
    """What ``trace_protons`` hands the pusher: (rows, grid, scale, kw,
    transposed). ``rows`` are the (N, 6) float32 states after the free
    flight to the entry face, on the table's device; ``kw`` the
    ``kernels.boris.push`` arguments (origin, inv_spacing, h = dt / 2,
    wdt = (w / 2) dt, n_steps) folded as the JAX package folds them."""
    s0 = _tensor(s0)
    if s0.dim() != 2:
        raise ValueError("s0 must be 2-D")
    rows, transposed = _rows_of(s0)

    if B_table is not None:
        grid, scale = B_table.grid, B_table.scale
    else:
        if getattr(domain, "B", None) is None:
            raise RuntimeError("proton radiography needs domain.external_B "
                               "(or test_B): the deflection is the signal")
        # a host-resident grid goes to the domain's device whole, as the
        # JAX package's jnp.asarray(domain.B) does
        grid, scale = _tensor(domain.B).to(domain.device), None
    # the march runs where the table is
    rows = rows[:, :6].to(grid.device, torch.float32)
    origin, inv = grid_geometry((domain.x, domain.y, domain.z))

    v, gamma = proton_speed(energy_MeV)
    p_ax = _AXIS_OF[domain.probing_direction]
    extent = domain.extent
    # free flight of a distant point source to the entry face (exact: B is
    # zero outside the object)
    t_in = torch.clamp_min(
        (float(np.float32(-extent)) - rows[:, p_ax]) / rows[:, 3 + p_ax],
        0.0)
    rows = torch.cat([rows[:, :3] + t_in[:, None] * rows[:, 3:],
                      rows[:, 3:]], 1)
    span = 2.0 * extent
    total_time = 2.0 * span / v
    cell = float(domain.lengths[p_ax]) / (domain.dims[p_ax] - 1)
    n_steps = max(int(round(2.0 * span / cell * steps_per_cell)), 8)
    dt = np.float32(total_time / n_steps)
    w = charge_sign * constants.E_CHARGE / (gamma * constants.M_PROTON)
    kw = dict(origin=[float(o) for o in origin.float().tolist()],
              inv_spacing=[float(i) for i in inv.float().tolist()],
              h=float(np.float32(0.5) * dt),
              wdt=float(np.float32(np.float32(0.5 * w) * dt)),
              n_steps=n_steps)
    return rows, grid, scale, kw, transposed


def trace_protons(
    s0,
    domain,
    energy_MeV: float,
    steps_per_cell: float = 2.0,
    ray_chunk: Optional[int] = None,
    charge_sign: float = 1.0,
    B_table: Optional[BTable] = None,
) -> torch.Tensor:
    """March a proton bundle through ``domain``'s B grid (or ``B_table``)
    to the exit side.

    ``s0``: (N, 6) rows (``init_proton_beam``) or a (6, N) / (9, N) column
    state (extra rows are ignored; the result is (6, N)). Each proton first
    flies freely to the entry face (B = 0 outside the object), then K13
    marches all of them for twice the axial crossing time of the probing
    span in ``max(round(2 span / cell * steps_per_cell), 8)`` fixed steps,
    as the JAX package does (``boris_inputs``). Without ``B_table`` the
    march reads ``domain.B``, which goes to the domain's device whole when
    it is host-resident (``build_B_table`` uploads it in plane batches
    instead, and narrower). ``ray_chunk`` is accepted
    for JAX's callers and ignored: the kernel holds one proton a thread,
    so the march is one launch a call whatever the bundle's size.
    """
    rows, grid, scale, kw, transposed = boris_inputs(
        s0, domain, energy_MeV, steps_per_cell, charge_sign, B_table)
    out = boris.push(rows, grid, scale, **kw)
    return out.T if transposed else out


def proton_radiograph(
    sf,
    detector_distance: float,
    extent: float,
    bins: Tuple[int, int] = (431, 321),
    Lx: float = 18.0,
    Ly: float = 13.5,
    probing_direction: str = "z",
) -> torch.Tensor:
    """Project exit protons ballistically onto the detector plane
    ``extent + detector_distance`` and bin them: the (ny, nx) fluence
    image over [-Lx/2, Lx/2] x [-Ly/2, Ly/2] mm. Protons without a forward
    exit velocity (mirrored or trapped) weigh 0. The binning is K3's
    ``bin_image`` on the card (``ops.histogram.histogram2d``)."""
    rows, _ = _rows_of(_tensor(sf))
    p_ax = _AXIS_OF[probing_direction]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    t = (float(np.float32(extent + detector_distance)) - rows[:, p_ax]) \
        / rows[:, 3 + p_ax]
    xa = (rows[:, a_ax] + t * rows[:, 3 + a_ax]) * 1e3
    xb = (rows[:, b_ax] + t * rows[:, 3 + b_ax]) * 1e3
    fwd = (rows[:, 3 + p_ax] > 0).to(xa.dtype)
    H, _, _ = histogram2d(xa, xb, bins,
                          ((-Lx / 2, Lx / 2), (-Ly / 2, Ly / 2)),
                          weights=fwd)
    return H
