"""The time-domain tracer and exit-plane resolution (PyTorch port of
``synthpy_tpu.tracer.propagator``).

``trace_rk4`` is fixed-step RK4 of (N, 9) ray rows over the packed channel
grid (kernel K5, ``kernels.time_march``; ``_rhs`` is its right-hand side);
``solve`` traces a bundle to the exit plane, and ``ray_to_Jonesvector`` /
``back_propagate`` resolve exit states.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from synthpy_tpu_torch.constants import C
from synthpy_tpu_torch.fields.domain import (ScalarDomain, TracePack,
                                             build_pack, layout_of)
from synthpy_tpu_torch.kernels import time_march as _time
from synthpy_tpu_torch.kernels.time_march import rhs as _rhs  # noqa: F401

_AXIS_OF = {"x": 0, "y": 1, "z": 2}
# transverse (row 0, row 2) axes of the RTM ray per probing direction,
# with the modern reference's y-probing x/z swap
_TRANS = {"x": (1, 2), "y": (2, 0), "z": (0, 1)}


def ray_to_Jonesvector(rays: torch.Tensor, ne_extent, *,
                       probing_direction: str = "z",
                       keep_current_plane: bool = False,
                       return_E: bool = False):
    """(9, N) exit state -> (4, N) RTM rays [x, theta, y, phi] (+ Jones E).

    Back-projects each ray to the plane at coordinate ``ne_extent`` along
    the probing axis, then reports transverse positions and angles.
    """
    ax = _AXIS_OF[probing_direction]
    p_par = rays[ax]
    v_par = rays[3 + ax]
    t_bp = (p_par - ne_extent) / v_par
    comps = []
    for a in _TRANS[probing_direction]:
        p, v = rays[a], rays[3 + a]
        comps.append(p if keep_current_plane else p - v * t_bp)
        comps.append(torch.arctan(v / v_par))
    ray_p = torch.stack(comps)
    if not return_E:
        return ray_p, None
    amp, phase, pol = rays[6], rays[7], rays[8]
    # initial polarisation along y; rotate by pol, scale by amp, advance
    # by phase
    e_phase = amp * torch.complex(torch.cos(phase), torch.sin(phase))
    ray_J = torch.stack([e_phase * (-torch.sin(pol)),
                         e_phase * torch.cos(pol)])
    return ray_p, ray_J


def back_propagate(rays: torch.Tensor, ne_extent,
                   probing_direction: str = "z") -> torch.Tensor:
    """Snap (9, N) rays back onto the plane at ``ne_extent`` along the
    probing axis."""
    ax = _AXIS_OF[probing_direction]
    t_bp = (rays[ax] - ne_extent) / rays[3 + ax]
    out = rays.clone()
    for a in range(3):
        if a == ax:
            out[a] = ne_extent
        else:
            out[a] = rays[a] - rays[3 + a] * t_bp
    return out


class TraceResult(NamedTuple):
    rf: torch.Tensor                # (4, N) [x, theta, y, phi] [m, rad]
    Jf: Optional[torch.Tensor]      # (2, N) complex Jones vector, or None
    sf: torch.Tensor                # (9, N) raw final ODE state
    duration: float                 # trace wall time [s]


def trace_rk4(s_rows: torch.Tensor, channels: torch.Tensor, origin,
              inv_spacing, dt, *, layout, n_steps: int,
              ray_chunk: Optional[int] = None,
              atten_sign: float = -1.0) -> torch.Tensor:
    """Integrate (N, 9) rays for ``n_steps`` RK4 steps of ``dt`` (float32)
    through the (nx, ny, nz, C) channel grid (kernel K5). ``ray_chunk`` is
    the JAX program's memory knob and has no effect here: the kernel keeps
    no per-ray buffer."""
    del ray_chunk
    return _time.march(s_rows.contiguous(), channels, origin, inv_spacing,
                       dt, layout=layout, n_steps=n_steps,
                       atten_sign=atten_sign)


def t_end_of(probing_depth: float) -> np.float32:
    """The integration time sqrt(8) * depth / c as the JAX package computes
    it: in float32 (``jnp.sqrt(8.0)`` is a float32 array)."""
    return np.sqrt(np.float32(8.0)) * np.float32(probing_depth) / np.float32(C)


def default_n_steps(domain: ScalarDomain, probing_depth: float,
                    steps_per_cell: float = 1.0) -> int:
    """Step count of the cell-crossing heuristic: one step per
    ``1/steps_per_cell`` probing-axis cells over sqrt(8) * depth, rounded
    up in float32 as the JAX package does, and at least 8."""
    ax = domain.probe_axis
    cell = domain.lengths[ax] / (domain.dims[ax] - 1)
    n = (np.float32(steps_per_cell) * np.sqrt(np.float32(8.0))
         * np.float32(probing_depth) / np.float32(cell))
    return max(int(np.ceil(n)), 8)


def dt_of(n_steps: int, probing_depth: float,
          t_end: Optional[float] = None) -> float:
    """The float32 step of ``solve``: t_end / n_steps, t_end defaulting to
    the float32 sqrt(8) * depth / c."""
    if t_end is None:
        return float(t_end_of(probing_depth) / np.float32(n_steps))
    return float(np.float32(t_end / n_steps))


def solve(
    s0: torch.Tensor,
    domain: ScalarDomain,
    probing_depth: Optional[float] = None,
    *,
    lwl: float = 1064e-9,
    return_E: bool = False,
    n_steps: Optional[int] = None,
    steps_per_cell: float = 1.0,
    ray_chunk: Optional[int] = None,
    atten_sign: float = -1.0,
    pack: Optional[TracePack] = None,
    keep_current_plane: bool = False,
    t_end: Optional[float] = None,
) -> TraceResult:
    """Trace a (9, N) bundle through a domain with the time-domain tracer
    and resolve the exit plane ``probing_depth`` (default: the domain's
    half extent). ``pack`` reuses a TracePack; ``t_end`` overrides the
    integration time sqrt(8) * depth / c."""
    if probing_depth is None:
        probing_depth = domain.extent
    if pack is None:
        pack = build_pack(domain, lwl)
    if n_steps is None:
        n_steps = default_n_steps(domain, probing_depth, steps_per_cell)
    dt = dt_of(n_steps, probing_depth, t_end)
    s_rows = s0.T.contiguous()
    if s_rows.is_cuda:
        torch.cuda.synchronize(s_rows.device)
    start = time.perf_counter()
    sf_rows = trace_rk4(s_rows, pack.channels, pack.origin, pack.inv_spacing,
                        dt, layout=layout_of(domain), n_steps=n_steps,
                        ray_chunk=ray_chunk, atten_sign=atten_sign)
    if sf_rows.is_cuda:
        torch.cuda.synchronize(sf_rows.device)
    duration = time.perf_counter() - start
    sf = sf_rows.T
    rf, Jf = ray_to_Jonesvector(
        sf, probing_depth, probing_direction=domain.probing_direction,
        keep_current_plane=keep_current_plane, return_E=return_E)
    return TraceResult(rf, Jf, sf, duration)
