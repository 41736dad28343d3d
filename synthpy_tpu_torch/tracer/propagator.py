"""Exit-plane resolution (PyTorch port of the exit-plane part of
``synthpy_tpu.tracer.propagator``): ``ray_to_Jonesvector``,
``back_propagate`` and ``TraceResult``. The time-domain tracer is not
ported yet (ROADMAP B5)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

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
