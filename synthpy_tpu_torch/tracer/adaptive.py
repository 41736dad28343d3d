"""Adaptive Dormand-Prince 5(4) tracer, the validation integrator (PyTorch
port of ``synthpy_tpu.tracer.adaptive``).

One step size shared by the whole bundle, the error norm taken over all
rays (the semantics of solve_ivp on the flattened 9N system), steps capped
at half a probing cell where the field's kinks could hide from the embedded
error estimate. Each step is kernel K6 (``kernels.adaptive``); the loop
over steps stays on the host.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from synthpy_tpu_torch.fields.domain import (ScalarDomain, TracePack,
                                             build_pack, layout_of)
from synthpy_tpu_torch.kernels import adaptive as _adaptive
from synthpy_tpu_torch.tracer.propagator import (TraceResult,
                                                 ray_to_Jonesvector,
                                                 t_end_of)


def trace_rk45(s_rows: torch.Tensor, channels: torch.Tensor, origin,
               inv_spacing, t_end, *, layout, rtol: float = 1e-6,
               atol: float = 1e-3, max_steps: int = 4096,
               atten_sign: float = -1.0,
               plane_amax: Optional[torch.Tensor] = None,
               p_axis: Optional[int] = None):
    """Integrate (N, 9) rays to ``t_end`` with shared adaptive DP5(4)
    steps; ``plane_amax`` (the (n_p,) peak acceleration of each plane
    along ``p_axis``) makes the kink cap local to the planes the bundle
    can reach. Returns (s_final, n_accepted, n_rejected)."""
    return _adaptive.trace_rk45(
        s_rows.contiguous(), channels, origin, inv_spacing, t_end,
        layout=layout, rtol=rtol, atol=atol, max_steps=max_steps,
        atten_sign=atten_sign, plane_amax=plane_amax, p_axis=p_axis)


def solve_adaptive(
    s0: torch.Tensor,
    domain: ScalarDomain,
    probing_depth: Optional[float] = None,
    *,
    lwl: float = 1064e-9,
    return_E: bool = False,
    rtol: float = 1e-6,
    atol: float = 1e-3,
    max_steps: int = 4096,
    pack: Optional[TracePack] = None,
    local_cap: bool = True,
    return_steps: bool = False,
):
    """Adaptive-integrator drop-in for ``tracer.solve``. ``local_cap``
    (default on) sets the kink cap from the per-plane peak acceleration;
    ``return_steps`` also returns (accepted, rejected) step counts."""
    if probing_depth is None:
        probing_depth = domain.extent
    if pack is None:
        pack = build_pack(domain, lwl)
    p_ax = domain.probe_axis
    plane_amax = (_adaptive.plane_amax_of(pack.channels, p_ax) if local_cap
                  else None)
    s_rows = s0.T.contiguous()
    if s_rows.is_cuda:
        torch.cuda.synchronize(s_rows.device)
    start = time.perf_counter()
    sf_rows, n_acc, n_rej = trace_rk45(
        s_rows, pack.channels, pack.origin, pack.inv_spacing,
        t_end_of(probing_depth), layout=layout_of(domain), rtol=rtol,
        atol=atol, max_steps=max_steps, plane_amax=plane_amax,
        p_axis=p_ax if local_cap else None)
    if sf_rows.is_cuda:
        torch.cuda.synchronize(sf_rows.device)
    duration = time.perf_counter() - start
    sf = sf_rows.T
    rf, Jf = ray_to_Jonesvector(sf, probing_depth,
                                probing_direction=domain.probing_direction,
                                return_E=return_E)
    res = TraceResult(rf, Jf, sf, duration)
    if return_steps:
        return res, (int(n_acc), int(n_rej))
    return res
