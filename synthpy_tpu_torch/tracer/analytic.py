"""Pack-free z-scan march for closed-form fields (PyTorch port of
``synthpy_tpu.tracer.analytic``).

The field and its gradient are evaluated in closed form at every RK stage:
no pack build, no field table, no gathers. The spec is
``ScalarDomain.analytic``, a dict of torch closures ``{"ne": f(x, y, z)}``
with optional ``"B"`` (``(x, y, z) -> (Bx, By, Bz)``), ``"Te"`` and
``"Z"``, which feed the Faraday and inverse-bremsstrahlung channels when
the domain's switches are on. The ``test_*`` constructors fill it in.

Two routes, chosen by the spec alone (``route="auto"``):

* ``"kernel"``: the closures are ``fields.forms.ClosedForm``s (every
  ``test_*`` field) and the march is kernel K7 (``kernels.analytic``), which
  evaluates the forms and their hand-written gradients on the card (its
  plain version on CPU tensors);
* ``"autograd"``: any other closures (a user's own profile) are
  differentiated with ``torch.autograd`` at every stage, in plain PyTorch
  on the rays' device. Closures must be elementwise, as in the JAX package.

``route="kernel"`` on a spec the kernel cannot evaluate raises; a build or
launch failure raises too, and never switches the route.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from synthpy_tpu_torch import constants
from synthpy_tpu_torch.fields.domain import (ChannelLayout, ScalarDomain,
                                             layout_of)
from synthpy_tpu_torch.fields.forms import f32
from synthpy_tpu_torch.kernels import analytic as _k7
from synthpy_tpu_torch.kernels.slab_march import cols_rhs
from synthpy_tpu_torch.tracer.propagator import (TraceResult,
                                                 ray_to_Jonesvector)
from synthpy_tpu_torch.tracer.zscan import (_AXIS_OF, permute_state,
                                            reassemble_state)

ROUTES = ("auto", "kernel", "autograd")


def kernel_route(spec: dict, layout: ChannelLayout) -> bool:
    """Whether K7 can evaluate ``spec`` on ``layout``
    (``kernels.analytic.unsupported``)."""
    return _k7.unsupported(spec.get("ne"), spec.get("B"), layout) is None


def _check_spec(spec: dict, layout: ChannelLayout) -> None:
    if layout.inv_brems and ("Te" not in spec or "Z" not in spec):
        raise ValueError("inv_brems needs 'Te' and 'Z' closures in "
                         "domain.analytic")
    if layout.B_on and "B" not in spec:
        raise ValueError("B_on needs a 'B' closure in domain.analytic")


def _autograd_march(u, spec, layout, *, axes, bounds, omega, lwl, p0, h,
                    n_steps, integrator, atten_sign):
    """The closure route: gradients of ``spec["ne"]`` by autograd at every
    stage (an axis the closure ignores has gradient 0)."""
    c = _k7.Consts.of(omega, lwl)
    lo, hi = ([f32(v) for v in b] for b in bounds)

    def deriv(uu, p):
        xyz = [t.detach().requires_grad_()
               for t in _k7.positions(uu, p, axes)]
        with torch.enable_grad():
            ne = spec["ne"](*xyz)
            if ne.requires_grad:
                grad = torch.autograd.grad(ne.sum(), xyz, allow_unused=True)
            else:
                grad = (None,) * 3
        ne = ne.detach()
        xyz = [t.detach() for t in xyz]
        grad = [torch.zeros_like(xyz[0]) if g is None else g for g in grad]
        kappa = (constants.kappa(ne, spec["Te"](*xyz), spec["Z"](*xyz),
                                 omega) if layout.inv_brems else None)
        B = spec["B"](*xyz) if layout.B_on else None
        vals = _k7.channel_values(xyz, grad, layout, axes, (lo, hi), c,
                                  omega, ne=ne, kappa=kappa, B=B)
        return cols_rhs(uu, vals, layout, atten_sign)

    return _k7.integrate(u, deriv, _k7.Steps.of(p0, h), n_steps, integrator)


def trace_zscan_analytic(
    u: torch.Tensor,
    spec: dict,
    layout: ChannelLayout,
    *,
    axes: Tuple[int, int, int],
    bounds,
    omega: float,
    lwl: float,
    p0: float,
    h: float,
    n_steps: int,
    integrator: str = "rk2",
    atten_sign: float = -1.0,
    ray_chunk: Optional[int] = None,
    unroll: int = 2,
    route: str = "auto",
) -> torch.Tensor:
    """March (N, 8) permuted rays through a closed-form field.

    ``axes`` = (a_ax, b_ax, p_ax); ``bounds`` = (lo, hi) of the domain box
    (channels are 0 outside, as the gridded fill 0). ``integrator`` is
    "rk2" (midpoint) or "rk4". ``route`` is "auto" (the spec decides),
    "kernel" or "autograd" (see the module docstring). ``ray_chunk`` and
    ``unroll`` are the JAX program's memory and scan knobs and have no
    effect.
    """
    del ray_chunk, unroll
    if integrator not in ("rk2", "rk4"):
        raise ValueError(f"unknown integrator {integrator!r} "
                         "(analytic march: rk2 | rk4)")
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; expected {ROUTES}")
    _check_spec(spec, layout)
    kw = dict(axes=axes, bounds=bounds, omega=omega, lwl=lwl, p0=p0, h=h,
              n_steps=int(n_steps), integrator=integrator,
              atten_sign=atten_sign)
    if route == "auto":
        route = "kernel" if kernel_route(spec, layout) else "autograd"
    if route == "kernel":
        if not kernel_route(spec, layout):
            raise ValueError(
                "route='kernel' needs the closed forms of the test_* fields "
                "in domain.analytic (ne, and B with B_on; no inv_brems); "
                "this spec takes route='autograd'")
        return _k7.march(u.contiguous(), spec["ne"], spec.get("B"),
                         layout=layout, **kw)
    return _autograd_march(u, spec, layout, **kw)


def trace_domain_analytic(
    s0: torch.Tensor,
    domain: ScalarDomain,
    *,
    lwl: float = 1064e-9,
    n_steps: Optional[int] = None,
    integrator: str = "rk2",
    atten_sign: float = -1.0,
    route: str = "auto",
):
    """March a (9, N) bundle through ``domain.analytic`` from the probing
    axis's first coordinate to its last: ((N, 8) permuted exit states, the
    exit coordinate as a float32 value). ``n_steps`` defaults to the grid's
    slab count (dims[p_ax] - 1)."""
    if getattr(domain, "analytic", None) is None:
        raise ValueError(
            "domain.analytic is not set: analytic solves need closed-form "
            "closures (test_* constructors provide them; external grids "
            "clear them). Use solver='zscan_seg' for gridded fields.")
    p_ax = _AXIS_OF[domain.probing_direction]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    coords = [c.cpu().numpy() for c in (domain.x, domain.y, domain.z)]
    lo = [float(c[0]) for c in coords]
    hi = [float(c[-1]) for c in coords]
    p0, p1 = lo[p_ax], hi[p_ax]
    if n_steps is None:
        n_steps = coords[p_ax].shape[0] - 1
    u = permute_state(s0, domain.probing_direction).contiguous()
    uf = trace_zscan_analytic(
        u, domain.analytic, layout_of(domain), axes=(a_ax, b_ax, p_ax),
        bounds=(lo, hi), omega=float(constants.omega_from_lwl(lwl)),
        lwl=lwl, p0=p0, h=(p1 - p0) / n_steps, n_steps=n_steps,
        integrator=integrator, atten_sign=atten_sign, route=route)
    return uf, f32(p1)


def solve_zscan_analytic(
    s0: torch.Tensor,
    domain: ScalarDomain,
    probing_depth: Optional[float] = None,
    *,
    lwl: float = 1064e-9,
    n_steps: Optional[int] = None,
    integrator: str = "rk2",
    return_E: bool = False,
    atten_sign: float = -1.0,
    ray_chunk: Optional[int] = None,
    route: str = "auto",
) -> TraceResult:
    """Drop-in z-scan solve on ``domain.analytic`` closures (pack-free).

    ``n_steps`` defaults to the grid's slab count (dims[p_ax] - 1); it may
    be raised or lowered freely, the field being sampled on no grid.
    ``route`` as in ``trace_zscan_analytic``; ``ray_chunk`` has no effect.
    """
    del ray_chunk
    if probing_depth is None:
        probing_depth = domain.extent
    if s0.is_cuda:
        torch.cuda.synchronize(s0.device)
    start = time.perf_counter()
    uf, p_end = trace_domain_analytic(
        s0, domain, lwl=lwl, n_steps=n_steps, integrator=integrator,
        atten_sign=atten_sign, route=route)
    if uf.is_cuda:
        torch.cuda.synchronize(uf.device)
    duration = time.perf_counter() - start
    sf = reassemble_state(uf, p_end, domain.probing_direction)
    rf, Jf = ray_to_Jonesvector(sf, probing_depth,
                                probing_direction=domain.probing_direction,
                                return_E=return_E)
    return TraceResult(rf, Jf, sf, duration)
