"""K7: the pack-free analytic march (closed-form fields, no pack, no gathers).

``march`` launches the CUDA kernel of ``csrc/analytic.cu`` on CUDA tensors
and runs ``march_plain`` on CPU tensors. Both take the field as
``fields.forms.ClosedForm``s, the closures the ``test_*`` constructors put
in ``domain.analytic``. The plain version is the JAX package's
``_trace_analytic_jit`` step (``synthpy_tpu/tracer/analytic.py:122-143``)
over ``_analytic_vals`` (:51), with each form's gradient written out by
hand (``ClosedForm.grad``) in place of ``jax.grad``, and with the rounding
XLA's CPU compiler gives the compiled JAX step: each ``u + c * k`` a fused
multiply-add (``ops.interp.fma``), ``h / 6`` as ``h * f32(1/6)``, and step
``i``'s probing coordinate ``fma(i, h, p0)``. ``integrate`` and
``channel_values`` are shared with the closure route of
``tracer.analytic``, which differentiates a user's closures with autograd.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from synthpy_tpu_torch import constants
from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.fields.forms import N_PARAMS, ClosedForm, f32
from synthpy_tpu_torch.kernels._build import I, L, P, Kernel, refuse_grad
from synthpy_tpu_torch.kernels.slab_march import cols_rhs
from synthpy_tpu_torch.ops.interp import fma

KERNEL = Kernel("analytic.cu", {
    "analytic_march": [P, P, L, I, I, I, I, I, I, P, P],
}, flags=["--fmad=false"])

# the columns (a, b, va, vb) swapped, for axes whose (a, b) are not in
# order: the kernel's instances take the transverse axes of p in order
_SWAP_AB = [1, 0, 3, 2, 4, 5, 6, 7]

# the ne profiles the kernel evaluates (analytic.cu enum Form)
NE_FORMS = ("null", "slab", "linear_cos", "exponential_cos", "lens", "liner")


class Steps(NamedTuple):
    """The float32 step constants: p0, h, 0.5 h and h / 6 as the compiled
    JAX step rounds them (``h * f32(1/6)``), from ``h`` in double."""

    p0: float
    h: float
    hh: float
    h6: float

    @classmethod
    def of(cls, p0: float, h: float) -> "Steps":
        h32 = np.float32(h)
        return cls(f32(p0), float(h32), float(np.float32(0.5) * h32),
                   float(h32 * np.float32(1.0 / 6.0)))

    def p(self, i: int) -> float:
        """Step i's probing coordinate fma(i, h, p0): the float64 sum of
        these float32 values is exact, so one rounding gives the fma."""
        return f32(i * self.h + self.p0)


class Consts(NamedTuple):
    """The float32 constants of the channel values."""

    scale: float    # -c^2 / (2 nc): acceleration per d(ne)/dx
    omega: float
    verdet: float

    @classmethod
    def of(cls, omega: float, lwl: float) -> "Consts":
        nc = constants.critical_density(omega)
        return cls(f32(-0.5 * constants.C**2 / nc), f32(omega),
                   f32(constants.verdet_constant(lwl)))


def positions(u: torch.Tensor, p: float, axes: Sequence[int]):
    """(x, y, z) of permuted states u at probing coordinate p."""
    a_ax, b_ax, p_ax = axes
    xyz = [None, None, None]
    xyz[a_ax], xyz[b_ax] = u[:, 0], u[:, 1]
    xyz[p_ax] = torch.full_like(u[:, 0], p)
    return xyz


def channel_values(xyz, grad, layout: ChannelLayout, axes, bounds,
                   c: Consts, omega: float, ne=None, kappa=None,
                   B=None) -> torch.Tensor:
    """(N, C) channels at points ``xyz`` (``_analytic_vals``): the three
    accelerations ``scale * grad`` permuted to (a, b, p), then kappa,
    omega (n - 1) and Verdet ne B (permuted) as the layout has them, zero
    outside the box ``bounds`` = (lo, hi)."""
    a_ax, b_ax, p_ax = axes
    chans = [c.scale * grad[a_ax], c.scale * grad[b_ax],
             c.scale * grad[p_ax]]
    if layout.inv_brems:
        chans.append(kappa)
    if layout.phaseshift:
        chans.append(c.omega * (constants.n_refrac(ne, omega) - 1.0))
    if layout.B_on:
        w = c.verdet * ne
        W = [w * torch.broadcast_to(Bi, w.shape) for Bi in B]
        chans += [W[a_ax], W[b_ax], W[p_ax]]
    x, y, z = xyz
    vals = torch.stack([torch.broadcast_to(v, x.shape) for v in chans], 1)
    lo, hi = bounds
    inside = ((x >= lo[0]) & (x <= hi[0]) & (y >= lo[1]) & (y <= hi[1])
              & (z >= lo[2]) & (z <= hi[2]))
    return torch.where(inside[:, None], vals, torch.zeros_like(vals))


def integrate(u: torch.Tensor, deriv: Callable, steps: Steps, n_steps: int,
              integrator: str) -> torch.Tensor:
    """``n_steps`` rk2 (midpoint) or rk4 steps of du/dp = deriv(u, p)."""
    hh, h, h6 = steps.hh, steps.h, steps.h6
    for i in range(n_steps):
        p = steps.p(i)
        ph = f32(p + hh)
        k1 = deriv(u, p)
        k2 = deriv(fma(hh, k1, u), ph)
        if integrator == "rk2":
            u = fma(h, k2, u)
            continue
        k3 = deriv(fma(hh, k2, u), ph)
        k4 = deriv(fma(h, k3, u), f32(p + h))
        u = fma(h6, k1 + 2 * k2 + 2 * k3 + k4, u)
    return u


def unsupported(ne, B, layout: ChannelLayout) -> Optional[str]:
    """Why K7 cannot evaluate the closures ``ne`` and ``B`` on ``layout``,
    or None when it can: it takes the closed forms of the test_* fields,
    and no inverse bremsstrahlung (no form carries Te or Z)."""
    if not isinstance(ne, ClosedForm) or ne.kind not in NE_FORMS:
        return f"K7 evaluates the ne forms {NE_FORMS}, not {ne!r}"
    if layout.inv_brems:
        return "inv_brems needs 'Te' and 'Z' closures in domain.analytic"
    if layout.B_on and (not isinstance(B, ClosedForm)
                        or B.kind != "bz_linear"):
        return f"K7 evaluates B as test_B's form, not {B!r}"
    return None


def check_forms(ne, B, layout: ChannelLayout) -> None:
    """Raise unless K7 can evaluate these closures on this layout."""
    why = unsupported(ne, B, layout)
    if why is not None:
        raise ValueError(why)


def march_plain(u: torch.Tensor, ne: ClosedForm, B: Optional[ClosedForm], *,
                layout: ChannelLayout, axes: Tuple[int, int, int], bounds,
                omega: float, lwl: float, p0: float, h: float, n_steps: int,
                integrator: str = "rk2",
                atten_sign: float = -1.0) -> torch.Tensor:
    """Plain version of the march: (N, 8) permuted states in and out."""
    check_forms(ne, B, layout)
    c = Consts.of(omega, lwl)
    lo, hi = ([f32(v) for v in b] for b in bounds)

    def deriv(uu, p):
        xyz = positions(uu, p, axes)
        need_ne = layout.phaseshift or layout.B_on
        vals = channel_values(
            xyz, ne.grad(*xyz), layout, axes, (lo, hi), c, omega,
            ne=ne(*xyz) if need_ne else None,
            B=B(*xyz) if layout.B_on else None)
        return cols_rhs(uu, vals, layout, atten_sign)

    return integrate(u, deriv, Steps.of(p0, h), n_steps, integrator)


def march(u: torch.Tensor, ne: ClosedForm, B: Optional[ClosedForm], *,
          layout: ChannelLayout, axes: Tuple[int, int, int], bounds,
          omega: float, lwl: float, p0: float, h: float, n_steps: int,
          integrator: str = "rk2", atten_sign: float = -1.0) -> torch.Tensor:
    """March (N, 8) permuted rays ``n_steps`` steps of ``h`` from ``p0``
    through the closed-form field ``ne`` (and ``B``); ``bounds`` = (lo, hi)
    are the domain box's corners."""
    if integrator not in ("rk2", "rk4"):
        raise ValueError(f"unknown integrator {integrator!r} "
                         "(analytic march: rk2 | rk4)")
    kw = dict(layout=layout, axes=axes, bounds=bounds, omega=omega, lwl=lwl,
              p0=p0, h=h, n_steps=n_steps, integrator=integrator,
              atten_sign=atten_sign)
    if u.device.type == "cpu":
        return march_plain(u, ne, B, **kw)
    refuse_grad("analytic.march (K7)", u)
    check_forms(ne, B, layout)
    if (u.dtype != torch.float32 or u.dim() != 2 or u.shape[1] != 8
            or not u.is_contiguous()):
        raise ValueError("u must be a contiguous (N, 8) float32 tensor")
    if sorted(axes) != [0, 1, 2]:
        raise ValueError(f"axes {tuple(axes)} are not a permutation of "
                         "(0, 1, 2)")
    a_ax, b_ax, p_ax = (int(a) for a in axes)
    swap = a_ax > b_ax
    if swap:
        # the same march with (a, b) in order: every column's arithmetic
        # is its own, so swapping the columns there and back is exact
        u = u[:, _SWAP_AB].contiguous()
    # the kernel reads states as 16-byte vectors: a fresh allocation is
    # aligned
    if u.data_ptr() % 16:
        u = u.clone()
    out = torch.empty_like(u)
    st = Steps.of(p0, h)
    c = Consts.of(omega, lwl)
    nc_coef = constants.OMEGA_PE_COEFF**2 * 1e-6 / omega**2
    lo, hi = bounds
    bparams = B.params[:2] if B is not None else (0.0, 0.0)
    f = np.array([st.p0, st.h, st.hh, st.h6, atten_sign, c.scale, c.omega,
                  nc_coef, c.verdet, *lo, *hi, *ne.params[:N_PARAMS],
                  *bparams], np.float32)
    KERNEL.launch(
        "analytic_march", u.device, u.data_ptr(), out.data_ptr(),
        u.shape[0], NE_FORMS.index(ne.kind), int(n_steps),
        int(integrator == "rk4"), p_ax, int(layout.phaseshift),
        int(layout.B_on), f.ctypes.data)
    return out[:, _SWAP_AB].contiguous() if swap else out
