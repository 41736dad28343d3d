"""K5: the time-domain march (fixed-step RK4 of the (N, 9) ray rows).

``march`` launches the CUDA kernel of ``csrc/time_march.cu`` on CUDA tensors
and runs ``march_plain`` on CPU tensors. The plain version is the JAX
package's ``trace_rk4`` step (``synthpy_tpu/tracer/propagator.py:105-113``)
over ``rhs`` (its ``_rhs``, :56) and ``ops.interp.trilinear``, vectorised
over rays with a Python loop over steps, with the multiply-adds fused
where XLA's CPU compiler fuses them in the compiled JAX step (the corner
sum, ``s + c * k`` and the update): on the CPU it is then bit-equal to the
JAX program. On CUDA tensors the wrapper hands the rays to the kernel in
entry-cell order (``kernels.march.ray_order`` of the 3-D cell); each
ray's result goes back to its own row. ``launch`` runs a given build of
the kernel in a given order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel, refuse_grad
from synthpy_tpu_torch.kernels.march import ray_order
from synthpy_tpu_torch.ops.interp import fma, trilinear

KERNEL = Kernel("time_march.cu", {
    "time_march": [P, P, P, L, P, I, I, I, F, F, F, F, F, F, I, F, F, F, F,
                   I, I, I, P],
}, flags=["--fmad=false"])


class Steps(NamedTuple):
    """The float32 step constants the plain version and the kernel share:
    dt, 0.5*dt and dt/6 as the compiled JAX step rounds them (XLA folds
    the division by 6 into ``dt * f32(1/6)``)."""

    dt: float
    hh: float
    h6: float

    @classmethod
    def of(cls, dt) -> "Steps":
        d = np.float32(float(dt))
        return cls(float(d), float(np.float32(0.5) * d),
                   float(d * np.float32(1.0 / 6.0)))


def rhs(s: torch.Tensor, channels: torch.Tensor, origin, inv_spacing,
        layout: ChannelLayout, atten_sign: float) -> torch.Tensor:
    """ds/dt of (N, 9) rays: one trilinear gather of every channel (its
    corner sum contracted, as in the compiled JAX step)."""
    vals = trilinear(channels, s[:, 0:3], origin, inv_spacing,
                     contract=True)
    return rhs_of(s, vals, layout, atten_sign)


def rhs_of(s: torch.Tensor, vals: torch.Tensor, layout: ChannelLayout,
           atten_sign: float) -> torch.Tensor:
    """ds/dt of (N, 9) rays from their (N, C) channel values."""
    v = s[:, 3:6]
    zeros = torch.zeros_like(s[:, 0:1])
    d_amp = (atten_sign * vals[:, layout.kappa_index:layout.kappa_index + 1]
             * s[:, 6:7] if layout.inv_brems else zeros)
    d_phase = (vals[:, layout.phase_index:layout.phase_index + 1]
               if layout.phaseshift else zeros)
    if layout.B_on:
        fi = layout.faraday_index
        d_pol = (vals[:, fi:fi + 1] * v[:, 0:1]
                 + vals[:, fi + 1:fi + 2] * v[:, 1:2]
                 + vals[:, fi + 2:fi + 3] * v[:, 2:3])
    else:
        d_pol = zeros
    return torch.cat([v, vals[:, 0:3], d_amp, d_phase, d_pol], dim=1)


def march_plain(s_rows: torch.Tensor, channels: torch.Tensor, origin,
                inv_spacing, dt, *, layout: ChannelLayout, n_steps: int,
                atten_sign: float = -1.0) -> torch.Tensor:
    """Plain version of the march: (N, 9) rows in and out."""
    st = Steps.of(dt)
    origin = torch.as_tensor(np.asarray(origin, np.float32),
                             device=s_rows.device).to(s_rows.dtype)
    inv = torch.as_tensor(np.asarray(inv_spacing, np.float32),
                          device=s_rows.device).to(s_rows.dtype)

    def f(s):
        return rhs(s, channels, origin, inv, layout, atten_sign)

    s = s_rows
    for _ in range(n_steps):
        k1 = f(s)
        k2 = f(fma(st.hh, k1, s))
        k3 = f(fma(st.hh, k2, s))
        t4 = fma(st.dt, k3, s)
        vals4 = trilinear(channels, t4[:, 0:3], origin, inv, contract=True)
        k4 = rhs_of(t4, vals4, layout, atten_sign)
        s = fma(st.h6, rk4_last_add(k1 + 2 * k2 + 2 * k3, k4, vals4, t4,
                                    layout, atten_sign), s)
    return s


def rk4_last_add(acc, k4, vals4, t4, layout: ChannelLayout,
                 atten_sign: float) -> torch.Tensor:
    """The step's slope sum ((k1 + 2 k2) + 2 k3) + k4 from its first three
    terms ``acc``, as the compiled JAX step rounds it: XLA's CPU compiler
    fuses k4's amplitude derivative (atten_sign kappa) amp, whose factors
    are k4's channel values ``vals4`` and stage state ``t4``, into the last
    add; every other column adds k4 as it is."""
    out = acc + k4
    if layout.inv_brems:
        ki = layout.kappa_index
        out[:, 6:7] = fma(atten_sign * vals4[:, ki:ki + 1], t4[:, 6:7],
                          acc[:, 6:7])
    return out


def check_grid(s_rows: torch.Tensor, channels: torch.Tensor,
               layout: ChannelLayout) -> None:
    """Raise unless the rows and the grid are what K5 and K6 take."""
    if (s_rows.dtype != torch.float32 or s_rows.dim() != 2
            or s_rows.shape[1] != 9 or not s_rows.is_contiguous()):
        raise ValueError("s_rows must be a contiguous (N, 9) float32 tensor")
    if (channels.device != s_rows.device or channels.dtype != torch.float32
            or channels.dim() != 4 or not channels.is_contiguous()
            or channels.shape[-1] != layout.n_channels):
        raise ValueError(
            "channels must be a contiguous (nx, ny, nz, C) float32 tensor "
            f"with C = {layout.n_channels} on the rays' device")


def grid_args(channels: torch.Tensor, origin, inv_spacing):
    """The grid's pointer, dims, origin and inverse spacings as the C entry
    points take them."""
    o = np.asarray(origin, np.float32)
    v = np.asarray(inv_spacing, np.float32)
    nx, ny, nz, _ = channels.shape
    return (channels.data_ptr(), nx, ny, nz, *(float(x) for x in o),
            *(float(x) for x in v))


def march(s_rows: torch.Tensor, channels: torch.Tensor, origin, inv_spacing,
          dt, *, layout: ChannelLayout, n_steps: int,
          atten_sign: float = -1.0) -> torch.Tensor:
    """Integrate (N, 9) rays for ``n_steps`` RK4 steps of ``dt`` through
    the channels-last grid. On CUDA tensors the kernel marches the rays in
    ``ray_order``; the result does not depend on the order."""
    if s_rows.device.type == "cpu":
        return march_plain(s_rows, channels, origin, inv_spacing, dt,
                           layout=layout, n_steps=n_steps,
                           atten_sign=atten_sign)
    refuse_grad("time_march.march (K5)", s_rows, channels)
    check_grid(s_rows, channels, layout)
    order = ray_order(s_rows, channels.shape[:3], origin, inv_spacing)
    return launch(KERNEL, s_rows, channels, origin, inv_spacing, dt, order,
                  layout=layout, n_steps=n_steps, atten_sign=atten_sign)


def launch(kernel: Kernel, s_rows: torch.Tensor, channels: torch.Tensor,
           origin, inv_spacing, dt, order: torch.Tensor, *,
           layout: ChannelLayout, n_steps: int,
           atten_sign: float = -1.0) -> torch.Tensor:
    """Launch ``kernel`` (a build of ``csrc/time_march.cu``) on checked
    inputs, marching ray ``order[i]`` i-th."""
    out = torch.empty_like(s_rows)
    st = Steps.of(dt)
    kernel.launch(
        "time_march", s_rows.device, s_rows.data_ptr(), out.data_ptr(),
        order.data_ptr(), s_rows.shape[0],
        *grid_args(channels, origin, inv_spacing), int(n_steps), st.dt,
        st.hh, st.h6, float(atten_sign), int(layout.inv_brems),
        int(layout.phaseshift), int(layout.B_on))
    return out
