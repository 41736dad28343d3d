"""K6: the adaptive Dormand-Prince 5(4) march (one shared step a launch).

``trace_rk45`` runs the CUDA kernels of ``csrc/adaptive.cu`` on CUDA tensors
and ``trace_rk45_plain`` on CPU tensors. Both repeat the JAX package's
``trace_rk45`` (``synthpy_tpu/tracer/adaptive.py:53``): the tableau and the
stage sums in float32 in the JAX order, each ``x + c * k`` a fused
multiply-add as XLA's CPU compiler makes it in the compiled JAX step, then
the error norm, whose mean is summed in float64 (the JAX program sums in
float32; in float64 the sum, and so every accept, does not depend on the
order of the terms), then the controller in float32. On the CPU the plain
version is bit-equal to the JAX program at the sizes of the tests. The
loop stays on the host: the kernel path launches steps in batches of
``CHECK_EVERY`` and reads the device's ``done`` flag between batches
(steps launched after it is set return at once).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from synthpy_tpu_torch.constants import C
from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels import time_march
from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel, refuse_grad
from synthpy_tpu_torch.kernels.march import ray_order
from synthpy_tpu_torch.ops.interp import fma

_COMMON = [P, P, L, P, P, P, P, P, P, P, P, P, I, I, I]
KERNEL = Kernel("adaptive.cu", {
    "rk45_init": _COMMON + [F, P],
    "rk45_step": _COMMON + [P],
}, flags=["--fmad=false"])

CHECK_EVERY = 16   # steps launched between two reads of the done flag
THREADS = 128      # rays a block of step_kernel (adaptive.cu)

# Dormand-Prince 5(4) tableau (scipy's RK45), as the JAX package spells it
_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
       187 / 2100, 1 / 40)

f32 = np.float32


class Consts(NamedTuple):
    """The float32 constants of one trace, as the JAX program rounds them
    (Python floats meeting float32 arrays round to float32)."""

    t_end: np.float32
    cell_cap: np.float32
    cap_num: np.float32      # atol * min(2e-3, cell)
    dt_max: np.float32       # the global cap
    dt0: np.float32
    cell_p: np.float32
    plane_o: np.float32
    rtol: np.float32
    atol_col: np.ndarray     # (9,) atol * column scale

    @classmethod
    def of(cls, origin, inv_spacing, a_max: float, t_end, rtol: float,
           atol: float, p_axis: Optional[int]) -> "Consts":
        inv = np.asarray(inv_spacing, f32)
        te = f32(float(t_end))
        cell = f32(1.0) / inv.max()
        cell_cap = f32(0.5) * cell / f32(C)
        cap_num = f32(atol) * min(f32(2e-3), cell)
        dt_max = cap_of(f32(a_max), cell_cap, cap_num, te)
        ax = 0 if p_axis is None else p_axis
        col = np.array([1e-3] * 3 + [C] * 3 + [1.0] * 3, f32)
        return cls(te, cell_cap, cap_num, dt_max,
                   min(te / f32(100.0), dt_max), f32(1.0) / inv[ax],
                   f32(np.asarray(origin, f32)[ax]), f32(rtol),
                   f32(atol) * col)

    def table(self, atten_sign: float) -> np.ndarray:
        """The float table of adaptive.cu's make_params."""
        a = [v for row in _A[1:] for v in row]
        e = [b5 - b4 for b5, b4 in zip(_B5, _B4)]
        return np.array([atten_sign, self.plane_o, self.cell_p, f32(C),
                         self.t_end, self.cell_cap, self.cap_num,
                         self.dt_max, self.rtol, *self.atol_col, *a, *_B5,
                         *e], f32)


def cap_of(a, cell_cap, cap_num, t_end):
    """The step cap for peak acceleration ``a`` (float32 scalars)."""
    return max(cell_cap, cap_num / (a * t_end) if a > 0 else f32(np.inf))


def plane_amax_of(channels: torch.Tensor, p_axis: int) -> torch.Tensor:
    """(n_p,) peak |acceleration| of each probing-axis plane."""
    other = tuple(i for i in range(3) if i != p_axis) + (3,)
    return torch.amax(torch.abs(channels[..., :3]), dim=other)


def trace_rk45_plain(s_rows: torch.Tensor, channels: torch.Tensor, origin,
                     inv_spacing, t_end, *, layout: ChannelLayout,
                     rtol: float = 1e-6, atol: float = 1e-3,
                     max_steps: int = 4096, atten_sign: float = -1.0,
                     plane_amax: Optional[torch.Tensor] = None,
                     p_axis: Optional[int] = None
                     ) -> Tuple[torch.Tensor, int, int]:
    """Plain version: (s_final, n_accepted, n_rejected)."""
    dev = s_rows.device
    a_max = float(torch.abs(channels[..., :3]).max())
    k = Consts.of(origin, inv_spacing, a_max, t_end, rtol, atol, p_axis)
    o_t = torch.as_tensor(np.asarray(origin, f32), device=dev)
    i_t = torch.as_tensor(np.asarray(inv_spacing, f32), device=dev)

    def f(s):
        return time_march.rhs(s, channels, o_t, i_t, layout, atten_sign)

    def scal(v):
        return torch.tensor(float(v), dtype=torch.float32, device=dev)

    te = scal(k.t_end)
    if plane_amax is not None:
        plane_p = (torch.arange(plane_amax.shape[0], dtype=torch.float32,
                                device=dev) * float(k.cell_p)
                   + float(k.plane_o))

    def local_cap(s, dt):
        if plane_amax is None:
            return scal(k.dt_max)
        p = s[:, p_axis]
        lo = p.min() - float(k.cell_p) - float(f32(C)) * dt
        hi = p.max() + float(k.cell_p) + float(f32(C)) * dt
        a = torch.where((plane_p >= lo) & (plane_p <= hi), plane_amax,
                        0.0).max()
        return torch.maximum(scal(k.cell_cap), torch.where(
            a > 0, float(k.cap_num) / (a * te), scal(np.inf)))

    atol_col = torch.as_tensor(k.atol_col, device=dev)
    n_terms = s_rows.shape[0] * 9
    t, dt = scal(0.0), scal(k.dt0)
    s, k1 = s_rows, f(s_rows)
    n_acc = n_rej = 0
    while bool(t < te) and n_acc + n_rej < max_steps:
        dt = torch.minimum(torch.minimum(dt, local_cap(s, dt)), te - t)
        ks = [k1]
        for i in range(1, 7):
            si = s
            for j, a in enumerate(_A[i]):
                si = fma(dt * float(f32(a)), ks[j], si)
            ks.append(f(si))
        s5, err = s, torch.zeros_like(s)
        for b5, b4, kk in zip(_B5, _B4, ks):
            s5 = fma(dt * float(f32(b5)), kk, s5)
            err = fma(dt * float(f32(b5 - b4)), kk, err)
        scale = fma(float(k.rtol), torch.maximum(s.abs(), s5.abs()),
                    atol_col.expand_as(s))
        q = err / scale
        err_norm = torch.sqrt((q * q).double().sum() / n_terms).float()
        fac = 0.9 * err_norm ** -0.2
        fac = torch.where(torch.isnan(fac), scal(0.2),
                          torch.clamp(fac, 0.2, 5.0))
        if bool(err_norm <= 1.0):
            t = t + dt
            s, k1 = s5, ks[6]
            n_acc += 1
        else:
            n_rej += 1
        dt = dt * fac
    return s, n_acc, n_rej


def trace_rk45(s_rows: torch.Tensor, channels: torch.Tensor, origin,
               inv_spacing, t_end, *, layout: ChannelLayout,
               rtol: float = 1e-6, atol: float = 1e-3,
               max_steps: int = 4096, atten_sign: float = -1.0,
               plane_amax: Optional[torch.Tensor] = None,
               p_axis: Optional[int] = None
               ) -> Tuple[torch.Tensor, int, int]:
    """Integrate (N, 9) rays to ``t_end`` with shared adaptive steps:
    (s_final, n_accepted, n_rejected). On CUDA tensors the kernels take the
    rays in entry-cell order."""
    kw = dict(layout=layout, rtol=rtol, atol=atol, max_steps=max_steps,
              atten_sign=atten_sign, plane_amax=plane_amax, p_axis=p_axis)
    if s_rows.device.type == "cpu":
        return trace_rk45_plain(s_rows, channels, origin, inv_spacing,
                                t_end, **kw)
    refuse_grad("adaptive.trace_rk45 (K6)", s_rows, channels, plane_amax)
    time_march.check_grid(s_rows, channels, layout)
    if plane_amax is not None and (
            plane_amax.device != s_rows.device
            or plane_amax.dtype != torch.float32
            or not plane_amax.is_contiguous()
            or plane_amax.shape != (channels.shape[p_axis],)):
        raise ValueError("plane_amax must be a contiguous (n_p,) float32 "
                         "tensor on the rays' device")
    if s_rows.shape[0] == 0:
        # no rays: the error norm is 0/0 = NaN, so every step is rejected
        # until max_steps (as in the JAX program); nothing to launch
        return (s_rows.clone(), 0,
                max_steps if f32(0.0) < f32(float(t_end)) else 0)
    order = ray_order(s_rows, channels.shape[:3], origin, inv_spacing)
    return launch(KERNEL, s_rows, channels, origin, inv_spacing, t_end,
                  order, **kw)


class Trace(NamedTuple):
    """A trace's device state and the arguments of its launches (``host``
    keeps alive the host arrays they point to)."""

    args: tuple
    S: torch.Tensor       # (2, N, 9): the state rows, in the trace's order
    ctrl: torch.Tensor    # the controller's 48 bytes
    host: tuple


def start(kernel: Kernel, s_rows: torch.Tensor, channels: torch.Tensor,
          origin, inv_spacing, t_end, order: torch.Tensor, *,
          layout: ChannelLayout, rtol: float = 1e-6, atol: float = 1e-3,
          max_steps: int = 4096, atten_sign: float = -1.0,
          plane_amax: Optional[torch.Tensor] = None,
          p_axis: Optional[int] = None) -> Trace:
    """Stage N >= 1 checked rows in ``order`` and launch ``rk45_init`` of
    ``kernel`` (a build of ``csrc/adaptive.cu``): k1 = f(s0) and the first
    step's dt. Each ``kernel.launch("rk45_step", dev, *trace.args)`` is
    then one step."""
    dev = s_rows.device
    N = s_rows.shape[0]
    a_max = float(torch.abs(channels[..., :3]).max())
    k = Consts.of(origin, inv_spacing, a_max, t_end, rtol, atol, p_axis)
    S = torch.empty((2, N, 9), dtype=torch.float32, device=dev)
    torch.index_select(s_rows, 0, order, out=S[0])
    K1 = torch.empty_like(S)
    n_blocks = -(-N // THREADS)
    part_err = torch.empty(n_blocks, dtype=torch.float64, device=dev)
    part_p = torch.empty((n_blocks, 2), dtype=torch.float32, device=dev)
    ctrl = torch.zeros(12, dtype=torch.int32, device=dev)
    grid = time_march.grid_args(channels, origin, inv_spacing)
    dims = np.array(grid[1:4], np.int32)
    geo = np.array(grid[4:], f32)
    n_p = 0 if plane_amax is None else plane_amax.shape[0]
    ints = np.array([n_p, p_axis or 0, max_steps], np.int32)
    consts = k.table(atten_sign)
    args = (S.data_ptr(), K1.data_ptr(), N, grid[0],
            dims.ctypes.data, geo.ctypes.data, part_err.data_ptr(),
            part_p.data_ptr(), ctrl.data_ptr(),
            None if plane_amax is None else plane_amax.data_ptr(),
            ints.ctypes.data, consts.ctypes.data, int(layout.inv_brems),
            int(layout.phaseshift), int(layout.B_on))
    kernel.launch("rk45_init", dev, *args, float(k.dt0))
    return Trace(args, S, ctrl, (K1, part_err, part_p, plane_amax, dims,
                                 geo, ints, consts))


def launch(kernel: Kernel, s_rows: torch.Tensor, channels: torch.Tensor,
           origin, inv_spacing, t_end, order: torch.Tensor, *,
           max_steps: int = 4096, **kw) -> Tuple[torch.Tensor, int, int]:
    """Run ``kernel`` (a build of ``csrc/adaptive.cu``) on N >= 1 checked
    rows (the keywords of ``start``).

    The state and FSAL rows are kept in ``order`` for the whole trace (ray
    ``order[i]`` in row i), so that each step's block reads and writes
    neighbouring rows; the result goes back to the caller's order at the
    end. A block's rays, and so its partial error sum, are the same as if
    the kernels read through the order."""
    tr = start(kernel, s_rows, channels, origin, inv_spacing, t_end, order,
               max_steps=max_steps, **kw)
    launched = 0
    while launched < max_steps:
        n = min(CHECK_EVERY, max_steps - launched)
        for _ in range(n):
            kernel.launch("rk45_step", s_rows.device, *tr.args)
        launched += n
        if int(tr.ctrl[9]):
            break
    # Ctrl: t, dt_carry, dt_step, pmin, pmax, err_norm (float32), then
    # n_acc, n_rej, cur, done, accepted (int32)
    n_acc, n_rej, cur = (int(v) for v in tr.ctrl[6:9].tolist())
    out = torch.empty_like(s_rows)
    out.index_copy_(0, order, tr.S[cur])
    return out, n_acc, n_rej
