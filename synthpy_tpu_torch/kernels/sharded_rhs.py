"""K18: the RK4 stage of the grid-sharded time tracer.

Two entry points of ``csrc/sharded_rhs.cu``, run on CUDA tensors, with
plain PyTorch versions on CPU tensors:

* ``gather_owned``: on one shard (x-rows [lo, lo + nloc) of the
  channels-last grid and the halo row of its right neighbour), the
  trilinear channel values at the stage points the shard owns and zeros
  elsewhere (the JAX package's ``_rhs_gridsharded``, ``parallel/
  mesh.py:123-148``);
* ``rk4_stage``: after the psum of the shards' values over the grid axis,
  the 9-component derivative and the stage's part of the RK4 update, in
  place (``mesh.py:149-163`` and the step of ``:184-192``).

Both round as the compiled JAX program does (the corner sum and each
``s + c k`` fused; ``time_march.Steps`` for the step constants), which the
plain versions emulate with ``ops.interp.fma``: on the CPU they reproduce
JAX's grid-sharded tracer bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel, refuse_grad
from synthpy_tpu_torch.kernels.time_march import Steps, rhs_of
from synthpy_tpu_torch.ops.interp import fma, trilinear

KERNEL = Kernel("sharded_rhs.cu", {
    "gather_owned": [P, P, L, P, P, I, I, I, F, F, F, F, F, F, F, I, I, I,
                     I, I, I, P],
    "rk4_stage": [P, P, P, P, L, I, F, F, F, F, I, I, I, P],
}, flags=["--fmad=false"])


def local_origin(origin, inv_spacing, lo: int) -> np.ndarray:
    """The float32 origin of a shard's grid whose first x-row is global row
    ``lo``: origin_x + lo / inv_x, as the JAX program computes it."""
    o = np.asarray(origin, np.float32).copy()
    iv = np.asarray(inv_spacing, np.float32)
    o[0] = np.float32(o[0] + np.float32(np.float32(lo) / iv[0]))
    return o


def _owned(t: torch.Tensor, origin, inv_spacing, lo: int, nloc: int,
           nx_global: int, last: bool) -> torch.Tensor:
    tx = ((t[:, 0] - float(np.float32(origin[0])))
          * float(np.float32(inv_spacing[0])))
    upper = tx < lo + nloc
    if last:
        upper = upper | (tx <= nx_global - 1)
    return (tx >= lo) & upper


def gather_owned_plain(t: torch.Tensor, values: torch.Tensor,
                       halo: torch.Tensor, *, origin, inv_spacing, lo: int,
                       nx_global: int, last: bool) -> torch.Tensor:
    """Plain version of ``gather_owned``."""
    local = torch.cat([values, halo[None]])
    vals = trilinear(local, t[:, 0:3], local_origin(origin, inv_spacing, lo),
                     np.asarray(inv_spacing, np.float32), contract=True)
    mask = _owned(t, origin, inv_spacing, lo, values.shape[0], nx_global,
                  last)
    return torch.where(mask[:, None], vals, torch.zeros_like(vals))


def gather_owned(t: torch.Tensor, values: torch.Tensor, halo: torch.Tensor,
                 *, origin, inv_spacing, lo: int, nx_global: int,
                 last: bool, layout: ChannelLayout) -> torch.Tensor:
    """(N, C) channel values at the (N, 9) stage states ``t`` that this
    shard owns, zeros for the rest. ``values``: the shard's (nloc, ny, nz,
    C) x-rows, global rows [lo, lo + nloc); ``halo``: the (ny, nz, C) row
    that follows them (the first row of shard 0 for the last shard);
    ``origin``, ``inv_spacing``: the global grid's; ``last``: the shard
    whose interval is closed at ``nx_global - 1``."""
    kw = dict(origin=origin, inv_spacing=inv_spacing, lo=lo,
              nx_global=nx_global, last=last)
    if t.device.type == "cpu":
        return gather_owned_plain(t, values, halo, **kw)
    refuse_grad("sharded_rhs.gather_owned (K18)", t, values, halo)
    C = layout.n_channels
    dev = t.device
    if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 9
            or not t.is_contiguous()):
        raise ValueError("t must be a contiguous (N, 9) float32 tensor")
    nloc, ny, nz = values.shape[:3]
    for name, x, shape in (("values", values, (nloc, ny, nz, C)),
                           ("halo", halo, (ny, nz, C))):
        if (x.device != dev or x.dtype != torch.float32
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} float32 "
                             "tensor on the states' device")
    vals = torch.empty((t.shape[0], C), dtype=torch.float32, device=dev)
    lo_o = local_origin(origin, inv_spacing, lo)
    iv = np.asarray(inv_spacing, np.float32)
    KERNEL.launch(
        "gather_owned", dev, t.data_ptr(), vals.data_ptr(), t.shape[0],
        values.data_ptr(), halo.data_ptr(), nloc, ny, nz,
        *(float(x) for x in lo_o), *(float(x) for x in iv),
        float(np.float32(origin[0])), int(lo), int(nx_global), int(last),
        int(layout.inv_brems), int(layout.phaseshift), int(layout.B_on))
    return vals


def rk4_stage_plain(s: torch.Tensor, t: torch.Tensor, acc: torch.Tensor,
                    vals: torch.Tensor, stage: int, steps: Steps,
                    layout: ChannelLayout, atten_sign: float) -> None:
    """Plain version of ``rk4_stage`` (in place)."""
    k = rhs_of(t, vals, layout, atten_sign)
    if stage == 0:
        acc.copy_(k)
    elif stage == 3:
        acc.copy_(acc + k)
    else:
        acc.copy_(acc + 2 * k)
    if stage == 3:
        s.copy_(fma(steps.h6, acc, s))
        t.copy_(s)
    else:
        t.copy_(fma(steps.dt if stage == 2 else steps.hh, k, s))


def rk4_stage(s: torch.Tensor, t: torch.Tensor, acc: torch.Tensor,
              vals: torch.Tensor, stage: int, steps: Steps,
              layout: ChannelLayout, atten_sign: float = -1.0) -> None:
    """Stage ``stage`` (0-3) of an RK4 step, in place on the (N, 9) step
    start ``s``, stage state ``t`` and running sum ``acc``, from the summed
    (N, C) channel values ``vals`` at ``t``: the derivative k, the sum
    ((k1 + 2 k2) + 2 k3) + k4, the next stage state s + c k and, at stage
    3, the step's result in ``s`` and ``t``."""
    if s.device.type == "cpu":
        return rk4_stage_plain(s, t, acc, vals, stage, steps, layout,
                               atten_sign)
    refuse_grad("sharded_rhs.rk4_stage (K18)", s, t, acc, vals)
    C = layout.n_channels
    for name, x, cols in (("s", s, 9), ("t", t, 9), ("acc", acc, 9),
                          ("vals", vals, C)):
        if (x.device != s.device or x.dtype != torch.float32 or x.dim() != 2
                or x.shape != (s.shape[0], cols) or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (N, {cols}) "
                             "float32 tensor on the states' device")
    if not 0 <= stage <= 3:
        raise ValueError(f"stage {stage} is not 0-3")
    KERNEL.launch(
        "rk4_stage", s.device, s.data_ptr(), t.data_ptr(), acc.data_ptr(),
        vals.data_ptr(), s.shape[0], int(stage), steps.dt, steps.hh,
        steps.h6, float(atten_sign), int(layout.inv_brems),
        int(layout.phaseshift), int(layout.B_on))
