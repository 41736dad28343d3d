"""K18: the RK4 stage of the grid-sharded time tracer.

One entry point of ``csrc/sharded_rhs.cu``, run on CUDA tensors, with a
plain PyTorch version on CPU tensors. ``Trace`` holds one ray block's
trace on one device: the (9, N) columns of the step's start state ``s``,
the stage state ``t`` and the running sum ``acc``, the (C, N) partial
``vals``, the shards of the grid line that the device holds, and (on a
card) the launch constants, computed once. ``Trace.stage`` is one launch:

* it finishes stage j (0-3) from the (C, N) channel values summed over the
  grid line: the 9-component derivative and the stage's part of the RK4
  update (``mesh.py:149-163`` and the step of ``:184-192`` of the JAX
  package's ``parallel/mesh.py``);
* then, at the new stage state, it writes into ``vals`` the trilinear
  values of the queries that its shards own (each shard: x-rows [lo, lo +
  nloc) of the channels-last grid and the halo row of its right
  neighbour; ``_rhs_gridsharded``, ``mesh.py:123-148``), zeros elsewhere,
  summed over its shards in shard order.

The first launch of a trace only gathers, the last only updates. The plain
version, ``stage_gather_plain``, composes ``rk4_stage_plain`` and
``gather_owned_plain``. Both round as the compiled JAX program does (the
corner sum and each ``s + c k`` fused; ``time_march.Steps`` for the step
constants), which the plain versions emulate with ``ops.interp.fma``: on
the CPU they reproduce JAX's grid-sharded tracer bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel, refuse_grad
from synthpy_tpu_torch.kernels.time_march import Steps, rhs_of, rk4_last_add
from synthpy_tpu_torch.ops.interp import fma, trilinear

KERNEL = Kernel("sharded_rhs.cu", {
    "stage_gather": [P, P, I, I, P],
}, flags=["--fmad=false"], helpers={
    "sharded_trace_bytes": [],
    "sharded_max_shards": [],
    "sharded_trace_fill": [P, I, P, P, P, P, P, P, P, P, P, L, I, I, I, I,
                           P, P, F, F, F, F, I, I, I],
})


class Shard(NamedTuple):
    """One shard of the grid line: its (nloc, ny, nz, C) x-rows, global
    rows [lo, lo + nloc), the (ny, nz, C) row that follows them (the first
    row of shard 0 for the last shard, as JAX's cyclic ppermute gives it),
    and whether it is the last (its interval closed at nx - 1)."""

    values: torch.Tensor
    halo: torch.Tensor
    lo: int
    last: bool


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
    """(N, C) channel values at the (N, 9) stage states ``t`` that one
    shard (``values``, ``halo``, ``lo``, ``last`` as ``Shard`` has them)
    owns, zeros for the rest; ``origin``, ``inv_spacing``: the global
    grid's."""
    local = torch.cat([values, halo[None]])
    vals = trilinear(local, t[:, 0:3], local_origin(origin, inv_spacing, lo),
                     np.asarray(inv_spacing, np.float32), contract=True)
    mask = _owned(t, origin, inv_spacing, lo, values.shape[0], nx_global,
                  last)
    return torch.where(mask[:, None], vals, torch.zeros_like(vals))


def rk4_stage_plain(s: torch.Tensor, t: torch.Tensor, acc: torch.Tensor,
                    vals: torch.Tensor, stage: int, steps: Steps,
                    layout: ChannelLayout, atten_sign: float) -> None:
    """Stage ``stage`` (0-3) of an RK4 step, in place on the (N, 9) step
    start ``s``, stage state ``t`` and running sum ``acc``, from the summed
    (N, C) channel values ``vals`` at ``t``: the derivative k, the sum
    ((k1 + 2 k2) + 2 k3) + k4 (its last add as ``time_march.rk4_last_add``
    rounds it), the next stage state s + c k and, at stage 3, the step's
    result in ``s`` and ``t``."""
    k = rhs_of(t, vals, layout, atten_sign)
    if stage == 0:
        acc.copy_(k)
    elif stage == 3:
        acc.copy_(rk4_last_add(acc, k, vals, t, layout, atten_sign))
    else:
        acc.copy_(acc + 2 * k)
    if stage == 3:
        s.copy_(fma(steps.h6, acc, s))
        t.copy_(s)
    else:
        t.copy_(fma(steps.dt if stage == 2 else steps.hh, k, s))


def stage_gather_plain(s: torch.Tensor, t: torch.Tensor, acc: torch.Tensor,
                       vals: torch.Tensor, summed: Optional[torch.Tensor],
                       shards: Sequence[Shard], stage: Optional[int],
                       gather: bool, *, origin, inv_spacing, nx_global: int,
                       steps: Steps, layout: ChannelLayout,
                       atten_sign: float = -1.0) -> None:
    """Plain version of one launch, in place on the (9, N) columns ``s``,
    ``t``, ``acc`` and the (C, N) partial ``vals``: ``rk4_stage_plain`` of
    stage ``stage`` (None: none) from the (C, N) ``summed`` values, then,
    when ``gather``, ``gather_owned_plain`` of each shard at the new stage
    state, added in shard order."""
    if stage is not None:
        rk4_stage_plain(s.T, t.T, acc.T, summed.T, stage, steps, layout,
                        atten_sign)
    if not gather:
        return
    part = None
    for sh in shards:
        v = gather_owned_plain(t.T, sh.values, sh.halo, origin=origin,
                               inv_spacing=inv_spacing, lo=sh.lo,
                               nx_global=nx_global, last=sh.last)
        part = v if part is None else part + v
    vals.copy_(part.T)


def _check(x: torch.Tensor, name: str, shape, dev) -> None:
    if (x.device != dev or x.dtype != torch.float32
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} "
                         "float32 tensor on the states' device")


def _table(tr: "Trace") -> ctypes.Array:
    """The launch constants of ``tr``'s trace, checked, as
    ``csrc/sharded_rhs.cu``'s ``sharded_trace_fill`` lays them out."""
    s, shards, kw = tr.s, tr.shards, tr.kw
    layout, steps = kw["layout"], kw["steps"]
    C, dev, G = layout.n_channels, s.device, len(shards)
    _check(s, "s", (9, s.shape[1]), dev)
    nloc, ny, nz = shards[0].values.shape[:3]
    for sh in shards:
        _check(sh.values, "values", (nloc, ny, nz, C), dev)
        _check(sh.halo, "halo", (ny, nz, C), dev)
    lib = KERNEL.load()
    ox = [float(local_origin(kw["origin"], kw["inv_spacing"], sh.lo)[0])
          for sh in shards]
    table = ctypes.create_string_buffer(lib.sharded_trace_bytes())
    rc = lib.sharded_trace_fill(
        table, G, (P * G)(*(sh.values.data_ptr() for sh in shards)),
        (P * G)(*(sh.halo.data_ptr() for sh in shards)), (F * G)(*ox),
        (I * G)(*(sh.lo for sh in shards)),
        (I * G)(*(int(sh.last) for sh in shards)), tr.s.data_ptr(),
        tr.t.data_ptr(), tr.acc.data_ptr(), tr.vals.data_ptr(), s.shape[1],
        nloc, ny, nz, kw["nx_global"],
        (F * 3)(*np.asarray(kw["origin"], np.float32).tolist()),
        (F * 3)(*np.asarray(kw["inv_spacing"], np.float32).tolist()),
        steps.dt, steps.hh, steps.h6, float(kw["atten_sign"]),
        int(layout.inv_brems), int(layout.phaseshift), int(layout.B_on))
    if rc != 0:
        raise ValueError(f"a device holds 1 to {lib.sharded_max_shards()} "
                         f"shards of a grid line, not {G}")
    return table


class Trace:
    """One ray block's grid-sharded trace on one device.

    ``s``: the (9, N) float32 columns of the rays' states (marched in
    place; the result is in ``s`` after the last launch); ``shards``: the
    shards of the grid line this device holds, in shard order (on a card
    at most the kernel's ``MAX_SHARDS``); ``origin``, ``inv_spacing``: the
    global grid's. ``vals`` is the (C, N) partial each gathering launch
    writes. On a card the launch constants (the shard table, origins,
    intervals and step constants) are computed here, once, and the kernel
    leaves ``t`` and ``acc`` after a step's last stage as it found them
    (they are not read again); the plain version writes the step's result
    into ``t`` and the last sum into ``acc``."""

    def __init__(self, s: torch.Tensor, shards: Sequence[Shard], *, origin,
                 inv_spacing, nx_global: int, steps: Steps,
                 layout: ChannelLayout, atten_sign: float = -1.0):
        C = layout.n_channels
        dev = s.device
        if not shards:
            raise ValueError("a device holds at least one shard of the "
                             "grid line")
        self.s, self.t = s, s.clone()
        self.acc = torch.empty_like(s)
        self.vals = torch.empty((C, s.shape[1]), dtype=s.dtype, device=dev)
        self.shards = list(shards)
        self.kw = dict(origin=origin, inv_spacing=inv_spacing,
                       nx_global=nx_global, steps=steps, layout=layout,
                       atten_sign=atten_sign)
        if dev.type == "cpu":
            return
        refuse_grad("sharded_rhs.Trace (K18)", s,
                    *(x for sh in shards for x in sh[:2]))
        self._trace = _table(self)
        self._addr = ctypes.addressof(self._trace)

    def stage(self, summed: Optional[torch.Tensor], stage: Optional[int],
              gather: bool) -> None:
        """One launch: finish ``stage`` (0-3; None for the trace's first
        launch) from the (C, N) ``summed`` values at the stage state (the
        sum of the line's partials; ``vals`` itself when this device holds
        the whole line), then, when ``gather`` (False for the trace's last
        launch), write the partial at the new stage state into ``vals``."""
        if stage is not None and not 0 <= stage <= 3:
            raise ValueError(f"stage {stage} is not 0-3")
        if self.s.device.type == "cpu":
            stage_gather_plain(self.s, self.t, self.acc, self.vals, summed,
                               self.shards, stage, gather, **self.kw)
            return
        if stage is not None:
            _check(summed, "summed", self.vals.shape, self.s.device)
        KERNEL.launch("stage_gather", self.s.device, self._addr,
                      None if stage is None else summed.data_ptr(),
                      -1 if stage is None else int(stage), int(gather))
