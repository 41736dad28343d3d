"""K13: the Boris push of proton radiography.

``push`` launches ``boris_push`` of ``csrc/boris.cu`` on CUDA tensors and
runs ``push_plain``, its plain PyTorch version, on CPU tensors. Both march
(N, 6) float32 rows [x, y, z, vx, vy, vz] ``n_steps`` relativistic
drift-kick-drift steps through an (nx, ny, nz, 3) B table (float32,
bfloat16, or int8 with (3,) scales), as the JAX package's ``_push_boris``
(``synthpy_tpu/tracer/particles.py:218``) on its CPU backend: the
corner sum, the cross products, the velocity update and the second drift
take the fused multiply-adds XLA's CPU compiler gives the scan body
(found by emulation; see the kernel's header), the rest is rounded
operation by operation. On CUDA tensors the protons are marched in
entry-cell order (``march.ray_order`` of their positions) and each result
is written back to its own row; ``launch`` runs the kernel in a given
order.

The kernel carries each proton's 8 x 3 corner values across steps,
shifts them to a new cell and reads only the nodes outside the old one,
each node from the cell's first node at a 32-bit offset, and takes a step
whose midpoint lies outside the grid (with finite velocities) as its two
drifts alone. ``profiling.walk_model`` models those reads along straight
lines.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from synthpy_tpu_torch.kernels._build import (F, I, L, P, Kernel,
                                              refuse_grad)
from synthpy_tpu_torch.kernels.march import ray_order
from synthpy_tpu_torch.ops.interp import fma, trilinear

KERNEL = Kernel("boris.cu", {
    "boris_push": [P, P, L, P, I, P, I, I, I, F, F, F, F, F, F, F, F, I, P],
}, flags=["--fmad=false"])

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b of (N, 3) rows, each component p q - r s as fma(p, q, -(r s))
    (jnp.cross's component order)."""
    a0, a1, a2 = a.unbind(1)
    b0, b1, b2 = b.unbind(1)
    return torch.stack([fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)),
                        fma(a0, b1, -(a1 * b0))], 1)


def push_plain(rows: torch.Tensor, grid: torch.Tensor,
               scale: Optional[torch.Tensor], origin: Sequence[float],
               inv_spacing: Sequence[float], h: float, wdt: float,
               n_steps: int) -> torch.Tensor:
    """Plain version of ``push``: (N, 6) float32 rows in, a new tensor
    out. ``h`` is dt / 2 and ``wdt`` the rotation factor (w / 2) dt, both
    float32 values."""
    dev = rows.device
    o = torch.tensor(list(origin), dtype=torch.float32, device=dev)
    inv = torch.tensor(list(inv_spacing), dtype=torch.float32, device=dev)
    h_t, w_t, one, two = (torch.tensor(v, dtype=torch.float32, device=dev)
                          for v in (h, wdt, 1.0, 2.0))
    sc = None if scale is None else scale.to(dev, torch.float32)
    x, v = rows[:, :3], rows[:, 3:]
    for _ in range(n_steps):
        pos = x + h_t * v
        B = trilinear(grid, pos, o, inv, contract=True)
        if sc is not None:
            B = B * sc
        t = w_t * B
        t2 = (t[:, 0:1] * t[:, 0:1] + t[:, 1:2] * t[:, 1:2]) \
            + t[:, 2:3] * t[:, 2:3]
        sfac = torch.div(two, one + t2)
        u = v + _cross(v, t)
        vn = fma(sfac, _cross(u, t), v)
        x = torch.cat([fma(h_t, vn[:, :2], fma(h_t, v[:, :2], x[:, :2])),
                       fma(h_t, vn[:, 2:], pos[:, 2:])], 1)
        v = vn
    return torch.cat([x, v], 1)


def _check_offsets(shape: Sequence[int]) -> None:
    """Raise ValueError when the kernel's 32-bit corner offsets (up to 3
    ny nz + 3 nz + 3 elements from a cell's first node) do not fit an
    (nx, ny, nz, 3) table."""
    ny, nz = int(shape[1]), int(shape[2])
    if 3 * ny * nz + 3 * nz + 3 >= 2**31:
        raise ValueError(f"boris: a ({ny}, {nz}) plane of nodes is too "
                         "large for the kernel's 32-bit node offsets")


def _check(rows: torch.Tensor, grid: torch.Tensor,
           scale: Optional[torch.Tensor]) -> None:
    dev = rows.device
    if (rows.dtype != torch.float32 or rows.dim() != 2
            or rows.shape[1] != 6):
        raise ValueError("rows must be (N, 6) float32")
    if (grid.device != dev or grid.dtype not in DTYPES or grid.dim() != 4
            or grid.shape[3] != 3 or not grid.is_contiguous()
            or min(grid.shape[:3]) < 2):
        raise ValueError("the B table must be a contiguous (nx, ny, nz, 3) "
                         "float32, bfloat16 or int8 tensor on the rows' "
                         "device, two nodes an axis or more")
    if grid.dtype == torch.int8 and (
            scale is None or scale.device != dev
            or scale.dtype != torch.float32 or scale.shape != (3,)):
        raise ValueError("an int8 table needs (3,) float32 scales on its "
                         "device")


def push(rows: torch.Tensor, grid: torch.Tensor,
         scale: Optional[torch.Tensor], origin: Sequence[float],
         inv_spacing: Sequence[float], h: float, wdt: float,
         n_steps: int) -> torch.Tensor:
    """March (N, 6) float32 rows ``n_steps`` Boris steps through the (nx,
    ny, nz, 3) table ``grid`` (times ``scale`` for int8) with node (0, 0,
    0) at ``origin`` and reciprocal spacings ``inv_spacing``; ``h`` = dt /
    2, ``wdt`` = (w / 2) dt. Returns new rows."""
    if rows.device.type == "cpu":
        return push_plain(rows, grid, scale, origin, inv_spacing, h, wdt,
                          n_steps)
    refuse_grad("boris.push (K13)", rows, grid, scale)
    _check(rows, grid, scale)
    out = rows.contiguous().clone()
    order = ray_order(out, tuple(grid.shape[:3]), origin, inv_spacing)
    launch(KERNEL, out, grid, scale, origin, inv_spacing, h, wdt, n_steps,
           order)
    return out


def launch(kernel: Kernel, out: torch.Tensor, grid: torch.Tensor,
           scale: Optional[torch.Tensor], origin: Sequence[float],
           inv_spacing: Sequence[float], h: float, wdt: float, n_steps: int,
           order: Optional[torch.Tensor]) -> None:
    """Launch ``kernel``'s ``boris_push`` on the contiguous rows ``out`` in
    place, the protons in ``order`` (None: the rows' own), without the
    checks of ``push``; raises before the launch for a table too wide for
    the kernel's 32-bit node offsets."""
    nx, ny, nz = grid.shape[:3]
    _check_offsets(grid.shape)
    kernel.launch(
        "boris_push", out.device, out.data_ptr(),
        None if order is None else order.data_ptr(), out.shape[0],
        grid.data_ptr(), DTYPES[grid.dtype],
        scale.data_ptr() if grid.dtype == torch.int8 else None, nx, ny, nz,
        *[float(v) for v in origin], *[float(v) for v in inv_spacing],
        float(h), float(wdt), int(n_steps))
