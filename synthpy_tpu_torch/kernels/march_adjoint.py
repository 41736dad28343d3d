"""K11: the adjoint of one segment of the segment march K1.

``march_adjoint`` takes one segment's start states ``u`` (N, 8), the
cotangent ``du`` of its end states and its (cells, (K+1) C) table, and
returns the cotangent of ``u``; the table's cotangent is added into a
float32 buffer of the table's shape when one is given. On CUDA tensors it
launches ``csrc/march_adjoint.cu`` on the rays in ``march.ray_order``; on
CPU tensors it runs ``march_vjp_plain``, ``torch.autograd.grad`` through
``march.march_plain`` of that one segment. It covers what the
differentiable renderer runs: rk4, ``weights="stage"``, one substep, float32
or bf16 tables (``covers``). The table's cotangent is summed in float32
for either table.

The host fixes what the kernel's plan needs and raises where it cannot
hold (there is no other route on a card): the width of its vector adds
into the table's cotangent by C (``vector_width``), which the cotangent
buffer's alignment must allow. ``scratch_bytes`` and
``atomics_per_launch`` (from the rays' cells in launch order) count what a
launch moves.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels import march as _march
from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel

KERNEL = Kernel("march_adjoint.cu", {
    "march_adjoint": [P, P, P, P, P, P, P, L, I, I, I, I, I, F, F, F, F, F,
                      I, I, I, F, P],
}, flags=["--fmad=false"])

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
WARP = 32
MAX_STEPS = 2   # march_adjoint.cu's: shuffle steps of a plane's flush


def vector_width(C: int) -> int:
    """Floats in one vector add into the table's cotangent: a corner's C
    values of a plane are contiguous in rows of (K+1) C floats, so 4 when C
    is a multiple of 4, 2 when C is even, else 1 (the kernel's
    ``vec_width``)."""
    if not 3 <= C <= 8:
        raise ValueError(f"C = {C}: the layouts have 3-8 channels")
    return 4 if C % 4 == 0 else 2 if C % 2 == 0 else 1


def scratch_bytes(N: int, K: int) -> int:
    """Bytes of a launch's scratch: the (K, N, 8) float32 slab-start
    states, written once and read once."""
    return K * N * 8 * 4


def atomics_per_launch(cells: torch.Tensor, *, K: int, C: int,
                       max_steps: int = None) -> int:
    """The vector adds into the table's cotangent a launch makes at most,
    from ``cells`` (N,), the rays' corner cells in launch order
    (``entry_cells`` of the rays in ``ray_order``). A warp's runs of equal
    cell are summed in blocks of 2^S lanes, S the shuffle steps its
    longest run needs but at most ``max_steps`` (``MAX_STEPS``); each
    block adds 4 corners x C / ``vector_width`` vectors for each of the K
    + 1 planes (all-zero vectors, as outside the grid, are skipped, so
    fewer may reach memory)."""
    S = MAX_STEPS if max_steps is None else max_steps
    n = cells.numel()
    if n == 0:
        return 0
    # the tail lanes of the last warp form a run of their own, adding none
    pad = -n % WARP
    key = torch.cat([cells.long(), cells.new_full((pad,), -1).long()])
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    first[::WARP] = True
    starts = torch.nonzero(first).flatten()
    length = torch.diff(starts, append=starts.new_tensor([key.numel()]))
    warp = starts // WARP
    longest = torch.zeros(key.numel() // WARP, dtype=length.dtype,
                          device=key.device).scatter_reduce(
        0, warp, length, "amax")
    steps = torch.ceil(torch.log2(longest.double())).long().clamp(max=S)
    block = 2 ** steps[warp]
    adders = (length + block - 1) // block
    adders = adders[key[starts] >= 0]
    return int(adders.sum()) * 4 * (C // vector_width(C)) * (K + 1)


def covers(integrator: str, weights: str, dtype, qbits=None) -> bool:
    """Whether the adjoint covers a march configuration (a float64 table
    only in the plain version, on the CPU: the kernels are float32)."""
    return (integrator == "rk4" and weights == "stage" and qbits is None
            and dtype in (torch.float32, torch.bfloat16, torch.float64))


def grad_dtype(dtype):
    """The type a table's cotangent is summed in: float32, or float64 for
    a float64 table."""
    return torch.promote_types(dtype, torch.float32)


def march_vjp_plain(u: torch.Tensor, seg: torch.Tensor, du: torch.Tensor, *,
                    shape_ab: Tuple[int, int], origin_ab: Sequence[float],
                    inv_ab: Sequence[float], dp: float, layout: ChannelLayout,
                    K: int, atten_sign: float = -1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the adjoint: (du_in, dseg), the cotangents of the
    start states and of the table's values, in float32 for a float32 or
    bf16 table (float64 for float64), by ``torch.autograd.grad`` through
    ``march_plain`` of this segment."""
    with torch.enable_grad():
        u_ = u.detach().requires_grad_()
        t_ = seg.detach().to(grad_dtype(seg.dtype)).requires_grad_()
        out = _march.march_plain(
            u_, t_[None], None, shape_ab=shape_ab, origin_ab=origin_ab,
            inv_ab=inv_ab, dp=dp, layout=layout, K=K, integrator="rk4",
            weights="stage", atten_sign=atten_sign)
        return torch.autograd.grad(out, (u_, t_), du)


def march_adjoint(u: torch.Tensor, seg: torch.Tensor, du: torch.Tensor, *,
                  shape_ab: Tuple[int, int], origin_ab: Sequence[float],
                  inv_ab: Sequence[float], dp: float, layout: ChannelLayout,
                  K: int, dseg: Optional[torch.Tensor] = None,
                  atten_sign: float = -1.0) -> torch.Tensor:
    """The cotangent of one segment's (N, 8) start states ``u`` for the
    cotangent ``du`` of its end states, through the (cells, (K+1) C) table
    ``seg``; the table's cotangent is added into ``dseg`` (the table's
    shape, in ``grad_dtype``) when it is given."""
    kw = dict(shape_ab=shape_ab, origin_ab=origin_ab, inv_ab=inv_ab, dp=dp,
              layout=layout, K=K, atten_sign=atten_sign)
    if u.device.type == "cpu":
        du_in, dt = march_vjp_plain(u, seg, du, **kw)
        if dseg is not None:
            dseg += dt
        return du_in
    dev = u.device
    N = u.shape[0]
    na, nb = shape_ab
    C = layout.n_channels
    for name, t in (("u", u), ("du", du)):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (N, 8)):
            raise ValueError(f"{name} must be an (N, 8) float32 tensor on "
                             "the rays' device")
    if (seg.device != dev or seg.dtype not in _DTYPE_CODE
            or tuple(seg.shape) != (na * nb, (K + 1) * C)
            or not seg.is_contiguous()):
        raise ValueError(f"seg must be a contiguous ({na * nb}, "
                         f"{(K + 1) * C}) float32 or bf16 table on the rays' "
                         "device")
    if dseg is not None and (dseg.device != dev
                             or dseg.dtype != torch.float32
                             or dseg.shape != seg.shape
                             or not dseg.is_contiguous()):
        raise ValueError("dseg must be a contiguous float32 tensor of the "
                         "table's shape on the rays' device")
    if dseg is not None and dseg.data_ptr() % (4 * vector_width(C)):
        raise ValueError(f"dseg must be {4 * vector_width(C)}-byte aligned "
                         f"at C = {C}: the kernel adds "
                         f"{vector_width(C)}-float vectors into it")
    # states are read and written as 16-byte vectors
    u, du = (t.contiguous() for t in (u, du))
    u, du = (t.clone() if t.data_ptr() % 16 else t for t in (u, du))
    order = _march.ray_order(u, shape_ab, origin_ab, inv_ab)
    return launch(KERNEL, u, seg, du, order, dseg=dseg, **kw)


def launch(kernel: Kernel, u: torch.Tensor, seg: torch.Tensor,
           du: torch.Tensor, order: torch.Tensor, *,
           shape_ab: Tuple[int, int], origin_ab: Sequence[float],
           inv_ab: Sequence[float], dp: float, layout: ChannelLayout,
           K: int, dseg: Optional[torch.Tensor] = None,
           atten_sign: float = -1.0) -> torch.Tensor:
    """Launch ``kernel`` (a build of ``csrc/march_adjoint.cu``) on inputs
    that ``march_adjoint`` has checked, ray ``order[i]`` i-th."""
    dev = u.device
    N = u.shape[0]
    na, nb = shape_ab
    C = layout.n_channels
    du_in = torch.empty_like(u)
    scratch = torch.empty((K, N, 8), dtype=torch.float32, device=dev)
    kernel.launch(
        "march_adjoint", dev, u.data_ptr(), du.data_ptr(), du_in.data_ptr(),
        order.data_ptr(), seg.data_ptr(),
        None if dseg is None else dseg.data_ptr(), scratch.data_ptr(), N,
        (K + 1) * C, K, _DTYPE_CODE[seg.dtype], na, nb, float(origin_ab[0]),
        float(origin_ab[1]), float(inv_ab[0]), float(inv_ab[1]), float(dp),
        int(layout.inv_brems), int(layout.phaseshift), int(layout.B_on),
        float(atten_sign))
    return du_in
