"""K17: one segment of the grid-sharded segment march, on one device.

``march_shards`` launches the CUDA kernel of ``csrc/march_sharded.cu`` on
CUDA tensors and runs ``march_shards_plain`` on CPU tensors: one launch a
segment for all the shards of a grid line that the device holds. Shard g
holds a-rows [lo, lo + naloc) of one segment's corner table and the first
a-row of its right neighbour (the halo); a ray is the shard's when its
frozen corner cell ia0 = clip(floor(ta), 0, na - 2) lies in its rows (the
JAX package's ``parallel/mesh.py:292-297``). Owned rays are marched as K1
marches them on the whole table (``march_segment(a_offset=lo)``), bit for
bit, then given JAX's psum rounding (+ 0.0 when the line has several
shards); rays owned on another device get zeros, which
``parallel.mesh.make_gridsharded_segment_tracer`` fills with the owner's
rows.

The plain version marches each shard's owned rays with ``march.march_plain``
on the shard's rows and the halo, offset by ``lo``. On CUDA tensors the
wrapper hands the rays over in ``order`` (default: ``march.ray_order``,
entry-cell order, which keeps a shard's rays together); the result does not
depend on the order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel, refuse_grad
from synthpy_tpu_torch.kernels.march import (_DTYPE_CODE, INTEGRATORS,
                                             march_plain, plane_blocks,
                                             ray_order)

KERNEL = Kernel("march_sharded.cu", {
    "march_shards": [P, P, P, P, P, P, I, P, L, I, I, I, I, I, I, I, I, I,
                     F, F, F, F, F, I, I, I, F, P],
}, flags=["--fmad=false"])

# a line's exchange of owned rows between its devices (K17's second entry
# point; counted apart from the march)
EXCHANGE_KERNEL = Kernel("march_sharded.cu", {
    "exchange_rows": [P, P, P, P, I, I, P, I, L, I, I, F, F, P],
}, flags=["--fmad=false"])


class Shard(NamedTuple):
    """One shard of a grid line on the rays' device: its (naloc, nb, row)
    or (naloc*nb, row) rows of one segment's table, a-rows [lo, lo +
    naloc), and ``halo``, the (nb, row) rows of a-row lo + naloc (None
    when no owned cell reaches it)."""

    table: torch.Tensor
    halo: Optional[torch.Tensor]
    lo: int


def owner(u: torch.Tensor, naloc: int, na: int, origin_a: float,
          inv_a: float) -> torch.Tensor:
    """(N,) int64: the line shard that owns each ray, the one whose rows
    hold its frozen corner a-row, as the kernels compute it (a NaN
    coordinate gives row 0)."""
    ta = (u[:, 0] - origin_a) * inv_a
    ia0 = torch.floor(ta).nan_to_num(0.0).clamp(0, na - 2)
    return ia0.long() // naloc


def owned(u: torch.Tensor, lo: int, naloc: int, na: int, origin_a: float,
          inv_a: float) -> torch.Tensor:
    """(N,) bool: the rays whose frozen corner a-row lies in [lo, lo +
    naloc)."""
    return owner(u, naloc, na, origin_a, inv_a) == lo // naloc


def march_shards_plain(u: torch.Tensor, shards: Sequence[Shard],
                       scales: Optional[torch.Tensor], *, naloc: int,
                       line_shards: int, shape_ab: Tuple[int, int],
                       origin_ab: Sequence[float], inv_ab: Sequence[float],
                       dp: float, layout: ChannelLayout, K: int,
                       integrator: str = "rk4", weights: str = "stage",
                       qbits: Optional[int] = None,
                       atten_sign: float = -1.0) -> torch.Tensor:
    """Plain version of ``march_shards``: (N, 8) in, each ray owned by one
    of ``shards`` marched (+ 0.0 when ``line_shards`` > 1), the rest
    zeros."""
    nb = shape_ab[1]
    out = torch.zeros_like(u)
    for sh in shards:
        row = sh.table.shape[-1]
        rows = [sh.table.reshape(naloc * nb, row)]
        if sh.halo is not None:
            rows.append(sh.halo.reshape(nb, row))
        local = torch.cat(rows)[None]
        mask = owned(u, sh.lo, naloc, shape_ab[0], float(origin_ab[0]),
                     float(inv_ab[0]))
        out[mask] = march_plain(
            u[mask], local, None if scales is None else scales[None],
            shape_ab=shape_ab, origin_ab=origin_ab, inv_ab=inv_ab, dp=dp,
            layout=layout, K=K, integrator=integrator, weights=weights,
            qbits=qbits, atten_sign=atten_sign, a_offset=sh.lo)
    return out + 0.0 if line_shards > 1 else out


def march_shards(u: torch.Tensor, shards: Sequence[Shard],
                 scales: Optional[torch.Tensor], *, naloc: int,
                 line_shards: int, shape_ab: Tuple[int, int],
                 origin_ab: Sequence[float], inv_ab: Sequence[float],
                 dp: float, layout: ChannelLayout, K: int,
                 integrator: str = "rk4", weights: str = "stage",
                 qbits: Optional[int] = None, atten_sign: float = -1.0,
                 order: Optional[torch.Tensor] = None) -> torch.Tensor:
    """March the rays of (N, 8) permuted states that ``shards`` (this
    device's shards of a ``line_shards``-shard grid line, in shard order)
    own through one segment; the other rays get zeros.

    Each shard's table is f32, bf16, int8 or int4 nibble pairs
    (``qbits=4``); ``scales``: the segment's (K+1, C) f32 for the
    quantised tables, else None. ``order``: the launch order (on CUDA
    tensors; default ``ray_order`` of ``u``). A launch takes 1 to the
    kernel's ``MAX_SHARDS`` (8) shards and raises on more."""
    kw = dict(naloc=naloc, line_shards=line_shards, shape_ab=shape_ab,
              origin_ab=origin_ab, inv_ab=inv_ab, dp=dp, layout=layout, K=K,
              integrator=integrator, weights=weights, qbits=qbits,
              atten_sign=atten_sign)
    if u.device.type == "cpu":
        return march_shards_plain(u, shards, scales, **kw)
    refuse_grad("march_sharded.march_shards (K17)", u,
                *(x for sh in shards for x in sh[:2]))
    dev = u.device
    if (u.dtype != torch.float32 or u.dim() != 2 or u.shape[1] != 8
            or not u.is_contiguous()):
        raise ValueError("u must be a contiguous (N, 8) float32 tensor")
    na, nb = shape_ab
    C = layout.n_channels
    row = plane_blocks(K, qbits) * C
    if not shards:
        raise ValueError("a device holds at least one shard of the line")
    dtype = shards[0].table.dtype
    for sh in shards:
        for name, t, n in (("table", sh.table, naloc * nb),
                           ("halo", sh.halo, nb)):
            if t is None:
                continue
            if (t.device != dev or t.dtype not in _DTYPE_CODE
                    or not t.is_contiguous() or t.numel() != n * row
                    or t.shape[-1] != row or t.dtype != dtype):
                raise ValueError(f"{name} must be {n} contiguous rows of "
                                 f"{row} f32/bf16/int8 values on the rays' "
                                 "device")
        if not 0 <= sh.lo < na or sh.lo % naloc:
            raise ValueError(f"shard rows [{sh.lo}, {sh.lo + naloc}) are not "
                             f"a shard of na={na}")
    if integrator not in INTEGRATORS:
        raise ValueError(f"unknown integrator {integrator!r}")
    if naloc < 1 or line_shards < len(shards):
        raise ValueError(f"{len(shards)} shards of {naloc} rows on a line "
                         f"of {line_shards}")
    quantized = dtype == torch.int8
    if quantized != (scales is not None):
        raise ValueError("int8/int4 tables need scales; float tables none")
    if qbits == 4 and not quantized:
        raise ValueError("int4 nibble packs are int8 byte tables")
    if quantized and (scales.device != dev or scales.dtype != torch.float32
                      or tuple(scales.shape) != (K + 1, C)
                      or not scales.is_contiguous()):
        raise ValueError("scales must be a contiguous (K+1, C) f32 tensor "
                         "on the rays' device")
    if u.data_ptr() % 16:
        u = u.clone()
    if order is None:
        order = ray_order(u, shape_ab, origin_ab, inv_ab)
    return launch(KERNEL, u, shards, scales, order, **kw)


def launch(kernel: Kernel, u: torch.Tensor, shards: Sequence[Shard],
           scales: Optional[torch.Tensor], order: torch.Tensor, *,
           naloc: int, line_shards: int, shape_ab: Tuple[int, int],
           origin_ab: Sequence[float], inv_ab: Sequence[float], dp: float,
           layout: ChannelLayout, K: int, integrator: str = "rk4",
           weights: str = "stage", qbits: Optional[int] = None,
           atten_sign: float = -1.0) -> torch.Tensor:
    """Launch ``kernel`` (a build of ``csrc/march_sharded.cu``) on checked
    inputs, marching ray ``order[i]`` i-th."""
    out = torch.empty_like(u)
    na, nb = shape_ab
    G = len(shards)
    tables = (ctypes.c_void_p * G)(*(sh.table.data_ptr() for sh in shards))
    halos = (ctypes.c_void_p * G)(*(
        None if sh.halo is None else sh.halo.data_ptr() for sh in shards))
    los = (ctypes.c_int * G)(*(int(sh.lo) for sh in shards))
    kernel.launch(
        "march_shards", u.device, u.data_ptr(), out.data_ptr(),
        order.data_ptr(), tables, halos, los, G,
        None if scales is None else scales.data_ptr(), u.shape[0],
        int(naloc), int(line_shards), shards[0].table.shape[-1], K,
        3 if qbits == 4 else _DTYPE_CODE[shards[0].table.dtype],
        INTEGRATORS.index(integrator), int(weights == "slab"), na, nb,
        float(origin_ab[0]), float(origin_ab[1]), float(inv_ab[0]),
        float(inv_ab[1]), float(dp), int(layout.inv_brems),
        int(layout.phaseshift), int(layout.B_on), float(atten_sign))
    return out


def exchange_rows_plain(outs: Sequence[torch.Tensor],
                        starts: Sequence[torch.Tensor],
                        block_of: Sequence[int], *, naloc: int, na: int,
                        origin_a: float, inv_a: float) -> None:
    """Plain version of ``exchange_rows``, in place."""
    blocks = torch.tensor(list(block_of))
    own = [blocks[owner(u.cpu(), naloc, na, origin_a, inv_a)] for u in starts]
    for d, out in enumerate(outs):
        for e, src in enumerate(outs):
            if e != d:
                mask = (own[d] == e).to(out.device)
                out[mask] = src.to(out.device)[mask]


def exchange_rows(outs: Sequence[torch.Tensor],
                  starts: Sequence[torch.Tensor], block_of: Sequence[int],
                  *, naloc: int, na: int, origin_a: float,
                  inv_a: float) -> None:
    """One segment's exchange on a grid line spread over several devices,
    in place: ``outs[d]``, device d's (N, 8) result of ``march_shards``
    (the line's devices in line order), receives every row that another
    device owns, read from that device's result. ``starts[d]``: the
    segment's (N, 8) start states on device d (every device holds the
    same); ``block_of[g]``: the line index of the device that holds shard
    g (of naloc a-rows each). No indices travel and nothing is added; on a
    card each device's launch waits (stream events, no host sync) for
    every other device's march and reads their rows by peer loads, and
    every device's stream then waits for every other device's launch, so
    that no later work on a device (its allocator reusing ``outs[d]``'s
    memory included) runs while a peer still reads it. A launch takes 1
    to the kernel's ``MAX_DEVICES`` (8) devices and ``MAX_LINE_SHARDS``
    (64) shards and raises on more."""
    D = len(outs)
    geo = dict(naloc=naloc, na=na, origin_a=origin_a, inv_a=inv_a)
    if outs[0].device.type == "cpu":
        return exchange_rows_plain(outs, starts, block_of, **geo)
    refuse_grad("march_sharded.exchange_rows (K17)", *outs, *starts)
    N = outs[0].shape[0]
    for t in (*outs, *starts):
        if (t.device.type != "cuda" or t.dtype != torch.float32
                or tuple(t.shape) != (N, 8) or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("exchange_rows takes contiguous, 16-byte "
                             "aligned (N, 8) float32 tensors on cards")
    devs = [o.device for o in outs]
    if any(u.device != d for u, d in zip(starts, devs)):
        raise ValueError("starts[d] must lie on outs[d]'s device")
    peers = (ctypes.c_void_p * D)(*(o.data_ptr() for o in outs))
    ordinals = (ctypes.c_int * D)(*(torch.cuda.device(d).idx for d in devs))
    blocks = (ctypes.c_int * len(block_of))(*(int(b) for b in block_of))
    # every march first, then every launch
    _cross_wait(devs)
    for d, out in enumerate(outs):
        EXCHANGE_KERNEL.launch(
            "exchange_rows", devs[d], starts[d].data_ptr(), out.data_ptr(),
            peers, ordinals, D, d, blocks, len(block_of), N, int(naloc),
            int(na), float(origin_a), float(inv_a))
    _cross_wait(devs)


def _cross_wait(devs: Sequence[torch.device]) -> None:
    """Order each device's current stream after the work queued so far on
    every other device's (an event on each, no host sync)."""
    events = []
    for d in devs:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        events.append(ev)
    for d, dev in enumerate(devs):
        stream = torch.cuda.current_stream(dev)
        for e, ev in enumerate(events):
            if e != d:
                stream.wait_event(ev)
