"""K2: segment-pack builder, quantiser and decimator.

``build_tables`` (float tables), ``build_quantized_tables`` (int8 codes or
int4 nibble pairs with their scales, straight from the volumes),
``quantize_tables`` (of a carried float table) and ``decimate_tables``
launch the CUDA kernels of ``csrc/pack.cu`` on CUDA tensors and run their
plain PyTorch versions on CPU tensors. The plain versions repeat the JAX
package's arithmetic (``synthpy_tpu/tracer/zscan.py`` seg_fn :1812,
quantize_segment_pack.quant :493, decimate_segment_pack.dec :576/:597).
Both builds take ``plane_stride`` S: output plane k of segment s is
absolute plane s*K + k*S, the gradients still at full resolution, so the
result is the decimation of the full build.

A ``Window`` builds the rows of one shard of a field split along the
transverse a-axis (``build_segment_pack_device(mesh=)``, JAX's sharded
``build`` :1780-1797): the volumes hold a-rows [a0, a0 + na_loc) of the
field's na, the window carries the neighbours' rows a0 - 1 and
a0 + na_loc, and the a-gradient, the edge rules and the dither are those of
the whole field, so the shards' rows are the whole build's rows bit for
bit. The quantised tiers take the field's amax: ``build_amax`` runs the
amax pass over a shard's rows, the caller max-reduces the shards' amaxes,
and ``build_quantized_tables(amax=)`` writes the codes. Window builds
count their launches on ``WINDOW_KERNEL``, the same entry point as
``KERNEL``'s builds.

Every divisor in the plain versions is a tensor on the data's device: on
CUDA, PyTorch divides by a Python scalar as a multiplication by its
reciprocal, which is not the IEEE quotient the kernels and JAX compute.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from synthpy_tpu_torch import constants
from synthpy_tpu_torch.fields.domain import ChannelLayout, gradient
from synthpy_tpu_torch.kernels import random as _random
from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel

_FUNCTIONS = {
    "pack_build": [P, I, P, P, P, P, P, P, L, L, L, I, I, I, I, I, I, I,
                   I, I, F, F, F, F, F, F, F, F, I, I, I, I, L, L,
                   I, I, P, P, L, L, I, I, I, I, I, I, I, I, I, I, I, I,
                   I, P],
    "pack_quantize": [P, I, P, P, P, I, I, I, I, I, I, L, L, P],
    "pack_decimate": [P, P, I, I, L, I, I, I, I, I, I, I, L, I, I, P],
}
KERNEL = Kernel("pack.cu", _FUNCTIONS, flags=["--fmad=false"])
# the same builder on a shard's row window (build_segment_pack_device(mesh=))
WINDOW_KERNEL = Kernel("pack.cu", _FUNCTIONS, flags=["--fmad=false"])

# a dither key: the two uint32 words of a JAX key (random.key_of), or None
Dither = Optional[Tuple[int, int]]


class Window(NamedTuple):
    """The volumes' a-rows are the field's rows [a0, a0 + na_loc) of
    ``na``. ``lo`` / ``hi``: the field's ne rows a0 - 1 / a0 + na_loc, each
    the ne volume with its a-dimension cut to that one row (size 1 kept),
    None where the window touches the field's edge."""
    a0: int
    na: int
    lo: Optional[torch.Tensor] = None
    hi: Optional[torch.Tensor] = None


def _window_rows(window: Optional[Window], na_loc: int):
    """(a0, na, lo, hi) of a window (the whole field for None), checked."""
    if window is None:
        return 0, na_loc, None, None
    a0, na, lo, hi = window
    if a0 < 0 or a0 + na_loc > na:
        raise ValueError(f"window rows [{a0}, {a0 + na_loc}) outside the "
                         f"field's {na}")
    if (lo is None) != (a0 == 0) or (hi is None) != (a0 + na_loc == na):
        raise ValueError("a window needs its halo rows exactly where it "
                         "does not touch the field's edge")
    return a0, na, lo, hi


def nibble_lo(w: torch.Tensor) -> torch.Tensor:
    """Sign-extended low nibble of int8 bytes (plane 2j of the pair), int16."""
    return ((w.to(torch.int16) & 15) ^ 8) - 8


def nibble_hi(w: torch.Tensor) -> torch.Tensor:
    """Sign-extended high nibble (plane 2j+1): arithmetic shift, int16."""
    return w.to(torch.int16) >> 4


def pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo & 15) | ((hi & 15) << 4) as int8 bytes."""
    return ((lo.to(torch.int16) & 15) | ((hi.to(torch.int16) & 15) << 4)
            ).to(torch.uint8).view(torch.int8)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _check_cuda(name: str, t: torch.Tensor, dtypes, device) -> None:
    if t.device != device or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtypes} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")


# -- build -----------------------------------------------------------------

_MODES = {torch.float32: 0, torch.bfloat16: 1}

# pack_build's launch plan (csrc/pack.cu; THREADS and AMAX_COLS are that
# file's too): threads a block; planes a plane slot of the amax pass may
# own; the cells a block stages at least (the kernel staged exactly this
# many before it took a plan; kept planes are still chunked as such a tile
# allows, so KB does not move), and always a multiple of it; the bytes of
# ne a tile stages; blocks an SM counted when the plan keeps two waves
BUILD_THREADS = 256
AMAX_COLS = 3
CB_ROWS = 8
TILE_BUDGET = 24 * 1024
WAVE_BLOCKS_PER_SM = 8
# the most cells a block of a float table's rows stages: a sweep of the
# cells a barrier on one 1024^3 shard at K = 64 (pack_timing.py window
# --sweep; H100 80GB HBM3, 700.00 W, PERF.md) ran the f32 rows in 2.08 ms
# at 32 cells against 2.65 at 8 and 3.04 at 80, bf16 in 1.79 against 2.62
# and 2.22, while the codes, amax and dithered z-pinch passes ran fastest
# with the whole tile budget
FLOAT_ROWS_CB = 32


def tile_rows(CB: int, pc: bool) -> int:
    """Staged rows of a tile: the CB cells and their b-1 / b+1
    neighbours, and for x- and y-probing (``pc`` False) the a-1 and a+1
    neighbour rows too (csrc/pack.cu ``tile_rows``)."""
    return CB + 2 if pc else 3 * CB + 2


def tile_pitch(KB: int, S: int, pc: bool) -> int:
    """Floats a tile row: planes g-1 .. g+1 of KB kept planes S apart,
    16-byte aligned along contiguous planes, odd otherwise."""
    span = (KB - 1) * S + 3
    return 4 * ((span + 6) // 4) if pc else span | 1


def _up16(n: int) -> int:
    return (n + 15) // 16 * 16


def tile_bytes(CB: int, pitch: int, pc: bool) -> int:
    return _up16(tile_rows(CB, pc) * pitch * 4)


def meta_bytes(CB: int) -> int:
    """Each of the 3 CB + 2 rows' pointer and plane stride, each cell's
    (a, b)."""
    return _up16((3 * CB + 2) * 12 + CB * 8)


class BuildPlan(NamedTuple):
    """How ``pack_build`` walks a build: the kept planes in ``n_chunk``
    chunks of ``KB``, staged in tiles of ``pitch`` floats a row. Pass A
    (the amax) stages ``CB_a`` cells (whole table rows) of a segment
    between two barriers, in ``blocks_a`` blocks a chunk and segment of
    ``CR`` cells each; its thread t is plane slot t % ``slots`` of cell
    lane t / ``slots`` (``lanes`` of them), owning the planes slot + j *
    slots of the chunk over the staged cells lane, lane + lanes, ... Pass
    B (rows or codes) runs ``blocks_b`` blocks a segment of ``CB_b``
    cells. ``smem_a`` / ``smem_b``: each pass's dynamic shared bytes."""
    CB_a: int
    CB_b: int
    KB: int
    n_chunk: int
    pitch: int
    slots: int
    lanes: int
    CR: int
    blocks_a: int
    smem_a: int
    blocks_b: int
    smem_b: int


def build_plan(C: int, n_seg: int, K: int, S: int, cells: int, pc: bool,
               mode: int, n_sm: int = 132,
               CB: Optional[int] = None) -> BuildPlan:
    """K2's launch plan for ``cells`` cells a segment, C channels and
    K / S + 1 kept planes a row; ``pc``: planes contiguous (z-probing).
    KB is as long as a tile of ``CB_ROWS`` cells holds (every plane at K =
    64; 513 at K = 512, z-probing); the cells a barrier then fill
    ``TILE_BUDGET`` in multiples of ``CB_ROWS`` (8 at K = 512, 80 at K = 64
    z-probing, 24 x- and y-probing), capped so that pass B keeps two waves
    of ``WAVE_BLOCKS_PER_SM`` blocks an SM, and at ``FLOAT_ROWS_CB`` for
    the rows of a float table (``mode`` 0 f32, 1 bf16; 2 int8, 3 int4).
    Pass A takes floor(``BUILD_THREADS`` / KB) cell lanes of KB slots
    where two or more fit, else one lane of ``BUILD_THREADS`` slots, and
    its cells in runs for two such waves. ``CB`` forces both passes' cells
    a barrier (timing variants)."""
    Ko = K // S
    per_row = TILE_BUDGET // 4 // tile_rows(CB_ROWS, pc)
    KB = (per_row - 9) // S + 1
    KB = 2 if KB < 2 else KB & ~1
    KB = min(KB, Ko + 1, AMAX_COLS * BUILD_THREADS)
    pitch = tile_pitch(KB, S, pc)
    rows = TILE_BUDGET // (4 * pitch)
    wide = (rows - 2) // (1 if pc else 3) // CB_ROWS * CB_ROWS
    waves = 2 * n_sm * WAVE_BLOCKS_PER_SM
    cap = cells * n_seg // waves // CB_ROWS * CB_ROWS
    CB_a = CB_b = max(CB_ROWS, min(wide, cap)) if CB is None else CB
    if CB is None and mode < 2:
        CB_b = min(CB_b, FLOAT_ROWS_CB)
    n_chunk = -(-(Ko + 1) // KB)
    slots = KB if 2 * KB <= BUILD_THREADS else BUILD_THREADS
    lanes = BUILD_THREADS // slots
    runs = max(1, waves // (n_chunk * n_seg))
    CR = -(-(-(-cells // runs)) // CB_a) * CB_a

    def tile(cb):
        return tile_bytes(cb, pitch, pc) + meta_bytes(cb)

    return BuildPlan(CB_a, CB_b, KB, n_chunk, pitch, slots, lanes, CR,
                     -(-cells // CR), tile(CB_a) + 4 * (lanes - 1) * slots * C,
                     -(-cells // CB_b), tile(CB_b) + 4 * KB * C)


def channels_plain(padded: torch.Tensor, extras, g: torch.Tensor, *,
                   layout: ChannelLayout, n_p: int, pref: float, da: float,
                   db: float, dp: float, omega: float,
                   verdet: float) -> torch.Tensor:
    """(P, na, nb, C) float32 channels of the body planes ``padded[1:-1]``
    (absolute planes ``g``, (P,)), ``padded`` holding one stencil plane on
    each side; ``extras`` the pointwise (P, na, nb) volumes Te, Z, then B
    along a, b, p, as the layout needs them. The first absolute plane
    doubles its probe-axis difference, the last real one takes 2 Gp + pref
    ne / dp, and planes past n_p - 1 are zero (JAX zscan.py:1832-1838,
    :2061-2075)."""
    body = padded[1:-1]
    Gp = pref * (padded[2:] - padded[:-2]) / _scalar(2.0 * dp, padded)
    g = g.to(padded.device)[:, None, None]
    Gp = torch.where(g == 0, 2.0 * Gp, Gp)
    Gp = torch.where(g == n_p - 1, 2.0 * Gp + pref * body / _scalar(dp, body),
                     Gp)
    chans = [pref * gradient(body, da, 1), pref * gradient(body, db, 2), Gp]
    if layout.inv_brems:
        chans.append(constants.kappa(body, extras[0], extras[1], omega))
    if layout.phaseshift:
        chans.append(omega * (constants.n_refrac(body, omega) - 1.0))
    if layout.B_on:
        off = 2 if layout.inv_brems else 0
        for i in range(3):
            chans.append(verdet * body * extras[off + i])
    out = torch.stack(chans, dim=-1)
    return torch.where((g <= n_p - 1)[..., None], out, torch.zeros_like(out))


def build_tables_plain(vols: Dict[str, Optional[torch.Tensor]], *,
                       p_ax: int, layout: ChannelLayout, K: int, n_seg: int,
                       pref: float, da: float, db: float, dp: float,
                       omega: float, verdet: float, dtype,
                       plane_stride: int = 1,
                       window: Optional[Window] = None) -> torch.Tensor:
    """Plain version of the float build: (n_seg, na*nb, (K/S+1)*C)
    tables, the full build decimated; with a ``window``, the rows of its
    cells: the channels of the window and its halo rows, cut to the
    window."""
    pm = vols["ne"].movedim(p_ax, 0)             # (n_p, na, nb)
    a0, na_all, lo, hi = _window_rows(window, pm.shape[1])
    h0 = 0 if lo is None else 1
    halo = [pm] if lo is None else [lo.movedim(p_ax, 0), pm]
    if hi is not None:
        halo.append(hi.movedim(p_ax, 0))
    pm = torch.cat(halo, dim=1) if len(halo) > 1 else pm
    n_p, na, nb = pm.shape
    na_loc = na - h0 - (hi is not None)
    G = n_seg * K + 1                            # absolute planes 0..n_seg*K
    padded = torch.cat([pm[:1], pm, pm.new_zeros((G + 1 - n_p, na, nb))])

    def extra(e):
        # pointwise channels: zero rows stand in for the halo's
        e = e.movedim(p_ax, 0)
        e = torch.cat([e.new_zeros((e.shape[0], h0, nb)), e,
                       e.new_zeros((e.shape[0], na - h0 - na_loc, nb))],
                      dim=1)
        return torch.cat([e, e.new_zeros((G - n_p, na, nb))])

    extras = []
    if layout.inv_brems:
        extras += [extra(vols["Te"]), extra(vols["Z"])]
    if layout.B_on:
        a_ax, b_ax = [a for a in range(3) if a != p_ax]
        extras += [extra(vols["B"][..., comp]) for comp in (a_ax, b_ax, p_ax)]
    out = channels_plain(padded, extras, torch.arange(G), layout=layout,
                         n_p=n_p, pref=pref, da=da, db=db, dp=dp,
                         omega=omega, verdet=verdet).to(dtype)
    out = out[:, h0:h0 + na_loc]
    idx = (torch.arange(n_seg)[:, None] * K
           + torch.arange(K + 1)[None, :]).to(pm.device)
    C = out.shape[-1]
    table = out[idx].permute(0, 2, 3, 1, 4).reshape(n_seg, na_loc * nb,
                                                    (K + 1) * C)
    if plane_stride == 1:
        return table
    return decimate_tables_plain(table, K, C, plane_stride, False)


def build_amax_plain(vols: Dict[str, Optional[torch.Tensor]], *,
                     plane_stride: int = 1, **kw) -> torch.Tensor:
    """Plain version of ``build_amax``."""
    table = build_tables_plain(vols, dtype=torch.float32,
                               plane_stride=plane_stride, **kw)
    n_seg, cells, _ = table.shape
    C = kw["layout"].n_channels
    v = table.reshape(n_seg, cells, kw["K"] // plane_stride + 1, C)
    return v.abs().amax(dim=1).view(torch.int32)


def build_quantized_tables_plain(vols: Dict[str, Optional[torch.Tensor]], *,
                                 bits: int, plane_stride: int = 1,
                                 dither: Dither = None,
                                 amax: Optional[torch.Tensor] = None,
                                 **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the quantised build: the quantisation of the
    (decimated) f32 build, dithered by absolute plane s*K + k*S at the
    field's cell index, scaled by ``amax`` where it is given."""
    table = build_tables_plain(vols, dtype=torch.float32,
                               plane_stride=plane_stride, **kw)
    C = kw["layout"].n_channels
    K, Ko = kw["K"], kw["K"] // plane_stride
    planes = (torch.arange(kw["n_seg"])[:, None] * K
              + torch.arange(Ko + 1)[None, :] * plane_stride)
    window = kw.get("window")
    nb = vols["ne"].shape[[a for a in range(3) if a != kw["p_ax"]][1]]
    offset = 0 if window is None else window.a0 * nb * C
    return quantize_tables_plain(
        table, Ko, C, bits, dither, planes, offset=offset,
        amax=None if amax is None else amax.view(torch.float32))


def build_tables(vols: Dict[str, Optional[torch.Tensor]], *, p_ax: int,
                 layout: ChannelLayout, K: int, n_seg: int, pref: float,
                 da: float, db: float, dp: float, omega: float,
                 verdet: float, dtype, plane_stride: int = 1,
                 window: Optional[Window] = None) -> torch.Tensor:
    """Float segment tables from the field volumes (ne, and Te, Z, B as the
    layout switches them on), in f32 or bf16: (n_seg, na*nb, (K/S+1)*C);
    with a ``window``, the rows of its cells."""
    kw = dict(p_ax=p_ax, layout=layout, K=K, n_seg=n_seg, pref=pref, da=da,
              db=db, dp=dp, omega=omega, verdet=verdet,
              plane_stride=plane_stride, window=window)
    if vols["ne"].device.type == "cpu":
        return build_tables_plain(vols, dtype=dtype, **kw)
    if dtype not in _MODES:
        raise ValueError(f"table dtype must be f32 or bf16, got {dtype}")
    out, _ = _build(vols, mode=_MODES[dtype], dither=None, **kw)
    return out


def build_quantized_tables(vols: Dict[str, Optional[torch.Tensor]], *,
                           p_ax: int, layout: ChannelLayout, K: int,
                           n_seg: int, pref: float, da: float, db: float,
                           dp: float, omega: float, verdet: float,
                           bits: int, plane_stride: int = 1,
                           dither: Dither = None,
                           window: Optional[Window] = None,
                           amax: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 codes (``bits=8``) or int4 nibble pairs (``bits=4``) and their
    (n_seg, K/S+1, C) f32 scales, from the volumes in two passes over ne
    (amax, then codes): no float table is held. ``dither`` (a key's two
    words) adds JAX's dither of fold_in(key, absolute plane) over (na, nb,
    C) before rounding, where the value is not zero. ``amax`` (the int32
    bits of the field's (n_seg, K/S+1, C) amax, ``build_amax`` reduced over
    the shards) skips the amax pass and scales by it; ``window`` as
    ``build_tables``."""
    kw = dict(p_ax=p_ax, layout=layout, K=K, n_seg=n_seg, pref=pref, da=da,
              db=db, dp=dp, omega=omega, verdet=verdet,
              plane_stride=plane_stride, window=window)
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4, got {bits}")
    if vols["ne"].device.type == "cpu":
        return build_quantized_tables_plain(vols, bits=bits, dither=dither,
                                            amax=amax, **kw)
    return _build(vols, mode=2 if bits == 8 else 3, dither=dither,
                  phase=0 if amax is None else 2, amax=amax, **kw)


def build_amax(vols: Dict[str, Optional[torch.Tensor]], *, p_ax: int,
               layout: ChannelLayout, K: int, n_seg: int, pref: float,
               da: float, db: float, dp: float, omega: float, verdet: float,
               plane_stride: int = 1,
               window: Optional[Window] = None) -> torch.Tensor:
    """The quantised build's first pass alone: the int32 bits of the
    (n_seg, K/S+1, C) max |value| over the (window's) cells. The bits of
    non-negative floats order as the floats do, so ``torch.maximum`` of
    the shards' results is the field's amax."""
    kw = dict(p_ax=p_ax, layout=layout, K=K, n_seg=n_seg, pref=pref, da=da,
              db=db, dp=dp, omega=omega, verdet=verdet,
              plane_stride=plane_stride, window=window)
    if vols["ne"].device.type == "cpu":
        return build_amax_plain(vols, **kw)
    return _build(vols, mode=2, dither=None, phase=1, **kw)[1]


def _build(vols, *, mode: int, p_ax: int, layout: ChannelLayout, K: int,
           n_seg: int, pref: float, da: float, db: float, dp: float,
           omega: float, verdet: float, plane_stride: int, dither: Dither,
           window: Optional[Window] = None, phase: int = 0,
           amax: Optional[torch.Tensor] = None):
    """Launch ``pack_build``: (table, None) for the float modes 0/1,
    (codes, scales) for int8 (2) and int4 (3); phase 1: (None, amax)."""
    ne = vols["ne"]
    dev = ne.device
    S = plane_stride
    if S < 1 or K % S:
        raise ValueError(f"K={K} must divide by plane_stride={S}")
    Ko = K // S
    if mode == 3 and Ko % 2:
        raise ValueError("int4 nibble packs need an even K / plane_stride")
    used = {"ne": ne}
    if layout.inv_brems:
        used.update(Te=vols["Te"], Z=vols["Z"])
    if layout.B_on:
        used["B"] = vols["B"]
    for name, t in used.items():
        _check_cuda(name, t, (torch.float32,), dev)
        want = tuple(ne.shape) + ((3,) if name == "B" else ())
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {want}")
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    dims, st = ne.shape, ne.stride()
    na, nb = dims[a_ax], dims[b_ax]
    a0, na_all, lo, hi = _window_rows(window, na)
    row = tuple(1 if d == a_ax else n for d, n in enumerate(dims))
    for name, t in (("halo lo", lo), ("halo hi", hi)):
        if t is not None:
            _check_cuda(name, t, (torch.float32,), dev)
            if tuple(t.shape) != row:
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {row}")
    halo = lo if lo is not None else hi
    hst = (0, 0) if halo is None else (halo.stride(p_ax), halo.stride(b_ax))
    if lo is not None and hi is not None and lo.stride() != hi.stride():
        raise ValueError("the two halo rows need the same strides")
    if st[p_ax] == 1 and hst[0] not in (0, 1):
        raise ValueError("halo rows need contiguous planes, as ne has")
    C = layout.n_channels
    n_blk = Ko // 2 + 1 if mode == 3 else Ko + 1
    dtype = (torch.float32, torch.bfloat16, torch.int8, torch.int8)[mode]
    out = scales = None
    if phase != 1:
        out = torch.empty((n_seg, na * nb, n_blk * C), dtype=dtype,
                          device=dev)
    if mode >= 2:
        scales = torch.empty((n_seg, Ko + 1, C), dtype=torch.float32,
                             device=dev)
        if phase == 2:
            _check_cuda("amax", amax, (torch.int32,), dev)
            if tuple(amax.shape) != (n_seg, Ko + 1, C):
                raise ValueError(f"amax: shape {tuple(amax.shape)} != "
                                 f"{(n_seg, Ko + 1, C)}")
        else:
            amax = torch.zeros((n_seg, Ko + 1, C), dtype=torch.int32,
                               device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    plan = build_plan(C, n_seg, K, S, na * nb, st[p_ax] == 1, mode,
                      n_sm=_card_limits(dev).get("n_sm", H100_SMS))
    kernel = KERNEL if window is None else WINDOW_KERNEL
    kernel.launch(
        "pack_build", dev, ptr(out), mode, ptr(scales), ptr(amax),
        ne.data_ptr(), ptr(used.get("Te")), ptr(used.get("Z")),
        ptr(used.get("B")), st[p_ax], st[a_ax], st[b_ax], a_ax, b_ax, p_ax,
        n_seg, K, S, dims[p_ax], na, nb, pref, da, db, 2.0 * dp, dp, omega,
        constants.OMEGA_PE_COEFF**2 * 1e-6 / omega**2, verdet,
        int(layout.inv_brems), int(layout.phaseshift), int(layout.B_on),
        *_dither_args(dither), a0, na_all, ptr(lo), ptr(hi), *hst, phase,
        *plan)
    return (None, amax) if phase == 1 else (out, scales)


def _dither_args(dither: Dither):
    """(on, word 0, word 1) of a dither key for the C entry points."""
    return (0, 0, 0) if dither is None else (1, int(dither[0]),
                                             int(dither[1]))


# -- quantise ----------------------------------------------------------------

def quantize_codes_plain(v: torch.Tensor, scale: torch.Tensor, qmax: float,
                         u: Optional[torch.Tensor]) -> torch.Tensor:
    """int8 codes clip(round(v / scale + u), -qmax, qmax), the dither u
    added where v is not zero (None: no dither); v, scale and u broadcast
    together."""
    x = v / scale
    if u is not None:
        x = x + torch.where(v != 0, u, torch.zeros_like(u))
    return torch.clamp(torch.round(x), -qmax, qmax).to(torch.int8)


def scales_plain(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """amax * f32(1/qmax), or 1 where amax is 0: the JAX package's compiled
    amax / qmax (XLA turns a division by a constant into a multiplication
    by its reciprocal)."""
    return torch.where(amax > 0, amax * float(np.float32(1.0 / qmax)),
                       torch.ones_like(amax))


def quantize_tables_plain(table: torch.Tensor, K: int, C: int, bits: int,
                          dither: Dither = None,
                          planes: Optional[torch.Tensor] = None,
                          offset: int = 0,
                          amax: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (codes, scales) of a float table. ``dither`` draws
    plane k of segment s from fold_in(key, planes[s, k]) over (cells, C)
    (default s*K + k, JAX's quantize_segment_pack) from flat index
    ``offset`` on; ``amax`` (n_seg, K+1, C) replaces the table's own."""
    n_seg, cells, cols = table.shape
    v = table.reshape(n_seg, cells, K + 1, C).to(torch.float32)
    qmax = 127.0 if bits == 8 else 7.0
    if amax is None:
        amax = v.abs().amax(dim=1)
    scale = scales_plain(amax, qmax)                   # (n_seg, K+1, C)
    u = None
    if dither is not None:
        if planes is None:
            planes = (torch.arange(n_seg)[:, None] * K
                      + torch.arange(K + 1)[None, :])
        u = _random.uniform_rows_plain(
            dither, planes.reshape(-1).to(table.device), cells * C, -0.5,
            0.5, offset).reshape(n_seg, K + 1, cells, C).permute(0, 2, 1, 3)
    q = quantize_codes_plain(v, scale[:, None], qmax, u)
    if bits == 8:
        return q.reshape(n_seg, cells, cols), scale
    n_blk = K // 2 + 1
    pad = 2 * n_blk - (K + 1)       # 1 for even K: the lone final plane
    q = torch.cat([q, q.new_zeros((n_seg, cells, pad, C))], dim=2)
    packed = pack_nibbles(q[:, :, 0::2], q[:, :, 1::2])
    return packed.reshape(n_seg, cells, n_blk * C), scale


def quantize_tables(table: torch.Tensor, K: int, C: int, bits: int,
                    dither: Dither = None) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Symmetric per-(segment, plane, channel) int8 (``bits=8``) or int4
    nibble-pair (``bits=4``) codes and their f32 scales; ``dither`` (a
    key's two words) as ``quantize_tables_plain``."""
    if table.device.type == "cpu":
        return quantize_tables_plain(table, K, C, bits, dither)
    dev = table.device
    _check_cuda("table", table, (torch.float32, torch.bfloat16), dev)
    n_seg, cells, cols = table.shape
    if cols != (K + 1) * C:
        raise ValueError(f"table rows hold {cols} values, not (K+1)*C")
    n_blk = K // 2 + 1 if bits == 4 else K + 1
    codes = torch.empty((n_seg, cells, n_blk * C), dtype=torch.int8,
                        device=dev)
    scales = torch.empty((n_seg, K + 1, C), dtype=torch.float32, device=dev)
    amax = torch.zeros((n_seg, K + 1, C), dtype=torch.int32, device=dev)
    KERNEL.launch("pack_quantize", dev, table.data_ptr(),
                  int(table.dtype == torch.bfloat16), codes.data_ptr(),
                  scales.data_ptr(), amax.data_ptr(), n_seg, cells, K, C,
                  bits, *_dither_args(dither))
    return codes, scales


# -- decimate ----------------------------------------------------------------

def decimate_tables_plain(table: torch.Tensor, K: int, C: int, stride: int,
                          nibbles: bool) -> torch.Tensor:
    """Plain version: keep every ``stride``-th plane of each row."""
    n_seg, cells, _ = table.shape
    Kd = K // stride
    if not nibbles:
        v = table.reshape(n_seg, cells, K + 1, C)[:, :, ::stride]
        return v.reshape(n_seg, cells, (Kd + 1) * C)
    n_blk, n_blk_d = K // 2 + 1, Kd // 2 + 1
    v = table.reshape(n_seg, cells, n_blk, C)
    planes = torch.stack([nibble_lo(v), nibble_hi(v)], dim=3).reshape(
        n_seg, cells, 2 * n_blk, C)[:, :, :K + 1:stride]
    pad = 2 * n_blk_d - (Kd + 1)
    planes = torch.cat([planes, planes.new_zeros((n_seg, cells, pad, C))],
                       dim=2)
    return pack_nibbles(planes[:, :, 0::2], planes[:, :, 1::2]).reshape(
        n_seg, cells, n_blk_d * C)


# the decimator's tiles (csrc/pack.cu decimate_kernel): about this many
# bytes of input rows a tile, a ring of this many staged tiles, at most this
# many persistent blocks an SM (chosen by variant runs at 512^3, K = 512,
# C = 3 on an H100 80GB HBM3 at 700 W, PERF.md §6: the bf16, f32 and int8
# tiles are their 16-byte minimum of ~24 KB anyway; int4 ran faster in
# ~12 KB tiles, four blocks an SM, and every form with two stages than
# with three); the mbarriers before the stages; the
# H100's SMs and shared memory (opt-in per block, per SM) where PyTorch
# does not report them
DEC_TILE_BYTES = 12 * 1024
DEC_STAGES = 2
DEC_BLOCKS_PER_SM = 4
DEC_BARS = 128
H100_SMS = 132
H100_SMEM_OPTIN = 232_448
H100_SMEM_PER_SM = 233_472


class DecimatePlan(NamedTuple):
    """How ``pack_decimate`` walks a (rows, ncol_in) table: ``tiles``
    tiles of ``R`` whole rows, each one bulk copy in (``R * ncol_in *
    elem_bytes`` bytes) and one out, through a ring of ``stages``
    shared-memory tiles, then the ``tail_rows`` last rows by a plain row
    loop, in ``blocks`` persistent blocks of ``smem`` bytes of dynamic
    shared memory (0 without tiles)."""
    rows: int
    ncol_in: int
    ncol_out: int
    elem_bytes: int
    Kd: int
    R: int
    stages: int
    tiles: int
    tail_rows: int
    smem: int
    blocks: int


def decimate_plan(elem_bytes: int, nibbles: bool, n_seg: int, cells: int,
                  K: int, C: int, stride: int, aligned: bool = True,
                  n_sm: int = H100_SMS, smem_optin: int = H100_SMEM_OPTIN,
                  smem_per_sm: int = H100_SMEM_PER_SM) -> DecimatePlan:
    """The decimator's tile plan. R is a multiple of 16 / gcd(row bytes,
    16) for the rows in and out, so that every tile starts and ends on a
    16-byte boundary of a 16-byte aligned table, as near ``DEC_TILE_BYTES``
    in as such an R comes; the ring is as deep as ``smem_optin`` allows,
    and a tile that does not fit one stage raises ValueError. A table
    whose start is not 16-byte aligned (``aligned`` False) goes through
    the row loop alone."""
    if stride < 1 or K % stride:
        raise ValueError(f"K={K} must divide by stride={stride}")
    Kd = K // stride
    if nibbles:
        elem_bytes = 1
        ncol_in, ncol_out = (K // 2 + 1) * C, (Kd // 2 + 1) * C
    else:
        ncol_in, ncol_out = (K + 1) * C, (Kd + 1) * C
    rows = n_seg * cells
    row_in, row_out = ncol_in * elem_bytes, ncol_out * elem_bytes
    unit = math.lcm(16 // math.gcd(row_in, 16), 16 // math.gcd(row_out, 16))
    R = unit * max(1, (2 * DEC_TILE_BYTES + unit * row_in)
                   // (2 * unit * row_in))

    def smem_of(stages):
        return DEC_BARS + stages * R * row_in + 2 * R * row_out

    stages = DEC_STAGES
    while stages > 1 and smem_of(stages) > smem_optin:
        stages -= 1
    if smem_of(stages) > smem_optin:
        form = "nibble pairs" if nibbles else f"{elem_bytes}-byte values"
        raise ValueError(
            f"decimate: a tile of {R} rows of {row_in} bytes (K = {K}, "
            f"C = {C}, stride {stride}, {form}) needs {smem_of(1)} bytes of "
            f"shared memory, above the card's {smem_optin}")
    tiles = rows // R if aligned else 0
    if tiles:
        smem = smem_of(stages)
        per_sm = max(1, min(DEC_BLOCKS_PER_SM, smem_per_sm // (smem + 1024)))
        blocks = min(max(tiles, rows - tiles * R), n_sm * per_sm)
    else:
        stages = smem = 0
        blocks = max(1, min(rows, n_sm * 8))
    return DecimatePlan(rows, ncol_in, ncol_out, elem_bytes, Kd, R, stages,
                        tiles, rows - tiles * R, smem, blocks)


def _card_limits(dev: torch.device) -> dict:
    """The card's SM count and shared memory for ``decimate_plan`` (and
    its SM count for ``build_plan``)."""
    if dev.type != "cuda":
        return {}
    p = torch.cuda.get_device_properties(dev)
    return dict(n_sm=p.multi_processor_count,
                smem_optin=getattr(p, "shared_memory_per_block_optin",
                                   H100_SMEM_OPTIN),
                smem_per_sm=getattr(p, "shared_memory_per_multiprocessor",
                                    H100_SMEM_PER_SM))


def decimate_tables(table: torch.Tensor, K: int, C: int, stride: int,
                    nibbles: bool = False) -> torch.Tensor:
    """Rows of a (n_seg, cells, blocks*C) table with every ``stride``-th
    plane kept; ``nibbles`` marks int4 nibble-pair rows."""
    if table.device.type == "cpu":
        return decimate_tables_plain(table, K, C, stride, nibbles)
    dev = table.device
    _check_cuda("table", table,
                (torch.float32, torch.bfloat16, torch.int8), dev)
    n_seg, cells, cols = table.shape
    n_blk_d = (K // stride) // 2 + 1 if nibbles else K // stride + 1
    out = torch.empty((n_seg, cells, n_blk_d * C), dtype=table.dtype,
                      device=dev)
    plan = decimate_plan(table.element_size(), nibbles, n_seg, cells, K, C,
                         stride, aligned=table.data_ptr() % 16 == 0
                         and out.data_ptr() % 16 == 0, **_card_limits(dev))
    if cols != plan.ncol_in:
        raise ValueError(f"table rows hold {cols} values, not "
                         f"{plan.ncol_in} (K = {K}, C = {C})")
    KERNEL.launch("pack_decimate", dev, table.data_ptr(), out.data_ptr(),
                  plan.elem_bytes, int(nibbles), plan.rows, plan.ncol_in,
                  plan.ncol_out, C, stride, plan.Kd, plan.R, plan.stages,
                  plan.tiles, plan.blocks, plan.smem)
    return out
