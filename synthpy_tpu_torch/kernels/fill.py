"""K9: the plane-batch fill of the scale pack builders.

``fill`` launches ``pack_fill`` of ``csrc/fill.cu`` on CUDA tensors and runs
``fill_plain``, its plain PyTorch version, on CPU tensors. Both compute the
pack channels of one batch of planes (the JAX package's
``_channel_batch_writer.write``, ``synthpy_tpu/tracer/zscan.py:2041``),
quantise them per (plane, channel) with an optional dither, and write them
in place into a segment table and its scales: the body of
``tracer.zscan.build_segment_pack_upload`` and ``build_segment_pack_synth``.
The channel and quantiser arithmetic is K2's (``kernels.pack``), so a pack
filled batch by batch equals ``build_segment_pack_device`` of the same
volumes bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from synthpy_tpu_torch import constants
from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels import random as _random
from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel
from synthpy_tpu_torch.kernels.pack import (Dither, _check_cuda,
                                            _dither_args, channels_plain,
                                            pack_nibbles,
                                            quantize_codes_plain,
                                            scales_plain)

KERNEL = Kernel("fill.cu", {
    "pack_fill": [P, I, L, P, P, P, P, L, L, I, I, I, I, I, I, F, F, F, F, F,
                  F, F, F, I, I, I, I, L, L, P],
}, flags=["--fmad=false"])

_MODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, "int4": 3}


def mode_of(dtype) -> int:
    """The fill mode of a pack dtype: f32, bf16, int8 or "int4"."""
    key = "int4" if isinstance(dtype, str) and dtype == "int4" else dtype
    if key not in _MODES:
        raise ValueError(f"unsupported pack dtype {dtype!r}")
    return _MODES[key]


def fill_plain(buf: torch.Tensor, scl: Optional[torch.Tensor],
               slab: torch.Tensor, ex: torch.Tensor, *, g0: int, seg_i: int,
               col0: int, k0: int, pb: int, lone: bool, mode: int,
               layout: ChannelLayout, n_p: int, pref: float, da: float,
               db: float, dp: float, omega: float, verdet: float,
               dither: Dither = None) -> None:
    """Plain version of ``fill``, in place."""
    na, nb = slab.shape[1:]
    C = layout.n_channels
    g = torch.arange(g0, g0 + pb)
    extras = [ex[:, e] for e in range(ex.shape[1])]
    out = channels_plain(slab, extras, g, layout=layout, n_p=n_p, pref=pref,
                         da=da, db=db, dp=dp, omega=omega, verdet=verdet)
    if mode < 2:
        blk = out.to(torch.float32 if mode == 0 else torch.bfloat16)
    else:
        qmax = 7.0 if mode == 3 else 127.0
        scale = scales_plain(out.abs().amax(dim=(1, 2)), qmax)   # (pb, C)
        u = None
        if dither is not None:
            u = _random.uniform_rows_plain(
                dither, g.to(slab.device), na * nb * C, -0.5,
                0.5).reshape(pb, na, nb, C)
        blk = quantize_codes_plain(out, scale[:, None, None], qmax, u)
        if mode == 3:
            if lone:
                blk = torch.cat([blk, blk.new_zeros((1, na, nb, C))])
            blk = pack_nibbles(blk[0::2], blk[1::2])
        rows = 1 if lone else pb
        scl[seg_i, k0:k0 + rows] = scale[:rows]
    blk = blk.permute(1, 2, 0, 3).reshape(na * nb, -1)
    buf[seg_i, :, col0:col0 + blk.shape[1]] = blk


def fill(buf: torch.Tensor, scl: Optional[torch.Tensor], slab: torch.Tensor,
         ex: torch.Tensor, *, g0: int, seg_i: int, col0: int, k0: int,
         pb: int, lone: bool, mode: int, layout: ChannelLayout, n_p: int,
         pref: float, da: float, db: float, dp: float, omega: float,
         verdet: float, dither: Dither = None) -> None:
    """Compute the channels of ``pb`` body planes (absolute ``g0`` ..) and
    write them into segment ``seg_i`` of ``buf`` from column ``col0``, their
    scales (quantised modes) into ``scl[seg_i, k0:]``.

    ``slab``: (pb+2, na, nb) f32 ne planes g0-1 .. g0+pb (plane 0 repeated
    before the grid, zeros past it); ``ex``: (pb, n_extra, na, nb) f32
    pointwise volumes (Te, Z, then B along a, b, p, as the layout needs;
    any strides along its first two axes). ``mode``: 0 f32, 1 bf16, 2
    int8, 3 int4 (``lone``: one plane, high nibble zero). ``dither``: a
    key's two words, or None.
    """
    kw = dict(g0=g0, seg_i=seg_i, col0=col0, k0=k0, pb=pb, lone=lone,
              mode=mode, layout=layout, n_p=n_p, pref=pref, da=da, db=db,
              dp=dp, omega=omega, verdet=verdet, dither=dither)
    if buf.device.type == "cpu":
        fill_plain(buf, scl, slab, ex, **kw)
        return
    dev = buf.device
    na, nb = slab.shape[1:]
    C = layout.n_channels
    n_extra = 2 * layout.inv_brems + 3 * layout.B_on
    _check_cuda("slab", slab, (torch.float32,), dev)
    if tuple(slab.shape) != (pb + 2, na, nb):
        raise ValueError(f"slab shape {tuple(slab.shape)} != "
                         f"{(pb + 2, na, nb)}")
    if n_extra and (ex.device != dev or ex.dtype != torch.float32
                    or tuple(ex.shape[:2]) != (pb, n_extra)
                    or tuple(ex.shape[2:]) != (na, nb)
                    or ex.stride()[2:] != (nb, 1)):
        raise ValueError("ex must be a (pb, n_extra, na, nb) float32 tensor "
                         "on the pack's device, rows contiguous")
    if mode == 3 and (pb != 1 if lone else pb % 2):
        raise ValueError(f"an int4 batch takes plane pairs or one lone "
                         f"plane, not pb={pb} (lone={lone})")
    want = {0: torch.float32, 1: torch.bfloat16}.get(mode, torch.int8)
    _check_cuda("buf", buf, (want,), dev)
    n_blk = (pb + 1) // 2 if mode == 3 else pb
    if buf.dim() != 3 or buf.shape[1] != na * nb or (
            col0 + n_blk * C > buf.shape[2]):
        raise ValueError(f"buf shape {tuple(buf.shape)} cannot take the "
                         "batch's columns")
    if mode >= 2:
        _check_cuda("scl", scl, (torch.float32,), dev)
    amax = torch.zeros((pb, C), dtype=torch.int32, device=dev)
    out = buf[seg_i, 0, col0:]
    KERNEL.launch(
        "pack_fill", dev, out.data_ptr(), mode, buf.shape[2],
        None if mode < 2 else scl[seg_i, k0].data_ptr(), amax.data_ptr(),
        slab.data_ptr(), ex.data_ptr() if n_extra else None,
        ex.stride(0) if n_extra else 0, ex.stride(1) if n_extra else 0,
        g0, pb, int(lone), n_p, na, nb, pref, da, db, 2.0 * dp, dp, omega,
        constants.OMEGA_PE_COEFF**2 * 1e-6 / omega**2, verdet,
        int(layout.inv_brems), int(layout.phaseshift), int(layout.B_on),
        *_dither_args(dither))
