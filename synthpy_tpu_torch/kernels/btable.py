"""K14: the plane-batch write of a reduced-precision B table.

``write`` launches ``btable_write`` of ``csrc/btable.cu`` on CUDA tensors
and runs ``write_plain``, its plain PyTorch version, on CPU tensors. Both
write one (pb, ny, nz, 3) float32 batch into an (nx, ny, nz, 3) table at
plane ``i0`` in place, as the device route of the JAX package's
``build_B_table`` (``synthpy_tpu/tracer/particles.py:134-145``): a
bfloat16 cast, or int8 codes clip(round(batch / scale + u), -127, 127)
with u the dither drawn under ``key`` (the caller's
``fold_in(PRNGKey(dither), i0)``) over the batch's row-major counters, or
none. The quotient is XLA's: the batch times the float32 reciprocal of
the scale, fused with the dither's add into one multiply-add. A float32
table takes a plain copy (no kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from synthpy_tpu_torch.kernels import random as _random
from synthpy_tpu_torch.kernels._build import I, L, P, Kernel, refuse_grad
from synthpy_tpu_torch.ops.interp import fma

KERNEL = Kernel("btable.cu", {
    "btable_write": [P, I, P, L, P, I, L, L, P],
}, flags=["--fmad=false"])

_MODES = {torch.bfloat16: 1, torch.int8: 2}


def codes_plain(batch: torch.Tensor, scale: torch.Tensor,
                key: Optional[Tuple[int, int]]) -> torch.Tensor:
    """int8 codes of a float32 batch: the product with the (3,) scales'
    float32 reciprocals (with the dither of ``key``, a fused multiply-add;
    None: no dither), round half to even, clip."""
    scale = scale.to(batch.device, torch.float32)
    rcp = torch.ones_like(scale) / scale
    if key is None:
        q = batch * rcp
    else:
        u = _random.draw_plain(key, batch.numel(), "uniform", -0.5, 0.5,
                               batch.device)
        q = fma(batch, rcp, u.reshape(batch.shape))
    return torch.clamp(torch.round(q), -127.0, 127.0).to(torch.int8)


def write_plain(tab: torch.Tensor, batch: torch.Tensor, i0: int,
                scale: Optional[torch.Tensor] = None,
                key: Optional[Tuple[int, int]] = None) -> None:
    """Plain version of ``write``, in place."""
    pb = batch.shape[0]
    if tab.dtype == torch.int8:
        tab[i0:i0 + pb] = codes_plain(batch, scale, key)
    else:
        tab[i0:i0 + pb] = batch.to(tab.dtype)


def write(tab: torch.Tensor, batch: torch.Tensor, i0: int,
          scale: Optional[torch.Tensor] = None,
          key: Optional[Tuple[int, int]] = None) -> None:
    """Write the (pb, ny, nz, 3) float32 ``batch`` into planes i0 .. i0+pb-1
    of the (nx, ny, nz, 3) table ``tab`` (float32, bfloat16 or int8 with
    (3,) float32 ``scale``), int8 dithered by the key words ``key``."""
    if tab.device.type == "cpu":
        write_plain(tab, batch, i0, scale, key)
        return
    refuse_grad("btable.write (K14)", batch, scale)
    dev = tab.device
    pb = batch.shape[0]
    if (batch.device != dev or batch.dtype != torch.float32
            or not batch.is_contiguous()
            or tuple(batch.shape[1:]) != tuple(tab.shape[1:])
            or not tab.is_contiguous() or i0 < 0
            or i0 + pb > tab.shape[0]):
        raise ValueError("batch must be a contiguous float32 (pb, ny, nz, 3) "
                         "tensor on the table's device that fits at i0")
    if tab.dtype == torch.float32:
        tab[i0:i0 + pb].copy_(batch)
        return
    if tab.dtype not in _MODES:
        raise ValueError(f"unsupported table dtype {tab.dtype}")
    int8 = tab.dtype == torch.int8
    if int8 and (scale is None or scale.device != dev
                 or scale.dtype != torch.float32 or scale.shape != (3,)):
        raise ValueError("an int8 table needs (3,) float32 scales on its "
                         "device")
    if int8 and batch.numel() >= 2**32:
        raise ValueError(f"an int8 batch of {batch.numel()} values: K14 "
                         "takes fewer than 2^32")
    on, k0, k1 = (0, 0, 0) if key is None else (1, int(key[0]),
                                                 int(key[1]))
    KERNEL.launch("btable_write", dev, tab[i0].data_ptr(), _MODES[tab.dtype],
                  batch.data_ptr(), batch.numel(),
                  scale.data_ptr() if int8 else None, on, k0, k1)
