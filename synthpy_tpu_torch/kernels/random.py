"""K10: JAX's threefry random streams, drawn on the card.

``draw`` launches ``random_draw`` of ``csrc/random.cu`` for a CUDA device
and runs ``draw_plain``, its plain PyTorch version, for the CPU. Both give
the draws of flat index 0 .. n-1 of ``jax.random.bits`` (mode "bits"),
``uniform`` ("uniform", on [lo, hi)) or ``normal`` ("normal") under one
key, with ``jax_threefry_partitionable`` on (the JAX default): bits and
uniforms bit for bit, normals to a few ulp (XLA's float32 ``erf_inv`` on
the accurate ``log1p``; the CPU's ``log1p`` and the card's differ in the
last place). The stream (``csrc/threefry.cuh``) is shared with the dither
of K2 and K9; ``uniform_rows_plain`` is their plain versions' draw.

The plain version holds the 32-bit words in int64 tensors, masking after
every add, because PyTorch's uint32 arithmetic is partial. It draws in
chunks of ``CHUNK`` so that a large draw holds a few chunk-sized
temporaries.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel

KERNEL = Kernel("random.cu", {
    "random_draw": [P, I, L, L, L, L, F, F, P],
}, flags=["--fmad=false"])

MODES = {"bits": 0, "uniform": 1, "normal": 2}
MASK = 0xFFFFFFFF
CHUNK = 1 << 22
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's float32 ErfInv coefficients (Giles), for w < 5 and w >= 5
_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
        1.50140941)
_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2 = float(np.float32(np.sqrt(2.0)))


def hash_plain(k0, k1, x0: torch.Tensor, x1: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry-2x32 of the counter words (x0, x1) under the key (k0, k1):
    ints or int64 tensors holding uint32 values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for g in range(5):
        for r in _ROT[g & 1]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK
    return x0, x1


def _bits_of(k0, k1, i: torch.Tensor) -> torch.Tensor:
    y0, y1 = hash_plain(k0, k1, i >> 32, i & MASK)
    return y0 ^ y1


def unit_float(b: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from random words: the top 23 bits as the
    mantissa of [1, 2), minus 1."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def scale_uniform(f: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """max(lo, f * (hi - lo) + lo) in float32, as jax.random.uniform."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = torch.tensor(float(hi32 - lo32), dtype=torch.float32,
                        device=f.device)
    lo_t = torch.tensor(float(lo32), dtype=torch.float32, device=f.device)
    return torch.maximum(lo_t, f * span + lo_t)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ErfInv: Giles' polynomial in w = -log1p(-x^2), in
    float32 without fused multiply-adds."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_LT5[i], dtype=torch.float32,
                                            device=x.device),
                           torch.tensor(_GE5[i], dtype=torch.float32,
                                        device=x.device))

    p = coef(0)
    for i in range(1, 9):
        p = coef(i) + p * w
    big = torch.tensor(float(np.finfo(np.float32).max), dtype=torch.float32,
                       device=x.device)
    return torch.where(x.abs() == 1.0, x * big, p * x)


def draw_plain(key: Tuple[int, int], n: int, mode: str, lo: float = 0.0,
               hi: float = 1.0, device="cpu",
               offset: int = 0) -> torch.Tensor:
    """Plain version of ``draw``: the (n,) draws on ``device``."""
    k0, k1 = key
    out = torch.empty((n,), dtype=torch.int32 if mode == "bits"
                      else torch.float32, device=device)
    for i0 in range(0, n, CHUNK):
        i = torch.arange(offset + i0, offset + min(i0 + CHUNK, n),
                         dtype=torch.int64, device=device)
        b = _bits_of(k0, k1, i)
        if mode == "bits":
            out[i0:i0 + i.numel()] = b.to(torch.int32)
            continue
        if mode == "uniform":
            out[i0:i0 + i.numel()] = scale_uniform(unit_float(b), lo, hi)
            continue
        u = scale_uniform(unit_float(b), NORMAL_LO, 1.0)
        out[i0:i0 + i.numel()] = SQRT2 * erf_inv(u)
    return out.view(torch.uint32) if mode == "bits" else out


def draw(key: Tuple[int, int], n: int, mode: str, lo: float = 0.0,
         hi: float = 1.0, device="cuda", offset: int = 0) -> torch.Tensor:
    """(n,) draws of flat index offset .. offset+n-1 under ``key`` (two
    uint32 ints): ``mode`` "bits" (uint32), "uniform" on [lo, hi) or
    "normal" (float32). K10 on a CUDA device, the plain version on the
    CPU."""
    dev = torch.device(device)
    if mode not in MODES:
        raise ValueError(f"unknown draw mode {mode!r}")
    if dev.type == "cpu":
        return draw_plain(key, n, mode, lo, hi, dev, offset)
    out = torch.empty((n,), dtype=torch.int32 if mode == "bits"
                      else torch.float32, device=dev)
    KERNEL.launch("random_draw", dev, out.data_ptr(), MODES[mode],
                  int(key[0]), int(key[1]), int(n), int(offset), float(lo),
                  float(hi))
    return out.view(torch.uint32) if mode == "bits" else out


def uniform_rows_plain(key: Tuple[int, int], planes: torch.Tensor, n: int,
                       lo: float, hi: float,
                       offset: int = 0) -> torch.Tensor:
    """(P, n) float32 uniforms: row p is flat indices offset .. offset+n-1
    of ``uniform(fold_in(key, planes[p]), ..., lo, hi)``, on ``planes``'
    device. The dither of the plain K2 and K9 versions (JAX: a vmap of
    uniform over fold_in keys)."""
    g = planes.to(torch.int64) & MASK
    k0, k1 = hash_plain(int(key[0]), int(key[1]), torch.zeros_like(g), g)
    out = torch.empty((planes.numel(), n), dtype=torch.float32,
                      device=planes.device)
    rows = max(1, CHUNK // max(n, 1))
    i = torch.arange(offset, offset + n, dtype=torch.int64,
                     device=planes.device)
    for p0 in range(0, planes.numel(), rows):
        b = _bits_of(k0[p0:p0 + rows, None], k1[p0:p0 + rows, None],
                     i[None, :])
        out[p0:p0 + b.shape[0]] = scale_uniform(unit_float(b), lo, hi)
    return out
