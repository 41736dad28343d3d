"""K10: JAX's threefry random streams, drawn on the card.

``draw`` launches ``random_draw`` of ``csrc/random.cu`` for a CUDA device
and runs ``draw_plain``, its plain PyTorch version, for the CPU. Both give
the draws of flat index 0 .. n-1 of ``jax.random.bits`` (mode "bits"),
``uniform`` ("uniform", on [lo, hi)) or ``normal`` ("normal") under one
key, with ``jax_threefry_partitionable`` on (the JAX default): bits and
uniforms bit for bit, normals to a few ulp (XLA's float32 ``erf_inv`` on
the accurate ``log1p``; the CPU's ``log1p`` and the card's differ in the
last place). ``draw_many`` draws up to ``MAX_STREAMS`` streams of one
length in one launch, a row each (a beam's four streams), and
``draw_pair`` two normal streams as one complex64 tensor, real parts from
the first (the GRF's noise); ``draw_many_plain`` and ``draw_pair_plain``
are their plain versions. The stream (``csrc/threefry.cuh``) is shared
with the dither of K2, K9 and K14; ``uniform_rows_plain`` is their plain
versions' draw.

The plain version holds the 32-bit words in int64 tensors, masking after
every add, because PyTorch's uint32 arithmetic is partial. It draws in
chunks of ``CHUNK`` so that a large draw holds a few chunk-sized
temporaries.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from synthpy_tpu_torch.kernels._build import I, L, P, Kernel

KERNEL = Kernel("random.cu", {
    "random_draw": [P, I, P, P, P, P, L, L, I, P],
}, flags=["--fmad=false"])

MODES = {"bits": 0, "uniform": 1, "normal": 2}
MAX_STREAMS = 8  # streams of one launch (random.cu)
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


def _launch(out: torch.Tensor, keys, modes, lo, hi, n: int,
            offset: int) -> None:
    """One ``random_draw`` launch of len(keys) streams into ``out``: rows
    in ``modes`` on [``lo``, ``hi``), or with ``modes`` None two streams'
    normals as (re, im) pairs."""
    S = len(keys)
    words = (ctypes.c_uint32 * (2 * S))(*[int(w) & MASK for k in keys
                                          for w in k])
    # the host arrays stay referenced until the call returns
    arrays = [] if modes is None else [
        (ctypes.c_int * S)(*[MODES[m] for m in modes]),
        (ctypes.c_float * S)(*[float(v) for v in lo]),
        (ctypes.c_float * S)(*[float(v) for v in hi])]
    args = [ctypes.addressof(a) for a in arrays] or [None, None, None]
    KERNEL.launch("random_draw", out.device, out.data_ptr(), S,
                  ctypes.addressof(words), *args, int(n), int(offset),
                  int(modes is None))


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown draw mode {mode!r}")


def draw(key: Tuple[int, int], n: int, mode: str, lo: float = 0.0,
         hi: float = 1.0, device="cuda", offset: int = 0) -> torch.Tensor:
    """(n,) draws of flat index offset .. offset+n-1 under ``key`` (two
    uint32 ints): ``mode`` "bits" (uint32), "uniform" on [lo, hi) or
    "normal" (float32). K10 on a CUDA device, the plain version on the
    CPU."""
    dev = torch.device(device)
    _check_mode(mode)
    if dev.type == "cpu":
        return draw_plain(key, n, mode, lo, hi, dev, offset)
    out = torch.empty((n,), dtype=torch.int32 if mode == "bits"
                      else torch.float32, device=dev)
    _launch(out, [key], [mode], [lo], [hi], n, offset)
    return out.view(torch.uint32) if mode == "bits" else out


def _per_row(v, S: int) -> Sequence[float]:
    return [v] * S if isinstance(v, (int, float)) else list(v)


def draw_many_plain(keys: Sequence[Tuple[int, int]], n: int,
                    modes: Sequence[str], lo: Union[float, Sequence] = 0.0,
                    hi: Union[float, Sequence] = 1.0, device="cpu",
                    offset: int = 0) -> torch.Tensor:
    """Plain version of ``draw_many``: one ``draw_plain`` a row."""
    S = len(keys)
    lo, hi = _per_row(lo, S), _per_row(hi, S)
    return torch.stack([draw_plain(k, n, m, a, b, device, offset)
                        for k, m, a, b in zip(keys, modes, lo, hi)])


def draw_many(keys: Sequence[Tuple[int, int]], n: int,
              modes: Sequence[str], lo: Union[float, Sequence] = 0.0,
              hi: Union[float, Sequence] = 1.0, device="cuda",
              offset: int = 0) -> torch.Tensor:
    """(S, n) float32 draws, row s those of ``draw(keys[s], n, modes[s],
    lo[s], hi[s], offset=offset)``: S = len(keys) <= ``MAX_STREAMS``
    streams, each "uniform" or "normal"; ``lo`` and ``hi`` a float for
    every row or one a row. One K10 launch on a CUDA device, the plain
    version on the CPU."""
    S = len(keys)
    if not 1 <= S <= MAX_STREAMS or len(modes) != S:
        raise ValueError(f"{S} keys and {len(modes)} modes: draw_many "
                         f"takes 1-{MAX_STREAMS} streams, a mode each")
    for m in modes:
        _check_mode(m)
        if m == "bits":
            raise ValueError("draw_many draws float rows: take bits with "
                             "draw")
    lo, hi = _per_row(lo, S), _per_row(hi, S)
    dev = torch.device(device)
    if dev.type == "cpu":
        return draw_many_plain(keys, n, modes, lo, hi, dev, offset)
    out = torch.empty((S, n), dtype=torch.float32, device=dev)
    _launch(out, keys, modes, lo, hi, n, offset)
    return out


def draw_pair_plain(key_re: Tuple[int, int], key_im: Tuple[int, int],
                    n: int, device="cpu", offset: int = 0) -> torch.Tensor:
    """Plain version of ``draw_pair``: two ``draw_plain`` normals."""
    return torch.complex(draw_plain(key_re, n, "normal", device=device,
                                    offset=offset),
                         draw_plain(key_im, n, "normal", device=device,
                                    offset=offset))


def draw_pair(key_re: Tuple[int, int], key_im: Tuple[int, int], n: int,
              device="cuda", offset: int = 0) -> torch.Tensor:
    """(n,) complex64 ``normal(key_re) + 1j normal(key_im)`` at flat
    indices offset .. offset+n-1 (JAX's ``normal(kr) + 1j * normal(ki)``).
    One K10 launch writing the pairs in place on a CUDA device, the plain
    version on the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return draw_pair_plain(key_re, key_im, n, dev, offset)
    out = torch.empty((n,), dtype=torch.complex64, device=dev)
    _launch(out, [key_re, key_im], None, None, None, n, offset)
    return out


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
