"""JAX's threefry random streams in PyTorch (the port of ``jax.random``
that the JAX package draws from).

A key is a (2,) int64 tensor on the CPU holding the two uint32 words of a
raw JAX key (``PRNGKey(seed)`` is ``[0, seed mod 2**32]``, as JAX makes it
with 64-bit types off); ``split`` gives an (num, 2) tensor of keys.
``split``, ``fold_in`` and ``bits`` are the threefry-2x32 hash of
``jax_threefry_partitionable`` mode (JAX's default): ``bits`` hashes the
flat index of each draw, ``fold_in(key, d)`` the pair (0, d) and ``split``
the pairs (0, i). ``uniform`` and ``normal`` turn the bits into floats
as ``jax.random`` does; ``normal`` uses XLA's float32 ``erf_inv``. Bits,
keys and uniforms are JAX's bit for bit; normals are within a few ulp
(``log1p`` differs in the last place between the libraries).

The draws run kernel K10 (``kernels.random``) on a CUDA device and its
plain version on the CPU. Anything ``numpy.asarray`` takes as a raw key
(a JAX ``PRNGKey``, a (2,) uint32 array, a pair of ints) is accepted where
a key is; ``convert.key`` also takes JAX's typed keys.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from synthpy_tpu_torch import _device
from synthpy_tpu_torch.kernels import random as _k

MASK = _k.MASK


def key_data(key) -> Tuple[int, int]:
    """The two uint32 words of a key, as Python ints."""
    if isinstance(key, torch.Tensor):
        words = key.detach().to("cpu", torch.int64).reshape(-1).tolist()
    else:
        words = np.asarray(key).astype(np.int64).reshape(-1).tolist()
    if len(words) != 2:
        raise ValueError(f"a key has two words, got {len(words)}")
    return int(words[0]) & MASK, int(words[1]) & MASK


def PRNGKey(seed: int) -> torch.Tensor:
    """The raw key of an integer seed: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def key_of(key_or_seed) -> Tuple[int, int]:
    """The words of a key, or of ``PRNGKey(seed)`` for an int seed (the
    JAX package's ``dither=`` and ``seed`` arguments take either)."""
    if isinstance(key_or_seed, (int, np.integer)):
        return key_data(PRNGKey(int(key_or_seed)))
    return key_data(key_or_seed)


def split(key, num: int = 2) -> torch.Tensor:
    """(num, 2) keys: threefry of (0, i) for i < num."""
    k0, k1 = key_data(key)
    i = torch.arange(num, dtype=torch.int64)
    y0, y1 = _k.hash_plain(k0, k1, torch.zeros_like(i), i)
    return torch.stack([y0, y1], dim=1)


def fold_in(key, data: int) -> torch.Tensor:
    """The key threefry(key, (0, data mod 2**32))."""
    k0, k1 = key_data(key)
    d = torch.tensor([int(data) & MASK], dtype=torch.int64)
    y0, y1 = _k.hash_plain(k0, k1, torch.zeros_like(d), d)
    return torch.cat([y0, y1])


def _shape(shape) -> Tuple[int, ...]:
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


def bits(key, shape: Union[int, Sequence[int]] = (),
         device="cuda") -> torch.Tensor:
    """uint32 random bits of ``shape`` (jax.random.bits)."""
    shape = _shape(shape)
    out = _k.draw(key_data(key), math.prod(shape), "bits",
                  device=_device.resolve(device))
    return out.reshape(shape)


def uniform(key, shape: Union[int, Sequence[int]] = (),
            dtype=torch.float32, minval: float = 0.0, maxval: float = 1.0,
            device="cuda") -> torch.Tensor:
    """float32 uniforms on [minval, maxval) (jax.random.uniform)."""
    if dtype != torch.float32:
        raise ValueError("the port draws float32 uniforms only")
    shape = _shape(shape)
    out = _k.draw(key_data(key), math.prod(shape), "uniform", minval,
                  maxval, device=_device.resolve(device))
    return out.reshape(shape)


def normal(key, shape: Union[int, Sequence[int]] = (),
           dtype=torch.float32, device="cuda") -> torch.Tensor:
    """float32 standard normals (jax.random.normal)."""
    if dtype != torch.float32:
        raise ValueError("the port draws float32 normals only")
    shape = _shape(shape)
    out = _k.draw(key_data(key), math.prod(shape), "normal",
                  device=_device.resolve(device))
    return out.reshape(shape)


def permutation(key, n: int, device="cuda") -> torch.Tensor:
    """A permutation of range(n) (jax.random.permutation of an int): rounds
    of a stable sort by fresh 32-bit keys, ceil(3 ln n / ln(2**32 - 1)) of
    them, each round's keys from the second half of ``split(key)``."""
    dev = _device.resolve(device)
    x = torch.arange(n, dtype=torch.int64, device=dev)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(
        np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        sort_keys = bits(sub, (n,), device=dev).view(torch.int32).to(
            torch.int64) & MASK
        x = x[torch.argsort(sort_keys, stable=True)]
    return x


def choice(key, a: int, shape: Union[int, Sequence[int]] = (),
           device="cuda") -> torch.Tensor:
    """Indices drawn from range(a) without replacement: the first draws of
    ``permutation``, as jax.random.choice(key, a, shape, replace=False)
    with ``p=None``."""
    shape = _shape(shape)
    n = math.prod(shape)
    if n > a:
        raise ValueError(f"Cannot take a larger sample (size {n}) than "
                         f"population (size {a}) when 'replace=False'")
    return permutation(key, a, device)[:n].reshape(shape)
