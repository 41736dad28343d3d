"""Ray-bundle initialisation (PyTorch port of ``synthpy_tpu.tracer.beam``).

Builds the (9, Np) initial ray state s0 = (x, y, z, vx, vy, vz, amp,
phase, pol) for the 'circular', 'square', 'rectangular', 'linear', 'even'
and 'rect_trackers' beams. Random draws come from a key
(``synthpy_tpu_torch.random.PRNGKey``, or a JAX key through
``convert.key``), which draws the JAX package's stream: the same key gives
JAX's beam, to the last place of the trigonometric functions. A
``torch.Generator``, or an integer seed for one, draws PyTorch's stream
instead.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

from synthpy_tpu_torch import _device
from synthpy_tpu_torch import random as jrandom
from synthpy_tpu_torch.constants import C

BEAM_TYPES = ("circular", "square", "rectangular", "linear", "even",
              "rect_trackers")


def _assemble(pos_a, pos_b, chi, phi, ne_extent: float,
              probing_direction: str, dtype) -> torch.Tensor:
    """Place transverse coordinates and velocity angles into the
    9-vector layout; the beam starts on the -extent face of the probing
    axis and travels +."""
    Np = pos_a.shape[0]
    v_par = C * torch.cos(chi)
    v_p1 = C * torch.sin(chi) * torch.cos(phi)
    v_p2 = C * torch.sin(chi) * torch.sin(phi)
    start = torch.full((Np,), -ne_extent, dtype=dtype, device=pos_a.device)
    if probing_direction == "x":
        pos, vel = (start, pos_a, pos_b), (v_par, v_p1, v_p2)
    elif probing_direction == "y":
        pos, vel = (pos_a, start, pos_b), (v_p1, v_par, v_p2)
    else:
        pos, vel = (pos_a, pos_b, start), (v_p1, v_p2, v_par)
    amp = torch.ones((Np,), dtype=dtype, device=pos_a.device)
    zero = torch.zeros((Np,), dtype=dtype, device=pos_a.device)
    return torch.stack([*(t.to(dtype) for t in (*pos, *vel)), amp, zero,
                        zero])


class _Draws:
    """Uniform and normal draws of the five streams of a beam: from a key,
    ``split(key, 5)`` as in the JAX package (position 1, position 2, phi,
    chi, trackers); from a torch.Generator, one shared stream."""

    def __init__(self, source, dev):
        self.dev = dev
        if isinstance(source, torch.Generator):
            self.gen, self.keys = source, None
        else:
            self.gen, self.keys = None, jrandom.split(source, 5)

    def uniform(self, stream: int, n: int) -> torch.Tensor:
        if self.keys is not None:
            return jrandom.uniform(self.keys[stream], (n,), device=self.dev)
        return torch.rand((n,), generator=self.gen,
                          device=self.gen.device).to(self.dev)

    def normal(self, stream: int, n: int) -> torch.Tensor:
        if self.keys is not None:
            return jrandom.normal(self.keys[stream], (n,), device=self.dev)
        return torch.randn((n,), generator=self.gen,
                           device=self.gen.device).to(self.dev)

    def choice(self, n: int, k: int) -> torch.Tensor:
        """k of range(n) without replacement."""
        if self.keys is not None:
            return jrandom.choice(self.keys[4], n, (k,), device="cpu")
        return torch.randperm(n, generator=self.gen,
                              device=self.gen.device)[:k].cpu()


POS1, POS2, PHI, CHI = 0, 1, 2, 3


def init_beam(
    key,
    Np: int,
    beam_size: Union[float, Tuple[float, float]],
    divergence: float,
    ne_extent: float,
    beam_type: str = "circular",
    probing_direction: str = "z",
    n_trackers: int = 0,
    tracker_region: float = 1e-3,
    dtype=torch.float32,
    device="cuda",
):
    """Initialise a (9, Np) ray bundle on ``device``.

    ``key``: a key (JAX's stream, the JAX package's first argument), a
    ``torch.Generator``, or an integer seed (a new generator on ``device``
    is then made).
    ``beam_size`` is the radius or half-width [m], an (a, b) pair for
    'rectangular' and 'rect_trackers'; ``divergence`` the 1-sigma polar
    angle [rad]; rays start at ``-ne_extent`` on the probing axis. 'even'
    lays out concentric rings and may change Np. 'rect_trackers' marks
    ``n_trackers`` rays inside the central +-``tracker_region`` square
    (pol = 1), chosen without replacement, and returns (s0, their
    indices).
    """
    if beam_type not in BEAM_TYPES:
        raise ValueError(
            f"beam_type {beam_type!r} unrecognised; use one of {BEAM_TYPES}")
    dev = _device.resolve(device)
    generator = key
    if isinstance(key, int):
        generator = torch.Generator(device=dev)
        generator.manual_seed(key)
    draws = _Draws(generator, dev)
    phi = 2 * math.pi * draws.uniform(PHI, Np)
    chi = divergence * draws.normal(CHI, Np)
    if beam_type == "circular":
        t = 2 * math.pi * draws.uniform(POS1, Np)
        r = beam_size * torch.sqrt(draws.uniform(POS2, Np))
        a, b = r * torch.cos(t), r * torch.sin(t)
    elif beam_type == "square":
        a = beam_size * (2 * draws.uniform(POS1, Np) - 1.0)
        b = beam_size * (2 * draws.uniform(POS2, Np) - 1.0)
    elif beam_type in ("rectangular", "rect_trackers"):
        s1, s2 = beam_size
        a = s1 * (2 * draws.uniform(POS1, Np) - 1.0)
        b = s2 * (2 * draws.uniform(POS2, Np) - 1.0)
    elif beam_type == "linear":
        # along a line in the x-z plane, probing along z
        a = beam_size * (2 * draws.uniform(POS1, Np) - 1.0)
        b = torch.zeros((Np,), device=dev)
        phi = torch.zeros((Np,), device=dev)
        probing_direction = "z"
    else:  # "even": centre point + rings of 6*i points
        n_circles = max(int((-1 + np.sqrt(1 + 8 * (Np // 6))) / 2), 1)
        Np = 3 * (n_circles + 1) * n_circles + 1
        u, t = [0.0], [0.0]
        for i in range(1, n_circles + 1):
            for j in range(i * 6):
                u.append(i / n_circles)
                t.append(j * 2 * np.pi / (i * 6))
        u = torch.tensor(u, dtype=torch.float32, device=dev)
        t = torch.tensor(t, dtype=torch.float32, device=dev)
        a, b = beam_size * u * torch.cos(t), beam_size * u * torch.sin(t)
        phi = 2 * math.pi * draws.uniform(PHI, Np)
        chi = divergence * draws.normal(CHI, Np)
    s0 = _assemble(a.to(dtype), b.to(dtype), chi, phi, ne_extent,
                   probing_direction, dtype)
    if beam_type != "rect_trackers":
        return s0
    in_region = ((a.abs() <= tracker_region)
                 & (b.abs() <= tracker_region)).cpu()
    region_idx = torch.nonzero(in_region).reshape(-1)
    if region_idx.numel() < n_trackers:
        raise ValueError("Not enough rays in the tracker region: "
                         f"{region_idx.numel()} < {n_trackers}")
    tracker_indices = region_idx[draws.choice(region_idx.numel(),
                                              n_trackers)].to(dev)
    s0[8, tracker_indices] = 1.0
    return s0, tracker_indices
