"""Ray-bundle initialisation (PyTorch port of ``synthpy_tpu.tracer.beam``).

Builds the (9, Np) initial ray state s0 = (x, y, z, vx, vy, vz, amp,
phase, pol) for the 'circular', 'square', 'rectangular', 'linear' and
'even' beams. Random draws come from an explicit ``torch.Generator``: the
same seed gives other numbers than ``jax.random``, so parity tests hand a
JAX-drawn ``s0`` to the port through ``synthpy_tpu_torch.convert``.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np
import torch

from synthpy_tpu_torch import _device
from synthpy_tpu_torch.constants import C

BEAM_TYPES = ("circular", "square", "rectangular", "linear", "even")


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


def init_beam(
    generator: Union[torch.Generator, int],
    Np: int,
    beam_size: Union[float, Tuple[float, float]],
    divergence: float,
    ne_extent: float,
    beam_type: str = "circular",
    probing_direction: str = "z",
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """Initialise a (9, Np) ray bundle on ``device``.

    ``generator`` is a ``torch.Generator`` or an integer seed (a new
    generator on ``device`` is then made). ``beam_size`` is the radius or
    half-width [m], an (a, b) pair for 'rectangular'; ``divergence`` the
    1-sigma polar angle [rad]; rays start at ``-ne_extent`` on the probing
    axis. 'even' lays out concentric rings and may change Np.
    """
    if beam_type == "rect_trackers":
        raise NotImplementedError(
            "beam_type='rect_trackers' is not ported yet (ROADMAP A.3)")
    if beam_type not in BEAM_TYPES:
        raise ValueError(
            f"beam_type {beam_type!r} unrecognised; use one of {BEAM_TYPES}")
    dev = _device.resolve(device)
    if isinstance(generator, int):
        seed = generator
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    g_dev = generator.device

    def uniform(n):
        return torch.rand((n,), generator=generator, device=g_dev).to(dev)

    def normal(n):
        return torch.randn((n,), generator=generator, device=g_dev).to(dev)

    phi = 2 * math.pi * uniform(Np)
    chi = divergence * normal(Np)
    if beam_type == "circular":
        t = 2 * math.pi * uniform(Np)
        r = beam_size * torch.sqrt(uniform(Np))
        a, b = r * torch.cos(t), r * torch.sin(t)
    elif beam_type == "square":
        a = beam_size * (2 * uniform(Np) - 1.0)
        b = beam_size * (2 * uniform(Np) - 1.0)
    elif beam_type == "rectangular":
        s1, s2 = beam_size
        a = s1 * (2 * uniform(Np) - 1.0)
        b = s2 * (2 * uniform(Np) - 1.0)
    elif beam_type == "linear":
        # along a line in the x-z plane, probing along z
        a = beam_size * (2 * uniform(Np) - 1.0)
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
        phi = 2 * math.pi * uniform(Np)
        chi = divergence * normal(Np)
    return _assemble(a.to(dtype), b.to(dtype), chi, phi, ne_extent,
                     probing_direction, dtype)
