"""Closed-form fields of the ``test_*`` constructors.

``ScalarDomain.test_*`` puts a ``ClosedForm`` under ``domain.analytic["ne"]``
(and, after ``test_B``, under ``"B"``). A ``ClosedForm`` is the torch closure
``f(x, y, z)`` of the JAX package's ``domain.analytic`` entry and, besides,
a description the analytic march's kernel (K7, ``kernels/csrc/analytic.cu``)
can read: the profile's ``kind``, its float32 constants, and its gradient
written out by hand (``grad``), so that no closure has to run on the card.

Every constant is rounded to float32 once, here, and the value and the
gradient are computed in the operation order of the kernel (the JAX
closure's order, with division by a constant taken as multiplication by its
float32 reciprocal, as XLA compiles it). ``grad`` is held to
``torch.autograd`` of ``__call__`` and to ``jax.grad`` of the JAX closure by
the tests.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

KINDS = ("null", "slab", "linear_cos", "exponential_cos", "lens", "liner",
         "bz_linear")
N_PARAMS = 7  # constants a form hands the kernel
LN10 = math.log(10.0)
TWO_PI = 2.0 * math.pi


def f32(v: float) -> float:
    """``v`` rounded to the nearest float32, as a Python float."""
    return float(np.float32(v))


class ClosedForm:
    """A closed-form field: ``form(x, y, z)`` is its value (a tuple of three
    components for ``"bz_linear"``), ``form.grad(x, y, z)`` the hand-written
    gradient (d/dx, d/dy, d/dz) of an ``ne`` profile, ``form.params`` the
    float32 constants the kernel reads."""

    def __init__(self, kind: str, **coeffs: float):
        if kind not in KINDS:
            raise ValueError(f"unknown closed form {kind!r}")
        self.kind = kind
        self.coeffs = dict(coeffs)
        self.c = _constants(kind, coeffs)

    @property
    def params(self) -> Tuple[float, ...]:
        return tuple(self.c) + (0.0,) * (N_PARAMS - len(self.c))

    def __repr__(self) -> str:
        args = ", ".join(f"{k}={v!r}" for k, v in self.coeffs.items())
        return f"ClosedForm({self.kind!r}, {args})"

    def __call__(self, x, y, z):
        c, k = self.c, self.kind
        if k == "null":
            return torch.zeros_like(x)
        if k == "slab":                       # ne_0 (1 + s x / ext)
            A, s, r = c[:3]
            return A * (1.0 + (s * x) * r)
        if k == "linear_cos":
            A, s1, rext, s2, tp, rLy = c[:6]
            X = 1.0 + (s1 * x) * rext
            Y = 1.0 + s2 * torch.cos((tp * y) * rLy)
            return (A * X) * Y
        if k == "exponential_cos":
            A, rs, tp, rLy = c[:4]
            P = torch.pow(10.0, x * rs)
            Y = 1.0 + torch.cos((tp * y) * rLy)
            return (A * P) * Y
        if k in ("lens", "liner"):
            A, rLR2 = c[:2]
            t = z if k == "liner" else y
            return A * torch.exp(-(x * x + t * t) * rLR2)
        # bz_linear: (0, 0, Bmax x / ext)
        Bm, r = c[:2]
        zero = torch.zeros_like(x)
        return zero, zero, (Bm * x) * r

    def grad(self, x, y, z):
        """(d/dx, d/dy, d/dz) of an ``ne`` profile, written out."""
        c, k = self.c, self.kind
        zero = torch.zeros_like(x)
        if k == "null":
            return zero, zero, zero
        if k == "slab":
            return torch.full_like(x, c[3]), zero, zero
        if k == "linear_cos":
            A, s1, rext, s2, tp, rLy = c[:6]
            w = (tp * y) * rLy
            X = 1.0 + (s1 * x) * rext
            Y = 1.0 + s2 * torch.cos(w)
            gx = ((Y * A) * rext) * s1
            gy = ((((A * X) * s2) * -torch.sin(w)) * rLy) * tp
            return gx, gy, zero
        if k == "exponential_cos":
            A, rs, tp, rLy, ln10 = c[:5]
            P = torch.pow(10.0, x * rs)
            w = (tp * y) * rLy
            Y = 1.0 + torch.cos(w)
            gx = ((Y * A) * (P * ln10)) * rs
            gy = ((((A * P) * -torch.sin(w)) * rLy) * tp)
            return gx, gy, zero
        if k in ("lens", "liner"):
            A, rLR2 = c[:2]
            t = z if k == "liner" else y
            gq = -((A * torch.exp(-(x * x + t * t) * rLR2)) * rLR2)
            gx, gt = gq * (2.0 * x), gq * (2.0 * t)
            return (gx, zero, gt) if k == "liner" else (gx, gt, zero)
        raise ValueError(f"{k!r} is not an ne profile")


def _constants(kind: str, p: Dict[str, float]) -> Tuple[float, ...]:
    """The float32 constants of a form, in the order the kernel reads
    them."""
    if kind == "null":
        return ()
    if kind == "slab":
        A, s, r = f32(p["ne_0"]), f32(p["s"]), f32(1.0 / p["ext"])
        return A, s, r, f32(f32(A * r) * s)     # the constant d/dx
    if kind == "linear_cos":
        return (f32(p["ne_0"]), f32(p["s1"]), f32(1.0 / p["ext"]),
                f32(p["s2"]), f32(TWO_PI), f32(1.0 / p["Ly"]))
    if kind == "exponential_cos":
        return (f32(p["ne_0"]), f32(1.0 / p["s"]), f32(TWO_PI),
                f32(1.0 / p["Ly"]), f32(LN10))
    if kind in ("lens", "liner"):
        return f32(p["ne_0"]), f32(1.0 / p["LR"] ** 2)
    return f32(p["Bmax"]), f32(1.0 / p["ext"])
