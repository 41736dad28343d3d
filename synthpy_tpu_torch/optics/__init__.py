"""Optical benches (PyTorch port of ``synthpy_tpu.optics``): the ray
transfer primitives, the composed benches (coherent ones included), the
diagnostic classes and X-ray radiography (``xray``)."""

from synthpy_tpu_torch.optics.diagnostics import (  # noqa: F401
    Diagnostic,
    Interferometry,
    Polarimetry,
    Refractometry,
    Schlieren,
    Shadowgraphy,
)
from synthpy_tpu_torch.optics import compose, rtm, xray  # noqa: F401
