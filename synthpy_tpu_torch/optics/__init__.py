"""Optical benches (PyTorch port of ``synthpy_tpu.optics``: the ray
transfer primitives and the composed benches, coherent ones included; the
``diagnostics`` classes are still to port)."""

from synthpy_tpu_torch.optics import compose, rtm  # noqa: F401
