"""Optical benches (PyTorch port of ``synthpy_tpu.optics``, incoherent
subset)."""

from synthpy_tpu_torch.optics import compose, rtm  # noqa: F401
