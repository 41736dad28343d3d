"""Array operations (PyTorch port of ``synthpy_tpu.ops``, main-path subset)."""

from synthpy_tpu_torch.ops.histogram import histogram2d  # noqa: F401
