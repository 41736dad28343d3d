"""Array operations (PyTorch port of ``synthpy_tpu.ops``: histograms and
grid interpolation)."""

from synthpy_tpu_torch.ops.histogram import histogram2d  # noqa: F401
from synthpy_tpu_torch.ops.interp import (  # noqa: F401
    regular_grid_interpolator,
    trilinear,
    trilinear_nonuniform,
)
