"""Array operations (PyTorch port of ``synthpy_tpu.ops``: histograms and
deposits, grid interpolation, FFTs, Fresnel and multi-slice wave
propagation)."""

from synthpy_tpu_torch.ops.histogram import (  # noqa: F401
    complex_histogram,
    deposit_cic,
    histogram2d,
)
from synthpy_tpu_torch.ops.interp import (  # noqa: F401
    regular_grid_interpolator,
    trilinear,
    trilinear_nonuniform,
)
