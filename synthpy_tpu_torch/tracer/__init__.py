"""Ray tracing (PyTorch port of ``synthpy_tpu.tracer``, main-path subset)."""

from synthpy_tpu_torch.tracer.beam import init_beam  # noqa: F401
from synthpy_tpu_torch.tracer.propagator import (  # noqa: F401
    TraceResult,
    back_propagate,
    ray_to_Jonesvector,
)
