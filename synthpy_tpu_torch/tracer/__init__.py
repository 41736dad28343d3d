"""Ray tracing (PyTorch port of ``synthpy_tpu.tracer``): beam set-up, the
time-domain tracer, the plain and segmented z-scan marches and the
adaptive tracer."""

from synthpy_tpu_torch.tracer.beam import init_beam  # noqa: F401
from synthpy_tpu_torch.tracer.propagator import (  # noqa: F401
    TraceResult,
    back_propagate,
    default_n_steps,
    ray_to_Jonesvector,
    solve,
    trace_rk4,
)
from synthpy_tpu_torch.tracer.zscan import (  # noqa: F401
    decimate_segment_pack,
    make_segment_pack,
    make_zscan_pack,
    quantize_segment_pack,
    solve_zscan,
    solve_zscan_segments,
)
from synthpy_tpu_torch.tracer.adaptive import solve_adaptive  # noqa: F401
