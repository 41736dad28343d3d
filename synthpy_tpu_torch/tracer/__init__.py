"""Ray tracing (PyTorch port of ``synthpy_tpu.tracer``): beam set-up, the
time-domain tracer, the plain and segmented z-scan marches, the pack-free
analytic march and the adaptive tracer; the segment-streamed march of
host packs; proton radiography (``particles``)."""

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
    build_segment_pack_streaming,
    decimate_segment_pack,
    make_device_segment_cache,
    make_segment_pack,
    make_zscan_pack,
    quantize_segment_pack,
    solve_zscan,
    solve_zscan_segments,
    solve_zscan_segments_streamed,
)
from synthpy_tpu_torch.tracer.adaptive import solve_adaptive  # noqa: F401
from synthpy_tpu_torch.tracer.analytic import (  # noqa: F401
    solve_zscan_analytic,
)
from synthpy_tpu_torch.tracer import particles  # noqa: F401
