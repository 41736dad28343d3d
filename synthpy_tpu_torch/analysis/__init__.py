"""Post-processing (PyTorch port of the analysis half of
``synthpy_tpu.analysis``): fringe analysis and the Abel transform pair.
``imaging`` and ``memprof`` are still to port (ROADMAP A.15)."""

from synthpy_tpu_torch.analysis.fringes import (  # noqa: F401
    carrier_frequency,
    extract_phase,
    phase_difference,
)
from synthpy_tpu_torch.analysis.abel import (  # noqa: F401
    abel_forward,
    abel_invert,
    invert_phase_map,
    phase_to_line_density,
)
