"""Scene state and field generation (PyTorch port of
``synthpy_tpu.fields``)."""

from synthpy_tpu_torch.fields.domain import (  # noqa: F401
    ChannelLayout,
    ScalarDomain,
    TracePack,
    build_pack,
    layout_of,
    peak_ne_over_nc,
)
from synthpy_tpu_torch.fields import grf, spectrum  # noqa: F401
