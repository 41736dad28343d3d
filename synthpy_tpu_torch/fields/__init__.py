"""Scene state (PyTorch port of ``synthpy_tpu.fields``, main-path subset)."""

from synthpy_tpu_torch.fields.domain import (  # noqa: F401
    ChannelLayout,
    ScalarDomain,
    TracePack,
    build_pack,
    layout_of,
    peak_ne_over_nc,
)
