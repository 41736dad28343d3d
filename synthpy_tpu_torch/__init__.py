"""synthpy_tpu_torch — the PyTorch / CUDA port of synthpy_tpu for one H100.

The port runs the segmented z-scan shadowgram path:

    fields.ScalarDomain(...).test_lens(...)
    -> tracer.zscan.build_segment_pack_device(...)   (kernel K2)
    -> tracer.beam.init_beam(...)
    -> pipeline.run(solver="zscan_seg", ...)         (kernels K1 and K3)

Every entry point takes ``device=`` (default ``"cuda"``) or follows the
device of the tensors it is given. Without a card, pass ``device="cpu"``:
each kernel wrapper then runs its plain PyTorch version. The CUDA kernels
live in ``kernels/csrc`` and are compiled with ``nvcc`` at first use.

Submodules are imported lazily (PEP 562), as in the JAX package.
"""

import importlib

__version__ = "0.1.0"

_SUBMODULES = (
    "constants",
    "convert",
    "fields",
    "kernels",
    "ops",
    "optics",
    "pipeline",
    "tracer",
)


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"synthpy_tpu_torch.{name}")
    raise AttributeError(
        f"module 'synthpy_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
