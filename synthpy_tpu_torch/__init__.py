"""synthpy_tpu_torch — the PyTorch / CUDA port of synthpy_tpu for one H100.

The port runs the image pipeline on four tracers:

    fields.ScalarDomain(...).test_lens(...)
    -> tracer.beam.init_beam(...)
    -> pipeline.run(solver="zscan", ...)       plain slab march (K4), default
       pipeline.run(solver="zscan_seg", ...)   segment pack (K2) + march (K1)
       pipeline.run(solver="time", ...)        time-domain RK4 (K5)
    -> the detector (K3)

and the adaptive validation tracer ``solve_adaptive`` (K6). ``solve``,
``solve_zscan`` and ``solve_adaptive`` are exported here, as in
``synthpy_tpu.tracer``.

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


# tracer entry points exported at the top level: name -> module
_EXPORTS = {"solve": "tracer", "solve_zscan": "tracer",
            "solve_adaptive": "tracer"}


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"synthpy_tpu_torch.{name}")
    if name in _EXPORTS:
        module = importlib.import_module(
            f"synthpy_tpu_torch.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(
        f"module 'synthpy_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES) + list(_EXPORTS))
