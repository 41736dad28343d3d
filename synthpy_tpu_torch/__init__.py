"""synthpy_tpu_torch — the PyTorch / CUDA port of synthpy_tpu for one H100.

The port runs the image pipeline on four tracers:

    fields.ScalarDomain(...).test_lens(...)
    -> tracer.beam.init_beam(...)
    -> pipeline.run(solver="zscan", ...)       plain slab march (K4), default
       pipeline.run(solver="zscan_seg", ...)   segment pack (K2) + march (K1)
       pipeline.run(solver="time", ...)        time-domain RK4 (K5)
       pipeline.run(solver="analytic", ...)    closed-form march (K7)
    -> the detector (K3; coherent benches through its field form)

and the adaptive validation tracer ``solve_adaptive`` (K6). ``solve``,
``solve_zscan``, ``solve_adaptive`` and ``solve_zscan_analytic`` are
exported here, as in ``synthpy_tpu.tracer``.

``parallel`` runs ``pipeline.run(mesh=)``'s multi-device modes on a mesh
of torch devices (which may repeat one card): ray-parallel, grid-sharded
(K17) and depth-pipelined, the grid-sharded time tracer (K18) and the
multi-process helpers on ``torch.distributed``.

``inverse.make_renderer`` builds the differentiable forward model, ne ->
image(s), for ``torch.autograd`` (the segment march's adjoint K11 and the
cloud-in-cell detector K12), with the priors of ``priors``.

From the exit rays, the diagnostic classes (``optics.Shadowgraphy``,
``Schlieren``, ``Refractometry``, ``Interferometry``, ``Polarimetry``, also
exported here) bin through K3's bare-ray entry points, and the Fresnel
hybrid deposits through K8 (``kernels.deposit``); ``ops.fresnel`` and
``ops.multislice`` propagate fields on ``torch.fft``; ``analysis`` holds
the fringe and Abel post-processing.

Every entry point takes ``device=`` (default ``"cuda"``) or follows the
device of the tensors it is given. Without a card, pass ``device="cpu"``:
each kernel wrapper then runs its plain PyTorch version. The CUDA kernels
live in ``kernels/csrc`` and are compiled with ``nvcc`` at first use.

Submodules are imported lazily (PEP 562), as in the JAX package.
"""

import importlib

__version__ = "0.1.0"

_SUBMODULES = (
    "analysis",
    "constants",
    "convert",
    "fields",
    "inverse",
    "io",
    "kernels",
    "ops",
    "optics",
    "parallel",
    "pipeline",
    "priors",
    "tracer",
)


# tracer entry points and diagnostic classes exported at the top level:
# name -> module
_EXPORTS = {"solve": "tracer", "solve_zscan": "tracer",
            "solve_adaptive": "tracer", "solve_zscan_analytic": "tracer",
            "Diagnostic": "optics", "Shadowgraphy": "optics",
            "Schlieren": "optics", "Refractometry": "optics",
            "Interferometry": "optics", "Polarimetry": "optics"}


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
