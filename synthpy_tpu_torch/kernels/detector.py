"""K3: the detector — exit state to image in one pass.

``detect`` (incoherent benches) and ``detect_field`` (coherent benches)
launch the two entry points of ``csrc/detector.cu`` on CUDA tensors and run
``detect_plain`` / ``detect_field_plain`` on CPU tensors. The plain versions
are the port's own chains of public functions, ``reassemble_state`` ->
``ray_to_Jonesvector`` -> ``m_to_mm`` -> ``apply_stages`` ->
``histogram2d_plain``, and for the field
``ray_to_Jonesvector(return_E=True)`` -> ``m_to_mm`` ->
``interfere_ref_beam`` -> ``apply_stages(E=)`` ->
``complex_histogram_plain(return_acc=True)``, so each kernel is held to
exactly what the pipeline would compute step by step. A stage table of any
length runs on the card: up to ``MAX_OPS`` stages go by value, a longer
table as a device copy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel, refuse_grad
from synthpy_tpu_torch.ops.histogram import (bin_params,
                                             complex_histogram_plain, f32,
                                             histogram2d_plain)
from synthpy_tpu_torch.optics.compose import (apply_stages,
                                              interfere_ref_beam, ref_beam)
from synthpy_tpu_torch.optics.rtm import m_to_mm
from synthpy_tpu_torch.tracer.propagator import ray_to_Jonesvector
from synthpy_tpu_torch.tracer.zscan import reassemble_state

KERNEL = Kernel("detector.cu", {
    "detect_image": [P, P, P, L, I, F, F, P, P, I, I, I, F, F, F, F, F, F, P,
                     P],
}, flags=["--fmad=false"])
# the coherent entry point of the same source, with its own launch count
# (the bare-ray entry points are in kernels.binning)
FIELD_KERNEL = Kernel("detector.cu", {
    "detect_field": [P, P, L, I, F, F, P, P, I, F, I, I, F, F, F, F, I, I, F,
                     F, F, P, P],
}, flags=["--fmad=false"])

_KINDS = {"matrix": 0, "aperture": 1, "stop": 2, "rect": 3, "knife": 4,
          "phase": 5, "mark": 6}
# stages the kernel takes by value (detector.cu); a longer table goes to
# the card as a device copy
MAX_OPS = 16
CONVENTIONS = {"legacy": 2, "intensity": 4}   # accumulator channels


def stage_table(stages: Sequence[Tuple],
                coherent: bool = False) -> np.ndarray:
    """(n_ops, 17) float32 rows [kind, 16 parameters] of a composed stage
    list, with thresholds squared as ``optics.rtm`` compares them; the
    ("phase",) and ("mark",) checkpoints only for the coherent form."""
    rows = np.zeros((len(stages), 17), np.float32)
    for i, st in enumerate(stages):
        kind = st[0]
        if kind not in _KINDS:
            raise NotImplementedError(
                f"stage {kind!r} is not supported by the detector kernel")
        if kind in ("phase", "mark") and not coherent:
            raise ValueError(f"a ({kind!r},) stage needs the coherent "
                             "detector (detect_field)")
        rows[i, 0] = _KINDS[kind]
        if kind == "matrix":
            rows[i, 1:] = np.asarray(st[1], np.float64).reshape(16)
        elif kind in ("phase", "mark"):
            continue
        elif kind in ("aperture", "stop"):
            rows[i, 1] = st[1] ** 2
        elif kind == "rect":
            rows[i, 1:3] = (st[1] ** 2, st[2] ** 2)
        else:
            _, offset, axis, direction = st
            if direction == 0:
                raise ValueError("direction must be > 0 or < 0")
            rows[i, 1:4] = ({"x": 0, "y": 2}[axis],
                            1.0 if direction > 0 else -1.0, offset)
    return rows


def _device_table(ops: np.ndarray, dev) -> Optional[torch.Tensor]:
    """The device copy of a stage table longer than ``MAX_OPS`` (None for
    a shorter one, which the kernel takes by value)."""
    return torch.from_numpy(ops).to(dev) if ops.shape[0] > MAX_OPS else None


def detect_plain(uf: torch.Tensor, p_end, probing_depth: float,
                 probing_direction: str, stages: Sequence[Tuple],
                 bins: Tuple[int, int],
                 range_: Tuple[Tuple[float, float], Tuple[float, float]],
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the detector: (ny, nx) image of (N, 8) exit states
    at the probing coordinate ``p_end`` (a float, or an (N,) tensor)."""
    sf = reassemble_state(uf, p_end if isinstance(p_end, torch.Tensor)
                          else f32(p_end), probing_direction)
    rf, _ = ray_to_Jonesvector(sf, f32(probing_depth),
                               probing_direction=probing_direction)
    r = apply_stages(m_to_mm(rf), stages)
    H, _, _ = histogram2d_plain(r[0], r[2], bins, range_, weights=weights)
    return H


def detect(uf: torch.Tensor, p_end, probing_depth: float,
           probing_direction: str, stages: Sequence[Tuple],
           bins: Tuple[int, int],
           range_: Tuple[Tuple[float, float], Tuple[float, float]],
           weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(ny, nx) f32 image of (N, 8) permuted exit states.

    Rays are back-projected to ``probing_depth`` from the exit plane
    ``p_end``, or from each ray's own probing coordinate when ``p_end`` is
    an (N,) tensor (the time tracer's exit states), pushed through the
    composed ``stages`` (in mm) and binned into ``bins = (nx, ny)`` over
    ``range_``; ``weights`` is an optional (N,) per-ray weight.
    """
    if uf.device.type == "cpu":
        return detect_plain(uf, p_end, probing_depth, probing_direction,
                            stages, bins, range_, weights)
    refuse_grad("detector.detect (K3)", uf, p_end, weights)
    dev = uf.device
    if (uf.dtype != torch.float32 or uf.dim() != 2 or uf.shape[1] != 8
            or not uf.is_contiguous()):
        raise ValueError("uf must be a contiguous (N, 8) float32 tensor")
    if weights is not None and (
            weights.device != dev or weights.dtype != torch.float32
            or tuple(weights.shape) != (uf.shape[0],)
            or not weights.is_contiguous()):
        raise ValueError("weights must be a contiguous (N,) float32 tensor "
                         "on the rays' device")
    p_ray = p_end if isinstance(p_end, torch.Tensor) else None
    if p_ray is not None and (
            p_ray.device != dev or p_ray.dtype != torch.float32
            or tuple(p_ray.shape) != (uf.shape[0],)
            or not p_ray.is_contiguous()):
        raise ValueError("a per-ray p_end must be a contiguous (N,) float32 "
                         "tensor on the rays' device")
    # the kernel reads states as 16-byte vectors: a fresh allocation is
    # aligned
    if uf.data_ptr() % 16:
        uf = uf.clone()
    nx, ny = bins
    (xlo, xhi), (ylo, yhi) = range_
    bx, by = bin_params(xlo, xhi, nx), bin_params(ylo, yhi, ny)
    ops = stage_table(stages)
    dops = _device_table(ops, dev)
    H = torch.zeros((ny, nx), dtype=torch.float32, device=dev)
    KERNEL.launch(
        "detect_image", dev, uf.data_ptr(),
        None if weights is None else weights.data_ptr(), H.data_ptr(),
        uf.shape[0], int(probing_direction == "y"),
        0.0 if p_ray is not None else f32(p_end), f32(probing_depth),
        ops.ctypes.data, None if dops is None else dops.data_ptr(),
        ops.shape[0], nx, ny, *bx, *by,
        None if p_ray is None else p_ray.data_ptr())
    return H


def detect_field_plain(uf: torch.Tensor, p_end, probing_depth: float,
                       probing_direction: str, stages: Sequence[Tuple],
                       bins: Tuple[int, int], Lx: float, Ly: float,
                       wavelength: float, convention: str = "legacy",
                       ref: Optional[Tuple[float, float]] = None
                       ) -> torch.Tensor:
    """Plain version of the coherent detector: the (ny, nx, C) field sums
    of (N, 8) exit states (see ``detect_field``)."""
    sf = reassemble_state(uf, p_end if isinstance(p_end, torch.Tensor)
                          else f32(p_end), probing_direction)
    rf, Jf = ray_to_Jonesvector(sf, f32(probing_depth),
                                probing_direction=probing_direction,
                                return_E=True)
    r = m_to_mm(rf)
    if ref is not None:
        Jf = interfere_ref_beam(r, Jf, *ref)
    r, E = apply_stages(r, stages, E=Jf, wavelength=wavelength)
    return complex_histogram_plain(r[0], r[2], E[0], E[1], bins[0] + 1,
                                   bins[1] + 1, Lx, Ly,
                                   convention=convention, return_acc=True)


def detect_field(uf: torch.Tensor, p_end, probing_depth: float,
                 probing_direction: str, stages: Sequence[Tuple],
                 bins: Tuple[int, int], Lx: float, Ly: float,
                 wavelength: float, convention: str = "legacy",
                 ref: Optional[Tuple[float, float]] = None) -> torch.Tensor:
    """(ny, nx, C) f32 field sums of (N, 8) permuted exit states: the
    coherent detector.

    Rays are back-projected as by ``detect``, get the Jones vector of
    their amp, phase and pol, plus the reference beam ``ref`` = (n_fringes,
    deg) for the interferometer, go through ``stages`` (with ("phase",)
    checkpoints at ``wavelength`` [m]) and add their field to ``bins`` =
    (nx, ny) pixels over [-Lx/2, Lx/2) x [-Ly/2, Ly/2) in
    ``complex_histogram``'s layout; C = 2 ("legacy") or 4 ("intensity").
    Finalize with ``ops.histogram.finalize_complex``.
    """
    if convention not in CONVENTIONS:
        raise ValueError(f"unknown convention {convention!r}; "
                         "expected 'legacy' or 'intensity'")
    if uf.device.type == "cpu":
        return detect_field_plain(uf, p_end, probing_depth,
                                  probing_direction, stages, bins, Lx, Ly,
                                  wavelength, convention, ref)
    refuse_grad("detector.detect_field (K3)", uf, p_end)
    dev = uf.device
    if (uf.dtype != torch.float32 or uf.dim() != 2 or uf.shape[1] != 8
            or not uf.is_contiguous()):
        raise ValueError("uf must be a contiguous (N, 8) float32 tensor")
    p_ray = p_end if isinstance(p_end, torch.Tensor) else None
    if p_ray is not None and (
            p_ray.device != dev or p_ray.dtype != torch.float32
            or tuple(p_ray.shape) != (uf.shape[0],)
            or not p_ray.is_contiguous()):
        raise ValueError("a per-ray p_end must be a contiguous (N,) float32 "
                         "tensor on the rays' device")
    if uf.data_ptr() % 16:
        uf = uf.clone()
    ops = stage_table(stages, coherent=True)
    dops = _device_table(ops, dev)
    nx, ny = bins
    n_ch = CONVENTIONS[convention]
    fr, cr, sr = ref_beam(*ref) if ref is not None else (0.0, 0.0, 0.0)
    H = torch.zeros((ny, nx, n_ch), dtype=torch.float32, device=dev)
    FIELD_KERNEL.launch(
        "detect_field", dev, uf.data_ptr(), H.data_ptr(), uf.shape[0],
        int(probing_direction == "y"),
        0.0 if p_ray is not None else f32(p_end), f32(probing_depth),
        ops.ctypes.data, None if dops is None else dops.data_ptr(),
        ops.shape[0], f32(2.0 * np.pi / wavelength), nx, ny,
        f32(Lx / 2.0), f32(Lx / nx), f32(Ly / 2.0), f32(Ly / ny), n_ch,
        int(ref is not None), fr, cr, sr,
        None if p_ray is None else p_ray.data_ptr())
    return H
