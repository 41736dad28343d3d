"""K3: the detector — exit state to image in one pass.

``detect`` launches the CUDA kernel of ``csrc/detector.cu`` on CUDA tensors
and runs ``detect_plain`` on CPU tensors. The plain version is the port's
own chain of public functions, ``reassemble_state`` ->
``ray_to_Jonesvector`` -> ``m_to_mm`` -> ``apply_stages`` ->
``histogram2d``, so the kernel is held to exactly what the pipeline would
compute step by step.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel
from synthpy_tpu_torch.ops.histogram import bin_params, f32, histogram2d
from synthpy_tpu_torch.optics.compose import apply_stages
from synthpy_tpu_torch.optics.rtm import m_to_mm
from synthpy_tpu_torch.tracer.propagator import ray_to_Jonesvector
from synthpy_tpu_torch.tracer.zscan import reassemble_state

KERNEL = Kernel("detector.cu", {
    "detect_image": [P, P, P, L, I, F, F, P, I, I, I, F, F, F, F, F, F, P,
                     P],
}, flags=["--fmad=false"])

_KINDS = {"matrix": 0, "aperture": 1, "stop": 2, "rect": 3, "knife": 4}
MAX_OPS = 16  # stages the kernel takes as a parameter (detector.cu)


def stage_table(stages: Sequence[Tuple]) -> np.ndarray:
    """(n_ops, 17) float32 rows [kind, 16 parameters] of a composed stage
    list, with thresholds squared as ``optics.rtm`` compares them."""
    rows = np.zeros((len(stages), 17), np.float32)
    for i, st in enumerate(stages):
        kind = st[0]
        if kind not in _KINDS:
            raise NotImplementedError(
                f"stage {kind!r} is not supported by the detector kernel")
        rows[i, 0] = _KINDS[kind]
        if kind == "matrix":
            rows[i, 1:] = np.asarray(st[1], np.float64).reshape(16)
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
    H, _, _ = histogram2d(r[0], r[2], bins, range_, weights=weights)
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
    # the stage table goes to the kernel by value, from host memory
    ops = stage_table(stages)
    if ops.shape[0] > MAX_OPS:
        raise ValueError(f"{ops.shape[0]} composed stages; the detector "
                         f"kernel takes at most {MAX_OPS}")
    H = torch.zeros((ny, nx), dtype=torch.float32, device=dev)
    KERNEL.launch(
        "detect_image", dev, uf.data_ptr(),
        None if weights is None else weights.data_ptr(), H.data_ptr(),
        uf.shape[0], int(probing_direction == "y"),
        0.0 if p_ray is not None else f32(p_end), f32(probing_depth),
        ops.ctypes.data, ops.shape[0], nx, ny, *bx, *by,
        None if p_ray is None else p_ray.data_ptr())
    return H
