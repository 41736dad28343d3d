"""K3's bare-ray entry points: binning (N,) ray positions into an image.

``bin_image`` (a weighted numpy-rule 2-D histogram) and ``bin_field``
(per-pixel sums of the rays' Jones fields in ``complex_histogram``'s
layout) launch ``bin_image`` / ``bin_field`` of ``csrc/detector.cu``, which
share the detector's binning rules and atomics. They serve
``ops.histogram.histogram2d`` and ``ops.histogram.complex_histogram`` for
CUDA tensors, the diagnostic classes' detectors; the bodies of those two
functions (``histogram2d_plain``, ``complex_histogram_plain``) are their
plain versions, taken for CPU tensors only. Each entry point is its own
``Kernel`` object, so its launches count apart.

``detector.cu`` picks the form of each call itself: unweighted
``bin_image`` holds its counts in shared memory across a thread-block
cluster where the image fits one (the cluster form), and every other call
adds into the image in device memory (the one-thread form). ``plan``
reports its choice (``k3_plan``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from synthpy_tpu_torch.kernels._build import F, I, L, P, Kernel, refuse_grad

BIN_KERNEL = Kernel("detector.cu", {
    "bin_image": [P, P, P, P, L, I, I, F, F, F, F, F, F, P],
}, flags=["--fmad=false"], helpers={"k3_plan": [I, I, I, I, I, L, P]})
BIN_FIELD_KERNEL = Kernel("detector.cu", {
    "bin_field": [P, P, P, P, P, L, I, I, F, F, F, F, I, P],
}, flags=["--fmad=false"])


# detector.cu's entry points, as k3_plan names them
ENTRIES = {"bin_image": 0, "bin_field": 1, "detect_field": 2}


class Plan(NamedTuple):
    """How ``detector.cu`` runs one call (``k3_plan``)."""
    cluster: int    # blocks a cluster; 0: the one-thread form
    clusters: int   # the grid's clusters
    rows: int       # image rows a block holds
    smem: int       # a block's dynamic shared bytes
    active: int     # clusters the card holds at once

    @property
    def form(self) -> str:
        return "cluster" if self.cluster else "one_thread"


def plan(entry: str, kind: int, bins: Tuple[int, int], N: int,
         dev: torch.device) -> Plan:
    """``detector.cu``'s plan of a call of ``entry`` ("bin_image": kind 0
    unweighted, 1 weighted; "bin_field" or "detect_field": kind = n_ch, 2
    or 4) for N rays onto ``bins`` = (nx, ny) pixels on card ``dev``."""
    if entry not in ENTRIES:
        raise ValueError(f"no K3 entry point {entry!r}")
    dev = torch.device(dev)
    index = dev.index
    if index is None:
        index = torch.cuda.current_device() if dev.type == "cuda" else 0
    out = (ctypes.c_longlong * len(Plan._fields))()
    rc = BIN_KERNEL.load().k3_plan(index, ENTRIES[entry], int(kind),
                                   int(bins[0]), int(bins[1]), int(N),
                                   ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"k3_plan refused {entry} (kind {kind}) of {N} "
                           f"rays onto {tuple(bins)} pixels (cudaError "
                           f"{rc})")
    return Plan(*(int(v) for v in out))


def _rays(*ts: torch.Tensor, dtype=torch.float32):
    dev, n = ts[0].device, ts[0].shape
    for t in ts:
        if t.device != dev or t.dtype != dtype or t.shape != n or t.dim() != 1:
            raise ValueError(f"the rays must be (N,) {dtype} tensors on one "
                             "device")
    return [t.contiguous() for t in ts]


def bin_image(x: torch.Tensor, y: torch.Tensor,
              weights: Optional[torch.Tensor], nx: int, ny: int,
              bx: Tuple[float, float, float],
              by: Tuple[float, float, float]) -> torch.Tensor:
    """(ny, nx) f32 image of (N,) f32 positions on the card: ray i adds
    ``weights[i]`` (or 1) to its bin; ``bx``/``by`` = (lo, hi, bins per
    unit) in float32, as ``ops.histogram.bin_params`` gives them."""
    refuse_grad("binning.bin_image (K3)", x, y, weights)
    if weights is None:
        x, y = _rays(x, y)
    else:
        x, y, weights = _rays(x, y, weights)
    H = torch.zeros((ny, nx), dtype=torch.float32, device=x.device)
    BIN_KERNEL.launch("bin_image", x.device, x.data_ptr(), y.data_ptr(),
                      None if weights is None else weights.data_ptr(),
                      H.data_ptr(), x.shape[0], nx, ny, *bx, *by)
    return H


def bin_field(x: torch.Tensor, y: torch.Tensor, Ex: torch.Tensor,
              Ey: torch.Tensor, npx: int, npy: int,
              px: Tuple[float, float], py: Tuple[float, float],
              n_ch: int) -> torch.Tensor:
    """(npy, npx, n_ch) f32 field sums of (N,) f32 positions and complex64
    fields on the card; ``px``/``py`` = (L / 2, L / n) in float32; n_ch 2
    sums (Re Ex, Re Ey), 4 the real and imaginary parts of both."""
    refuse_grad("binning.bin_field (K3)", x, y, Ex, Ey)
    x, y = _rays(x, y)
    Ex, Ey = _rays(Ex, Ey, dtype=torch.complex64)
    if Ex.shape != x.shape or Ex.device != x.device:
        raise ValueError("the fields must be (N,) like the rays, on their "
                         "device")
    H = torch.zeros((npy, npx, n_ch), dtype=torch.float32, device=x.device)
    BIN_FIELD_KERNEL.launch("bin_field", x.device, x.data_ptr(),
                            y.data_ptr(), Ex.data_ptr(), Ey.data_ptr(),
                            H.data_ptr(), x.shape[0], npx, npy, *px, *py,
                            n_ch)
    return H
