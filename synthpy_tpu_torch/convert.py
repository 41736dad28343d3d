"""Carry JAX-side state across to the port.

Functions here take what ``numpy.asarray`` makes of the JAX package's
arrays (no JAX import is needed) and return port objects on ``device``:
a ``TracePack``, ``ZScanPack`` or ``SegmentPack``, a ``ScalarDomain`` with
its fields, or a tensor (a JAX-drawn (9, N) ray bundle, for one).
bfloat16 arrives from ``np.asarray`` as ``ml_dtypes.bfloat16``, which
``torch.from_numpy`` rejects; it is reinterpreted as 16-bit integers and
viewed as ``torch.bfloat16``, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from synthpy_tpu_torch import _device
from synthpy_tpu_torch.fields.domain import ScalarDomain, TracePack
from synthpy_tpu_torch.tracer.zscan import SegmentPack, ZScanPack


def tensor(a, device="cuda") -> torch.Tensor:
    """An array (numpy, or anything ``np.asarray`` takes) as a tensor on
    ``device``, bfloat16 included, with its bits unchanged."""
    dev = _device.resolve(device)
    arr = np.array(a)   # a writable copy: JAX arrays export read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def trace_pack(jpack, device="cuda") -> TracePack:
    """A JAX ``TracePack`` as a port ``TracePack``: the channel grid on
    ``device``, the geometry as host numpy arrays."""
    return TracePack(tensor(jpack.channels, device),
                     np.array(jpack.origin), np.array(jpack.inv_spacing),
                     float(jpack.omega))


def zscan_pack(jzpack, device="cuda") -> ZScanPack:
    """A JAX ``ZScanPack`` as a port ``ZScanPack`` (same fields)."""
    return ZScanPack(tensor(jzpack.planes, device),
                     tensor(jzpack.origin_ab, device),
                     tensor(jzpack.inv_spacing_ab, device),
                     float(jzpack.p0), float(jzpack.dp), float(jzpack.omega))


def segment_pack(jpack, device="cuda") -> SegmentPack:
    """A JAX ``SegmentPack`` as a port ``SegmentPack`` (same fields)."""
    scales = getattr(jpack, "scales", None)
    return SegmentPack(
        None if jpack.seg_planes is None
        else tensor(jpack.seg_planes, device),
        tensor(jpack.origin_ab, device), tensor(jpack.inv_spacing_ab, device),
        tuple(int(v) for v in jpack.shape_ab), int(jpack.K),
        int(jpack.n_slabs), float(jpack.p0), float(jpack.dp),
        float(jpack.omega), None if scales is None else tensor(scales, device),
        getattr(jpack, "qbits", None))


def domain(jdomain, device="cuda") -> ScalarDomain:
    """A JAX ``ScalarDomain`` (coordinates, ne, Te, Z, B and the physics
    switches) as a port ``ScalarDomain``."""
    d = ScalarDomain(x=np.asarray(jdomain.x), y=np.asarray(jdomain.y),
                     z=np.asarray(jdomain.z), inv_brems=jdomain.inv_brems,
                     phaseshift=jdomain.phaseshift, B_on=jdomain.B_on,
                     probing_direction=jdomain.probing_direction,
                     device=device)
    for name in ("ne", "Te", "Z", "B"):
        v = getattr(jdomain, name)
        if v is not None:
            setattr(d, name, tensor(v, device).to(d.dtype))
    return d
