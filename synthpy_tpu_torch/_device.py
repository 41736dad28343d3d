"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA on a host without one.

    Entry points default to ``"cuda"`` and never carry on silently on the
    CPU: the host path (the kernels' plain versions) runs only when the
    caller asks for it with ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev


def torch_dtype(value) -> torch.dtype:
    """A dtype argument as a ``torch.dtype``: a torch dtype, a numpy dtype
    or scalar type (JAX's ``jnp.float32`` and ``jnp.bfloat16`` among
    them), or a name such as ``"bfloat16"``."""
    if isinstance(value, torch.dtype):
        return value
    if isinstance(value, str):
        name = value
    else:
        import numpy as np

        name = np.dtype(value).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"{value!r} is not a dtype torch knows")
    return dt
