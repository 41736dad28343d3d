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
