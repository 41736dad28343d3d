"""FFTs (PyTorch port of ``synthpy_tpu.ops.dft``) on ``torch.fft``.

The JAX module dispatches between XLA's FFT op and a matmul DFT, a
workaround for TPU runtimes that lack the FFT op. The port keeps the API
(``fftn``, ``ifftn``, ``fft2``, ``ifft2``, ``fftfreq``) on ``torch.fft``
(cuFFT on the card) and has no fallback. Real input is transformed as
complex64 (complex128 for float64), as ``jnp.fft`` does.
"""

from __future__ import annotations

import numpy as np
import torch


def _complex(x: torch.Tensor) -> torch.Tensor:
    if torch.is_complex(x):
        return x
    return x.to(torch.complex128 if x.dtype == torch.float64
                else torch.complex64)


def fftn(x: torch.Tensor, axes=None) -> torch.Tensor:
    dims = tuple(range(x.dim())) if axes is None else tuple(axes)
    return torch.fft.fftn(_complex(x), dim=dims)


def ifftn(x: torch.Tensor, axes=None) -> torch.Tensor:
    dims = tuple(range(x.dim())) if axes is None else tuple(axes)
    return torch.fft.ifftn(_complex(x), dim=dims)


def fft2(x: torch.Tensor) -> torch.Tensor:
    return fftn(x, axes=(x.dim() - 2, x.dim() - 1))


def ifft2(x: torch.Tensor) -> torch.Tensor:
    return ifftn(x, axes=(x.dim() - 2, x.dim() - 1))


def fftfreq(n: int, d=1.0, device="cpu") -> torch.Tensor:
    """float32 frequency grid of ``numpy.fft.fftfreq(n, d)``.

    For a Python ``d`` it is computed on the host in float64 and rounded,
    as the JAX module does. For a float32 tensor ``d`` (a coordinate step,
    as ``ops.multislice`` passes it) the JAX module's numpy call runs in
    float32 on the JAX scalar: i * (1 / (n * d)), each step rounded to
    float32; so it is here, on ``d``'s device.
    """
    if isinstance(d, torch.Tensor):
        i = np.concatenate([np.arange(0, (n - 1) // 2 + 1),
                            np.arange(-(n // 2), 0)]).astype(np.float32)
        val = 1.0 / (n * d.to(torch.float32))
        return torch.from_numpy(i).to(d.device) * val
    return torch.from_numpy(np.fft.fftfreq(n, d).astype(np.float32)).to(
        device)
