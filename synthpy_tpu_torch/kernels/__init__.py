"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 ``march`` (segment march), K2 ``pack`` (pack builder,
quantiser, decimator) and K3 ``detector``. The sources are in ``csrc/``
and are built with ``nvcc`` for ``sm_90a`` at first launch (``_build``).
"""
