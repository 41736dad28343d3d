"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 ``march`` (segment march), K2 ``pack`` (pack builder,
quantiser, decimator), K3 ``detector``, K4 ``slab_march`` (plain z-scan
march), K5 ``time_march`` (time-domain RK4) and K6 ``adaptive`` (one
Dormand-Prince 5(4) step and its controller). The sources are in ``csrc/``
(K5 and K6 share ``time_rhs.cuh``) and are built with ``nvcc`` for
``sm_90a`` at first launch (``_build``).
"""
