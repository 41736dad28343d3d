"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 ``march`` (segment march), K2 ``pack`` (pack builder,
quantiser, decimator), K3 ``detector`` (incoherent image and coherent
field sums of exit states) and ``binning`` (its entry points for bare
rays), K4 ``slab_march`` (plain z-scan march), K5 ``time_march``
(time-domain RK4), K6 ``adaptive`` (one Dormand-Prince 5(4) step and its
controller), K7 ``analytic`` (the pack-free march on closed-form fields)
and K8 ``deposit`` (cloud-in-cell deposit). The sources are in ``csrc/``
(K5 and K6 share ``time_rhs.cuh``, K4 and K7 ``zscan_rhs.cuh``) and are
built with ``nvcc`` for ``sm_90a`` at first launch (``_build``).
"""
