"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: K1 ``march`` (segment march), K2 ``pack`` (pack builder,
quantiser, decimator), K3 ``detector`` (incoherent image and coherent
field sums of exit states) and ``binning`` (its entry points for bare
rays), K4 ``slab_march`` (plain z-scan march), K5 ``time_march``
(time-domain RK4), K6 ``adaptive`` (one Dormand-Prince 5(4) step and its
controller), K7 ``analytic`` (the pack-free march on closed-form fields),
K8 ``deposit`` (cloud-in-cell deposit), K9 ``fill`` (plane-batch pack
fill), K10 ``random`` (threefry draws), K11 ``march_adjoint`` (the segment
march's adjoint), K12 ``cic`` (the differentiable renderer's
cloud-in-cell image and its adjoint), K13 ``boris`` (the proton push), K14
``btable`` (the B-table write), K15 and K16 ``xray`` (the X-ray fold,
point-projection crossings and chords), K17 ``march_sharded`` (a segment
of the grid-sharded march for the shards one device holds), K18 ``sharded_rhs`` (a stage of the
grid-sharded time tracer) and K19 ``pack_chain`` (the renderer's pack
chain, forward and adjoint, under one autograd Function). The sources are
in ``csrc/`` (K5 and K6 share ``time_rhs.cuh``, K4, K7 and K11
``zscan_rhs.cuh``, K2, K9 and K19 ``channels.cuh``) and are built with ``nvcc`` for ``sm_90a`` at first
launch (``_build``, which builds any source by its name: a new kernel
needs no entry there).
"""
