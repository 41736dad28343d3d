"""Pipeline-parallel segment tracing: the field split by probing depth
(PyTorch port of ``synthpy_tpu.parallel.pipeline_pp``).

Device d of a ``seg`` axis of D devices holds segments [d L, (d+1) L) of
the segment pack, L = n_seg / D, and ray chunks stream through the devices
in probing order: chunk c is marched by device d at macro step c + d, the
1F schedule of M + D - 1 macro steps for M chunks, with a ``ppermute``
handing each device's chunk to the next after every step. A device marches
its chunk with kernel K1 (``kernels.march``) over its contiguous segment
range, the same march the single-device tracer runs, so the result is
bit-identical to it (K1 uses a segment's index only to find its table
rows and scales, so a device passes its slice of both). Zero segments
that pad n_seg to a multiple of D (``n_seg_real`` < n_seg) are skipped,
not marched.

With ``shard_chunks`` (default: whenever D divides M) the chunk storage is
split over the axis too: device d holds chunks [d M/D, (d+1) M/D), each
macro step moves the injected chunk to device 0 with a chunk-sized psum
and the finished chunk from device D-1 to its owner with another, as the
JAX program does. The mesh is single-controller (``parallel.mesh``); on
one card the devices' marches run in turn.
"""

from __future__ import annotations

from typing import Optional

import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels import march as _march
from synthpy_tpu_torch.parallel.mesh import (Mesh, Sharded, as_sharded,
                                             line_sum, local_axis)


def make_pipelined_segment_tracer(
    mesh: Mesh,
    layout: ChannelLayout,
    spack,
    n_chunks: int,
    substeps: int = 1,
    atten_sign: float = -1.0,
    axis: str = "seg",
    integrator: str = "rk4",
    unroll: int = 2,
    shard_chunks: Optional[bool] = None,
    weights: str = "stage",
    n_seg_real: Optional[int] = None,
):
    """The PP tracer over ``axis`` of ``mesh``.

    Returns ``f(chunks, seg_planes, origin_ab, inv_ab, dp) -> chunks_out``
    (for a quantised ``spack`` the (n_seg, K+1, C) scales follow
    ``seg_planes``, as in the JAX package) with ``chunks`` the
    (n_chunks, chunk_rays, 8) permuted ray state and ``seg_planes`` the
    whole (n_seg, na*nb, row) table, split here over ``axis``. With
    ``shard_chunks`` the result is a ``Sharded`` over ``axis`` when
    ``chunks`` was one, else a tensor. ``integrator``: "rk4", "rk2",
    "rk2s2" or "rk2s4", as ``trace_zscan_segments``. ``unroll`` is
    accepted as in the JAX package.
    """
    from synthpy_tpu_torch.tracer.zscan import check_march

    del unroll
    local_axis(mesh, axis, "the depth-pipelined march")
    quantized = spack.scales is not None
    qbits = spack.qbits
    check_march(integrator, weights, spack.K, qbits, spack.scales,
                substeps)
    D = mesh.shape[axis]
    n_seg = spack.seg_planes.shape[0]
    if n_seg % D:
        raise ValueError(f"n_seg {n_seg} must divide over {D} devices")
    L = n_seg // D
    if n_seg_real is None:
        n_seg_real = n_seg
    M = n_chunks
    if shard_chunks is None:
        shard_chunks = M % D == 0
    if shard_chunks and M % D:
        raise ValueError(f"shard_chunks needs n_chunks {M} % D {D} == 0")
    M_local = M // D if shard_chunks else M
    # one line of the axis runs the pipeline; other axes would replicate it
    line = mesh.groups(axis)[0]
    devs = [mesh.flat_devices[p] for p in line]

    def run(chunks, seg_planes, *rest):
        scales = rest[0] if quantized else None
        origin_ab, inv_ab, dp = rest[1:] if quantized else rest
        was = isinstance(chunks, Sharded)
        if tuple(chunks.shape[:1]) != (M,) or chunks.shape[-1] != 8:
            raise ValueError(f"chunks {tuple(chunks.shape)} are not "
                             f"({M}, chunk_rays, 8)")
        kw = dict(shape_ab=spack.shape_ab,
                  origin_ab=[float(v) for v in torch.as_tensor(
                      origin_ab).tolist()],
                  inv_ab=[float(v) for v in torch.as_tensor(inv_ab).tolist()],
                  dp=float(dp), layout=layout, K=spack.K,
                  integrator=integrator, weights=weights, qbits=qbits,
                  atten_sign=atten_sign)
        # device d's real segments and scales (pad segments are skipped)
        segs, scs = [], []
        for d, dev in enumerate(devs):
            hi = min((d + 1) * L, n_seg_real)
            segs.append(seg_planes[d * L:hi].to(dev) if hi > d * L
                        else None)
            scs.append(None if scales is None or hi <= d * L
                       else scales[d * L:hi].to(dev))
        spec = (axis if shard_chunks else None, None, None)
        store = [as_sharded(chunks, mesh, spec).shards[p] for p in line]
        R = chunks.shape[1]

        def march(u, d):
            if segs[d] is None:
                return u
            return _march.march(u.contiguous(), segs[d], scs[d], **kw)

        def psum(xs):
            # the psum over the axis: each device gets the ordered sum
            sums = line_sum(xs, devs, False)
            return [sums[dev] for dev in devs]

        zero = [torch.zeros((R, 8), dtype=store[0].dtype, device=dev)
                for dev in devs]
        buf = list(zero)
        out = [torch.zeros_like(st) for st in store]
        for t in range(M + D - 1):
            # device 0 takes chunk t
            if t < M:
                if shard_chunks:
                    owner = t // M_local
                    fresh = psum([store[d][t - d * M_local] if d == owner
                                  else zero[d] for d in range(D)])
                    buf[0] = fresh[0]
                else:
                    buf[0] = store[0][t]
            # the devices holding a chunk march it through their segments
            for d in range(D):
                if 0 <= t - d < M:
                    buf[d] = march(buf[d], d)
            # device D-1 finishes chunk t - (D-1)
            fin = t - (D - 1)
            if 0 <= fin < M:
                if shard_chunks:
                    owner = fin // M_local
                    done = psum([buf[d] if d == D - 1 else zero[d]
                                 for d in range(D)])
                    out[owner][fin - owner * M_local] = done[owner]
                else:
                    out[D - 1][fin] += buf[D - 1]
            # hand each chunk to the next device (ppermute d -> d+1)
            buf = [buf[(d - 1) % D].to(devs[d]) for d in range(D)]
        if shard_chunks:
            res = Sharded(mesh, spec, [out[mesh.index(p, axis)]
                                       for p in range(mesh.size)],
                          chunks.shape)
            return res if was else res.gather()
        # only device D-1 wrote outputs
        return psum(out)[0]

    return run
