#!/usr/bin/env python3
"""Profile kernel K1 (the segment march) at the main path's shapes on a
card, or time kernel K11 (its adjoint) on the inversion path's inputs,
K13 (the Boris push) on the proton path's, K6 (the adaptive step) on the
adaptive path's, K5 (the time march) on the time path's, K18 (the
grid-sharded time tracer's stage) on its check trace, K19 (the
renderer's pack chain) on the inversion path's volume, K15 and K16 (the
X-ray fold, crossings and chords) on the X-ray path's scene, K14 (the
B-table write) on the proton path's batch or K12 (the renderer's CIC
image) on the inversion path's exit rays.

    python3 march_profile.py        # from the repository root, one GPU
    python3 march_profile.py adjoint [--root DIR] [--reps N] [--save F]
                                     [--against F]
    python3 march_profile.py boris [--root DIR] [--reps N] [--save F]
                                   [--against F]
    python3 march_profile.py adaptive [--root DIR] [--reps N] [--save F]
                                      [--against F]
    python3 march_profile.py time [--root DIR] [--reps N] [--save F]
                                  [--against F]
    python3 march_profile.py k18 [--root DIR] [--reps N] [--save F]
                                 [--against F]
    python3 march_profile.py zscan [--root DIR] [--reps N] [--save F]
                                   [--against F] [--variants [--first F]]
    python3 march_profile.py k19 [--root DIR] [--reps N] [--save F]
                                 [--against F] [--variants] [--builds]
    python3 march_profile.py xray [--root DIR] [--reps N] [--save F]
                                  [--against F] [--variants]
    python3 march_profile.py btable [--root DIR] [--reps N] [--save F]
                                    [--against F] [--variants]
    python3 march_profile.py cic [--root DIR] [--reps N] [--save F]
                                 [--against F]

What it measures on the 512^3 bench lens (K = 512, 4,000,000 rays of a
2 mm circular beam, slab weights):

- ``ptxas``: registers, shared memory and spills of every march kernel
  (``nvcc -Xptxas -v``), the theoretical occupancy they allow and the
  load instructions in the SASS of the bf16, C = 3 kernel;
- ``sectors``: 32-byte sectors that one warp's corner load touches, in the
  caller's order and in entry-cell order, computed from the rays'
  addresses (a model of the load path, not a device counter);
- ``variants``: CUDA-event times (best of 5) of the march as shipped
  (the ray order included) and of builds of the same source that differ in
  one point: no register carry of plane k+1 (every slab reads both its
  planes), the contracted build (no ``--fmad=false``), ``__frcp_rn`` for
  the reciprocal, register caps for 6 or 8 blocks an SM, 256-thread
  blocks; each also with the rays left in the caller's order (the kernel
  launched with the identity order, the order's time not counted);
- ``profile``: a ``torch.profiler`` trace of one ``pipeline.run``: device
  time by kernel and the device's idle share of the call.

It prints one JSON line per part and writes everything to
``chiprun_out/march_profile.json``. Nothing here imports JAX.

``adjoint`` imports ``synthpy_tpu_torch`` from ``DIR`` (default: beside
this script), so that two checkouts can be compared in turns on one card
(parent, change, change, parent). On the inversion path's inputs
(``chip_smoke.py``'s ``inverse_path``: the 512^3 two-blob volume at theta =
-1.5 through K19 into a bf16 K = 64 table, C = 4, the 1 M-ray beam) it
prints one JSON line with:

- ``ptxas``: registers, spills and theoretical occupancy of the f32 and
  bf16 instances at C = 3, 4 and 8;
- ``order_ms`` (``march.ray_order`` alone), ``call_ms`` (one
  ``march_adjoint`` call, the order included) and ``kernel_ms`` (the
  call less the order), each by CUDA events around back-to-back calls on
  segment 0, best of ``--reps``;
- a renderer step (the path's three benches, a sum-of-squares loss):
  forward and backward ms, K11's ms in the backward from its launch
  events, peak device memory;
- the cotangents of all eight segments (each segment's start states from
  K1, a seeded cotangent): a SHA-256 of each ``du_in``, and with
  ``--save F`` the table cotangents of segments 0, 3 and 7 on their
  touched rows written to F; with ``--against F`` (another tree's file)
  whether every ``du_in`` is bit-equal to that tree's and the table
  cotangents' relative L2 distance from its.

``boris`` imports ``synthpy_tpu_torch`` from ``DIR`` as ``adjoint`` does.
On the proton path's inputs (``chip_smoke.py``'s ``proton_path``: the
128^3 solenoidal GRF upsampled x8 to a 1024^3 x 3 B grid, here on the
card; the bf16, dithered int8 and f32 tables of ``build_B_table``; 2 M
protons at 14.7 and 3 MeV, 4,092 steps) it prints one JSON line with:

- ``ptxas``: registers, spills and theoretical occupancy (at the tree's
  ``THREADS`` a block) of each K13 instance, and the load instructions
  (LDG) in each one's SASS;
- for each tier and energy: ``order_ms`` (``march.ray_order`` alone),
  ``kernel_ms`` (one launch in that order; best of ``--reps``) and
  ``call_ms`` (``boris.push``, the order included), and a SHA-256 of the
  rows;
- ``model`` (where the tree has ``profiling.walk_model``): the node
  reads, the load instructions an in-grid step and the 32-byte sectors a
  warp load touches, this design beside the first, on 65,536 protons
  from the middle of the bundle, in entry-cell order and in the caller's
  order (bf16, straight lines);
- with ``--save F`` the rows of every tier and energy written to F; with
  ``--against F`` (another tree's file) whether each is ``torch.equal`` to
  that tree's (IEEE comparison: -0 equals +0) and whether it is bit-equal.

``adaptive`` imports ``synthpy_tpu_torch`` from ``DIR`` as ``adjoint`` does.
On the adaptive path's inputs (``chip_smoke.py``'s ``adaptive_path``: the
512^3 bench lens, the first 1,000,000 rays of the 2 mm beam, the local
step cap) it prints one JSON line with:

- ``ptxas``: registers, spills and theoretical occupancy of every K6
  instance (each device kernel of ``adaptive.cu``) at C = 3 (the lens) and
  at the C = 8 full-physics layout;
- ``step_ms``: one ``rk45_step`` call (CUDA events around 64 back-to-back
  steps after ``kernels.adaptive.start``, best of ``--reps``), and
  ``device_ms``: each device kernel's time a step from a ``torch.profiler``
  trace of 16 steps;
- ``run``: ``solve_adaptive`` on the 1 M rays (ms, best of ``--reps``;
  accepted and rejected steps; peak device memory) and a SHA-256 of its
  exit rows; with ``--save F`` the rows and counts written to F, with
  ``--against F`` (another tree's file) whether the counts are equal and
  the rows bit-equal to that tree's, and their largest difference.

``time`` and ``k18`` import ``synthpy_tpu_torch`` from ``DIR`` as
``adjoint`` does, so that parent and change run in turns on one card.
``time``, on the time path's inputs (``chip_smoke.py``'s ``time_path``:
the 512^3 bench lens, 4 M rays of the 2 mm beam, 723 RK4 steps), prints
one JSON line with ``ptxas`` (registers, spills and occupancy of K5 at
every layout, C = 3 to 8), ``k5_ms`` (one ``time_march.march`` call, the
ray order included; CUDA events around 3 calls, best of ``--reps``),
``k5_kernel_ms`` (one launch in a precomputed entry-cell order),
``run_ms`` (``pipeline.run(solver="time")`` on the prebuilt pack), the
same march at the widest layout (``c8``: C = 8, the lens with inverse
bremsstrahlung, phase and Faraday channels at 512^3, the first 1 M rays)
and a SHA-256 of each case's exit rows. ``k18``, on the grid-sharded tracer's check
trace (``chip_smoke.py``'s ``mesh_path``: the 512^3 lens on four shards of
one card, the first 1 M rays, the first quarter of the 723 steps),
prints ``ptxas`` of the tree's K18 kernels at C = 3 and 8, ``trace_ms``
(one trace, host loop included; best of ``--reps``) and its share a
stage, K18's launches on the trace, the device kernels of one trace by
name (a profiler count) and their device time by kernel
(``device_ms_on_trace``; the trace in ``chiprun_out/k18_trace.json``) and
a stage's share, and a SHA-256 of the exit rows. For both, ``--save F``
writes the rows to F and ``--against F`` (another tree's file) says
whether they are bit-equal to that tree's.

``zscan`` imports ``synthpy_tpu_torch`` from ``DIR`` as ``time`` does. On
the zscan path's inputs (``chip_smoke.py``'s ``zscan_path``: the 512^3
bench lens's f32 ZScanPack, 4 M rays of the 2 mm beam, 511 slabs) it
prints ``ptxas`` (registers, spills and occupancy of K4 at every layout,
C = 3 to 8, f32 and bf16 planes), ``k4_ms`` (one ``slab_march.march``
call, the ray order included; CUDA events around 3 calls, best of
``--reps``), ``k4_kernel_ms`` (one launch in a precomputed entry-cell
order), ``k4_caller_ms`` (one launch in the caller's order), ``run_ms``
(``pipeline.run(solver="zscan")`` on the prebuilt pack), the march on
the bf16 planes and at the widest layout (``c8``: C = 8 at 512^3, the
first 1 M rays), and SHA-256s of the exit rows of each case, the caller's
order included; ``--save`` / ``--against`` as for ``time``. With
``--variants`` it also times builds of K4 changed by ``ZSCAN_VARIANTS``
(and the source file ``--first F``, another design of K4) in both orders,
in turns with the shipped kernel, with registers and bit-equality of the
rows.

``k19`` imports ``synthpy_tpu_torch`` from ``DIR`` as ``time`` does. On the
inversion path's volume (``chip_smoke.py``'s ``inverse_path``: 512^3, the
two-blob volume at theta = -1.5, K = 64) in the cases of ``K19_CASES`` (the
path's phase layout C = 4 with a bf16 table probed along z, x and y; then
along z a float32 table at C = 4, the renderer's default below 256^3, and
C = 8, every channel, with seeded Te, Z and B, in bf16 and float32), it
prints one JSON line with ``sass`` (the static SASS of the C = 4 bf16
instances: the whole kernel and each innermost loop with its global and
shared loads, stores and cp.async copies; ptxas registers and spills), and
for each case ``forward_ms`` and ``adjoint_ms`` (CUDA events around 10
back-to-back calls, best of ``--reps``; a seeded cotangent), the launch
plans with their shared bytes (where the tree has ``pack_chain.plan``) and
a SHA-256 of the table and of d ne; on the path's case also the forward
held bit-equal to ``seg_planes_plain`` and the adjoint's relative L2
distance from ``seg_planes_vjp_plain``. ``--save F`` writes the hashes to F
(JSON), ``--against F`` (another tree's file) says whether each output is
bit-equal to that tree's. With ``--variants`` it also times the plans of
``K19_VARIANTS`` (cells a tile, rows a run), each held bit-equal to the
default plan's outputs; with ``--builds`` the builds of
``K19_SOURCE_VARIANTS`` on the path's case (the probes' outputs are not
the shipped ones).

``xray`` imports ``synthpy_tpu_torch`` from ``DIR`` as ``time`` does. It
times K15 (``kernels.xray.fold``) on the X-ray path's scene
(``chip_smoke.py``'s ``xray_path``: the shell and core of
``examples/xray_radiography.py`` with a seeded ripple, the path's 30 x 40
opacity table): the survey's 32-plane 1024^2 batch (mode 0 with em and the
w scratch, as ``xray_survey_streamed`` folds it; the same with the 120 x
130 table, read through L1; mode 1 on the batch's w and j planes), every
float32 Te in [1, 2000] and every rho in [1e-5, 10] (their w hashed: the
logs, cells and fractions of each float), and the dense route's fold
(tau, the whole volume one batch) along x, y and z at 256^3 and 512^3; then ``xray_survey_streamed`` at 1024^3 from host
volumes and from device volumes (seconds, best of 2). It prints one JSON
line with ``ptxas`` (registers, shared bytes and spills of each fold
instance), ``cases`` (ms: CUDA events around 10 back-to-back calls, best of
``--reps``) and a SHA-256 of each case's tau / em / w; ``--save`` /
``--against`` as for ``k19``. ``--variants`` times builds of ``xray.cu``
changed by ``XRAY_VARIANTS`` on the survey batch, each held bit-equal to
the shipped build. It also times K16 there: ``pp_fold`` on the survey
batch's w planes with the survey's 431 x 321 detector, with the w nodes
its crossings read and the 32-byte sectors they lie in, and ``pp_chords``
at 256^3 with that detector and 160 samples a chord (mode 0 along x, y
and z, mode 1 along y; ``--variants``: lanes a chord, unrolls), each with
``graph_ms`` (calls replayed as a CUDA graph);
and C.13's
cases, the survey batch (K15) and the chords along y with NaN Te planted
at 64 seeded voxels: NaN where the plain version gives NaN
(``nan_as_plain``) and the other elements hashed for the other tree.

``cic`` imports ``synthpy_tpu_torch`` from ``DIR`` as ``time`` does. It
records K12's inputs where the inversion path makes them (one render of
``inverse_path``'s two renderers on its 512^3 volume at theta = -1.5, 1 M
rays, 96 x 96 bins: V = 1, 2 and 4) and prints one JSON line with
``ptxas`` (registers, spills of every K12 instance), the opcodes of the
forward's ray loop (``sass``), and for each V the forward's and the
adjoint's ms (CUDA events around 20 back-to-back calls, best of
``--reps``; a seeded cotangent) and device times (``*_graph_ms``: 20
calls replayed as a CUDA graph, ``profiling.graph_ms``; the forward's two
kernels apart from a profiler trace), the forward's largest error
relative to ``cic_plain`` and its run-to-run spread, the plan (where the
tree has ``cic.grid``: each kernel's grid, the forward's partial images,
shared bytes a block) and the bytes bounds (the function's count, and the
design's with its partial images written and read); the adjoint's outputs
are hashed for the other tree. Then the path's V = 4 rays onto 431 x 321
pixels (the global form).

``btable`` imports ``synthpy_tpu_torch`` from ``DIR`` as ``time`` does. It
times K14 (``kernels.btable.write``) on a 32-plane 1024^2 x 3 batch of a
seeded field (the proton path's batch shape), written at plane 32 of a
64-plane table: int8 dithered (the path's key, fold_in(PRNGKey(5), 32))
and undithered, and bf16 (the control, unchanged), and the int8 writes at
a destination one byte off a 4-byte boundary. It prints one JSON line with
``ptxas`` (registers and spills of each instance), the opcodes of the
dithered int8 instance's main loop (``sass``), ``cases`` (ms, as for
``xray``, calls of 20) and SHA-256s of the codes, and of the int8 codes of
a 3-plane batch written at every destination offset 0-15 mod 16;
``--save`` / ``--against`` as for ``k19``; ``--variants`` times builds
changed by ``BTABLE_VARIANTS``.

``random`` imports ``synthpy_tpu_torch`` from ``DIR`` as ``time`` does. It
times K10 by device time (``graph_ms``) and by ``batch_ms`` at the paths'
sizes (a 4 M uniform and normal, a circular beam's four draws, 256^3
normals, the GRF's complex noise pair at 256^3, 2 x 512^3 bits, uniforms
and normals) and a whole 4 M-ray ``init_beam`` (with the host's call time
and its K10 launches), and hashes every output, short draws and draws
across 2^32 too, for the other tree; ``ptxas`` and the SASS opcodes by
pipe (``sass``); ``--save`` / ``--against`` as for ``k19``;
``--variants`` times builds changed by ``RANDOM_VARIANTS``.

``deposit`` imports ``synthpy_tpu_torch`` from ``DIR`` as ``time`` does.
It records K8's inputs where the diagnostics path makes them (4 M exit
rays of the 512^3 lens onto 512 x 512 nodes) and prints the rays a tile
takes at 16, 32 and 64-node tiles, then for V = 1 and the fused V = 2:
device time (``graph_ms``), ``batch_ms``, each device kernel's time from
a profiler trace, the sums' error against ``deposit_plain``, the spread
between runs and both bytes bounds; where the tree has ``deposit.BATCH``,
the V = 2 deposit in batches of 2^20 and 2^21 rays beside the shipped
batch (device time, error, scratch). ``ptxas`` and ``sass`` as for
``random``; ``--variants`` times builds changed by ``DEPOSIT_VARIANTS``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
import time
from pathlib import Path

DIM, K, RAYS, BINS = 512, 512, 4_000_000, (431, 321)
EXT = 5e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def occupancy(regs: int, threads: int, smem: int = 0) -> dict:
    """Blocks and warps per SM that registers and shared memory allow on an
    H100 (65,536 registers, 2,048 threads, 32 blocks, 227 KB a block)."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = 65536 // (per_warp * warps)
    by_smem = (233472 // (smem + 1024)) if smem else 32
    blocks = min(by_regs, 2048 // threads, 32, by_smem)
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * warps,
            "occupancy": blocks * warps / 64}


# the inversion path (chip_smoke.py INV): 512^3, 1 M rays, K = 64, bf16
INV_DIM, INV_RAYS, INV_K, INV_BINS = 512, 1_000_000, 64, (96, 96)
INV_LXY = 8.0
INV_SCALE, INV_BEAM_R, INV_STOP_R = 5e23, 3.2e-3, 0.12
AB_SEGMENTS = (0, 3, 7)   # segments whose table cotangents are compared


def inversion_inputs(dev):
    """The inversion path's domain, beam, theta, volume(g), bf16 table
    (segments, cells, (K+1) C) at theta and K11's keywords."""
    import numpy as np
    import torch
    from synthpy_tpu_torch import random as jrandom
    from synthpy_tpu_torch.fields import ScalarDomain, layout_of
    from synthpy_tpu_torch.kernels import pack_chain as kpc
    from synthpy_tpu_torch.tracer import init_beam, zscan

    dom = ScalarDomain(2 * EXT, INV_DIM, phaseshift=True, device=dev)
    xh = dom.x.cpu().double().numpy()[:, None]
    yh = dom.y.cpu().double().numpy()[None, :]
    g_np = (0.8 * np.exp(-((xh - 0.8e-3) ** 2 + yh ** 2) / (1.2e-3) ** 2)
            + 0.6 * np.exp(-((xh + 1.0e-3) ** 2 + (yh - 0.6e-3) ** 2)
                           / (0.9e-3) ** 2)
            + 0.15 * np.exp(-(xh ** 2 + yh ** 2) / (3.0e-3) ** 2))
    z_env = torch.from_numpy(np.exp(-(dom.z.cpu().double().numpy() ** 2)
                                    / (2.5e-3) ** 2).astype(np.float32)
                             ).to(dev)

    def volume(g):
        return INV_SCALE * g[:, :, None] * z_env

    dom.external_ne(volume(torch.from_numpy(g_np.astype(np.float32)).to(
        dev)))
    s0 = init_beam(jrandom.fold_in(jrandom.PRNGKey(0), 1), INV_RAYS,
                   INV_BEAM_R, 0.0, EXT, "circular", device=dev)
    theta = torch.full((INV_DIM, INV_DIM), -1.5, device=dev)
    spec = kpc.chain_spec(dom, K=INV_K, pack_dtype=torch.bfloat16)
    with torch.no_grad():
        planes = kpc.forward(volume(torch.nn.functional.softplus(theta)),
                             spec)
    sp0 = zscan.segment_pack_metadata(dom, K=INV_K)
    mkw = dict(shape_ab=sp0.shape_ab, origin_ab=sp0.origin_ab.tolist(),
               inv_ab=sp0.inv_spacing_ab.tolist(), dp=sp0.dp,
               layout=layout_of(dom), K=INV_K)
    return dom, s0, theta, volume, planes, mkw


def adjoint(args):
    """The ``adjoint`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch.inverse import make_renderer
    from synthpy_tpu_torch.kernels import _build, march, march_adjoint
    from synthpy_tpu_torch.kernels.profiling import (batch_ms, nvidia_smi,
                                                     ptxas)
    from synthpy_tpu_torch.tracer import zscan

    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi()}
    src = _build.CSRC / march_adjoint.KERNEL.source
    kern, _, _ = ptxas(src, march_adjoint.KERNEL.flags)
    # the instances by mangled name: the dtype code, then the layout's
    # switches (inv_brems, phaseshift, B_on) of C = 3, 4 (the phase
    # layout) and 8
    report = {}
    for n, v in kern.items():
        for dt, tier in enumerate(("f32", "bf16")):
            for C, lay in ((3, "0ELi0ELi0E"), (4, "0ELi1ELi0E"),
                           (8, "1ELi1ELi1E")):
                if (f"adjoint_kernelILi{dt}E" in n
                        and f"LayoutILi{lay}" in n):
                    report[f"{tier}_C{C}"] = {
                        **v, **occupancy(v["regs"], 128, v.get("smem", 0))}
    out["ptxas"] = report

    dom, s0, theta, volume, planes, mkw = inversion_inputs(dev)
    geo = (mkw["shape_ab"], mkw["origin_ab"], mkw["inv_ab"])
    u0 = zscan.permute_state(s0, "z").contiguous()
    gen = torch.Generator(device=dev).manual_seed(14)
    du = torch.randn(u0.shape, generator=gen, device=dev)

    # K11's time on segment 0, the order apart
    dseg = torch.zeros(planes[0].shape, device=dev)

    def best(fn):
        return min(batch_ms(fn, calls=3) for _ in range(args.reps))

    out["order_ms"] = best(lambda: march.ray_order(u0, *geo))
    out["call_ms"] = best(lambda: march_adjoint.march_adjoint(
        u0, planes[0], du, dseg=dseg, **mkw))
    out["kernel_ms"] = out["call_ms"] - out["order_ms"]

    # a renderer step: the path's benches, a sum of squares
    render = make_renderer(
        dom, s0, diagnostic=("shadowgraphy", "schlieren_df", "phase_map"),
        bins=INV_BINS, K=INV_K, Lx=INV_LXY, Ly=INV_LXY,
        pack_dtype=torch.bfloat16,
        bench_kwargs={"schlieren_df": {"stop_R": INV_STOP_R}})
    steps = []
    for _ in range(args.reps):
        th = theta.clone().requires_grad_()
        march_adjoint.KERNEL.events = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss = sum((im ** 2).mean() for im in render(volume(
            torch.nn.functional.softplus(th))))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        steps.append({"forward_ms": (t1 - t) * 1e3,
                      "backward_ms": (t2 - t1) * 1e3,
                      "k11_ms": sum(a.elapsed_time(b) for a, b in
                                    march_adjoint.KERNEL.events),
                      "k11_launches": len(march_adjoint.KERNEL.events),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        march_adjoint.KERNEL.events = None
    out["steps"] = steps
    del render, th, loss
    torch.cuda.empty_cache()

    # every segment's cotangents: du_in's hash, the table's on its rows
    u, gen = u0, torch.Generator(device=dev).manual_seed(15)
    hashes, tables = [], {}
    for s in range(planes.shape[0]):
        dus = torch.randn(u.shape, generator=gen, device=dev)
        dseg.zero_()
        got = march_adjoint.march_adjoint(u, planes[s], dus, dseg=dseg,
                                          **mkw)
        hashes.append(hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest())
        if s in AB_SEGMENTS:
            cells = march.entry_cells(u, *geo).long()
            nb = mkw["shape_ab"][1]
            rows = torch.unique(torch.cat([cells + o for o in
                                           (0, 1, nb, nb + 1)]))
            tables[s] = (rows.cpu(), dseg[rows].cpu())
        u = march.march(u, planes[s][None], None, **mkw)
    out["du_in_sha256"] = hashes
    if args.save:
        torch.save({"du_in_sha256": hashes, "tables": tables}, args.save)
    if args.against:
        ref = torch.load(args.against)
        rel = {}
        for s, (rows, t) in tables.items():
            r_rows, r_t = ref["tables"][s]
            same = torch.equal(rows, r_rows)
            rel[s] = float((t - r_t).double().norm()
                           / r_t.double().norm()) if same else None
        out["against"] = {"file": args.against,
                          "du_in_bit_equal": hashes == ref["du_in_sha256"],
                          "table_rel_l2": rel}
    print(json.dumps({"part": "adjoint", **out}), flush=True)


# the proton path (chip_smoke.py PROTON): 1024^3, 2 M protons, two energies
PROTON_EXT, PROTON_DIM, PROTON_SYNTH, PROTON_N = 5e-3, 1024, 128, 2_000_000
PROTON_ENERGIES, PROTON_DITHER, MODEL_PROTONS = (14.7, 3.0), 5, 65_536


def boris_part(args):
    """The ``boris`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch import random as jrandom
    from synthpy_tpu_torch.fields import ScalarDomain, grf
    from synthpy_tpu_torch.kernels import _build, boris, march, profiling
    from synthpy_tpu_torch.kernels.profiling import (best_ms, nvidia_smi,
                                                     ptxas)
    from synthpy_tpu_torch.tracer import particles

    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi()}
    src = _build.CSRC / boris.KERNEL.source
    kern, _, cubin = ptxas(src, boris.KERNEL.flags)
    threads = int(re.search(r"constexpr int THREADS = (\d+);",
                            src.read_text()).group(1))
    # an older tree at --root has no load_mix (its LDG counts stay None)
    # and no walk_model (no model)
    load_mix = getattr(profiling, "load_mix", None)
    walk_model = getattr(profiling, "walk_model", None)
    report = {}
    for n, v in kern.items():
        m = re.search(r"borisI(f|13__nv_bfloat16|a)E", n)
        if m:
            tier = {"f": "f32", "13__nv_bfloat16": "bf16", "a": "int8"}[
                m.group(1)]
            report[tier] = {
                **v, **occupancy(v["regs"], threads, v.get("smem", 0)),
                "ldg": load_mix(cubin, re.escape(n)).get("LDG", 0)
                if load_mix else None}
    out["ptxas"] = report

    _, Bs = grf.grf_vector_solenoidal(
        jrandom.PRNGKey(7), grf.power_law(3.667), l_max=3e-3, l_min=0.4e-3,
        extent=PROTON_EXT, res=PROTON_SYNTH, rms=10.0, device=dev)
    up = PROTON_DIM // Bs.shape[0]
    B = Bs.repeat_interleave(up, 0).repeat_interleave(up, 1)
    B = B.repeat_interleave(up, 2)
    del Bs
    domain = ScalarDomain(2 * PROTON_EXT, PROTON_DIM, device=dev)
    domain.external_B(B)
    s0 = {E: particles.init_proton_beam(
        jrandom.PRNGKey(11), PROTON_N, E, source_distance=10e-3,
        extent=PROTON_EXT, cone_radius=0.6 * PROTON_EXT, device=dev)
        for E in PROTON_ENERGIES}
    rows_out, tiers = {}, {}
    for tier, dt in (("bf16", torch.bfloat16), ("int8", torch.int8),
                     ("f32", torch.float32)):
        tab = particles.build_B_table(
            domain, dtype=dt, plane_batch=32, host_quantize=False,
            dither=PROTON_DITHER if tier == "int8" else None)
        for E in PROTON_ENERGIES:
            rows, grid, scale, kw, _ = particles.boris_inputs(
                s0[E], domain, E, B_table=tab)
            geo = (tuple(grid.shape[:3]), kw["origin"], kw["inv_spacing"])
            order = march.ray_order(rows, *geo)

            def best(fn):
                return best_ms(fn, reps=args.reps)

            rec = {"n_steps": kw["n_steps"],
                   "order_ms": best(lambda: march.ray_order(rows, *geo))}
            rec["kernel_ms"] = best(lambda: boris.launch(
                boris.KERNEL, rows.clone(), grid, scale, **kw, order=order))
            rec["call_ms"] = best(lambda: boris.push(rows, grid, scale,
                                                     **kw))
            got = boris.push(rows, grid, scale, **kw)
            rec["sha256"] = hashlib.sha256(
                got.cpu().numpy().tobytes()).hexdigest()
            rows_out[f"{tier}/{E}"] = got.cpu()
            if tier == "bf16" and E == PROTON_ENERGIES[0] and walk_model:
                mid = (PROTON_N - MODEL_PROTONS) // 2
                pick = {"entry_cell_order": order[mid:mid + MODEL_PROTONS],
                        "caller_order": torch.arange(
                            mid, mid + MODEL_PROTONS, device=dev)}
                out["model"] = {k: walk_model(
                    rows, *geo, kw["h"], kw["n_steps"],
                    grid.element_size(), order=o)
                    for k, o in pick.items()}
            tiers[f"{tier}/{E}MeV"] = rec
            del rows, got, order
        del tab
        torch.cuda.empty_cache()
    out["tiers"] = tiers
    if args.save:
        torch.save(rows_out, args.save)
    if args.against:
        ref = torch.load(args.against)
        out["against"] = {"file": args.against, **{
            k: {"equal": torch.equal(v, ref[k]),
                "bit_equal": torch.equal(v.view(torch.int32),
                                         ref[k].view(torch.int32))}
            for k, v in rows_out.items()}}
    print(json.dumps({"part": "boris", **out}), flush=True)


def kernel_report(kern: dict, pattern: str, threads: dict) -> dict:
    """ptxas reports of the kernels whose mangled names match ``pattern``
    (group 1: the kernel's name), each templated one at C = 3 (the lens)
    and C = 8 (full physics), with the occupancy at ``threads[name]``
    threads a block."""
    report = {}
    for n, v in kern.items():
        m = re.search(pattern, n)
        if not m:
            continue
        lay = [tag for tag, code in (("C3", "0ELi0ELi0E"),
                                     ("C8", "1ELi1ELi1E"))
               if f"LayoutILi{code}" in n]
        if "Layout" in n and not lay:
            continue
        name = m.group(1)
        report["_".join([name] + lay)] = {
            **v, **occupancy(v["regs"], threads[name], v.get("smem", 0))}
    return report


# the adaptive path (chip_smoke.py adaptive_path): 512^3, the first 1 M rays
ADAPTIVE_RAYS = 1_000_000


def adaptive_part(args):
    """The ``adaptive`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch.fields import ScalarDomain
    from synthpy_tpu_torch.fields.domain import build_pack, layout_of
    from synthpy_tpu_torch.kernels import _build, adaptive, march
    from synthpy_tpu_torch.kernels.profiling import (batch_ms, kernel_ms,
                                                     nvidia_smi, ptxas)
    from synthpy_tpu_torch.tracer import init_beam
    from synthpy_tpu_torch.tracer.adaptive import solve_adaptive
    from synthpy_tpu_torch.tracer.propagator import t_end_of

    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi()}
    src = _build.CSRC / adaptive.KERNEL.source
    kern, _, _ = ptxas(src, adaptive.KERNEL.flags)
    text = src.read_text()
    threads = int(re.search(r"constexpr int THREADS = (\d+);",
                            text).group(1))
    # the one-block kernels after each launch: the parent's finalize
    # kernels (FIN_THREADS), or this tree's controllers (THREADS)
    fin = re.search(r"constexpr int FIN_THREADS = (\d+);", text)
    one = int(fin.group(1)) if fin else threads
    out["ptxas"] = kernel_report(
        kern, r"\d+(step_kernel|init_kernel|finalize_kernel|init_finalize|"
        r"controller_kernel|init_controller)",
        {"step_kernel": threads, "init_kernel": threads,
         "finalize_kernel": one, "init_finalize": one,
         "controller_kernel": one, "init_controller": one})

    domain = ScalarDomain(2 * EXT, DIM, device=dev).test_lens(ne_0=5e24,
                                                              LR=1.5e-3)
    tpack = build_pack(domain)
    tgrid = (tpack.channels, tpack.origin, tpack.inv_spacing)
    t_end = t_end_of(domain.extent)
    s_a = init_beam(0, RAYS, 2e-3, 0.0, EXT, "circular",
                    device=dev)[:, :ADAPTIVE_RAYS].contiguous()
    rows = s_a.T.contiguous()
    kw = dict(layout=layout_of(domain),
              plane_amax=adaptive.plane_amax_of(tpack.channels, 2), p_axis=2)
    order = march.ray_order(rows, tuple(tpack.channels.shape[:3]),
                            *tgrid[1:])

    def step_of(tr):
        return lambda: adaptive.KERNEL.launch("rk45_step", dev, *tr.args)

    tr = adaptive.start(adaptive.KERNEL, rows, *tgrid, t_end, order, **kw)
    out["step_ms"] = min(batch_ms(step_of(tr), calls=64)
                         for _ in range(args.reps))
    os.makedirs("chiprun_out", exist_ok=True)
    out["device_ms"] = kernel_ms(step_of(tr), Path("chiprun_out")
                                 / "adaptive_steps_trace.json", reps=16)
    if int(tr.ctrl[9]):
        sys.exit("march_profile: the timed steps reached t_end")
    del tr

    runs = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res, (n_acc, n_rej) = solve_adaptive(s_a, domain, pack=tpack,
                                             return_steps=True)
        torch.cuda.synchronize()
        runs.append({"run_ms": (time.perf_counter() - t) * 1e3,
                     "accepted": n_acc, "rejected": n_rej,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    sf = res.sf.cpu()
    out["run"] = {"runs": runs, "run_ms": min(r["run_ms"] for r in runs),
                  "ms_per_step": min(r["run_ms"] for r in runs)
                  / (n_acc + n_rej),
                  "sha256": hashlib.sha256(sf.numpy().tobytes()).hexdigest()}
    if args.save:
        torch.save({"sf": sf, "steps": (n_acc, n_rej)}, args.save)
    if args.against:
        ref = torch.load(args.against)
        same = sf.shape == ref["sf"].shape
        out["against"] = {
            "file": args.against,
            "steps_equal": (n_acc, n_rej) == tuple(ref["steps"]),
            "bit_equal": same and torch.equal(sf.view(torch.int32),
                                              ref["sf"].view(torch.int32)),
            "max_abs_diff": float((sf - ref["sf"]).abs().nan_to_num(0.0)
                                  .max()) if same else None}
    print(json.dumps({"part": "adaptive", **out}), flush=True)


def _rows_report(out: dict, rows: dict, args) -> None:
    """A SHA-256 of each of ``rows`` (name: tensor) in ``out``; with
    ``--save`` the rows written, with ``--against`` whether each is
    bit-equal to another tree's."""
    import torch
    rows = {k: v.cpu() for k, v in rows.items()}
    out["sha256"] = {k: hashlib.sha256(v.numpy().tobytes()).hexdigest()
                     for k, v in rows.items()}
    if args.save:
        torch.save(rows, args.save)
    if args.against:
        ref = torch.load(args.against)
        out["against"] = {"file": args.against}
        for k, v in rows.items():
            same = v.shape == ref[k].shape
            out["against"][k] = {
                "bit_equal": same and torch.equal(v.view(torch.int32),
                                                  ref[k].view(torch.int32)),
                "max_abs_diff": float((v - ref[k]).abs().nan_to_num(0.0)
                                      .max()) if same else None}


def _threads(src: Path) -> int:
    return int(re.search(r"constexpr int THREADS = (\d+);",
                         src.read_text()).group(1))


def time_part(args):
    """The ``time`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch import pipeline
    from synthpy_tpu_torch.fields import ScalarDomain
    from synthpy_tpu_torch.fields.domain import build_pack, layout_of
    from synthpy_tpu_torch.kernels import _build, march, time_march
    from synthpy_tpu_torch.kernels.profiling import (batch_ms, best_ms,
                                                     nvidia_smi, ptxas)
    from synthpy_tpu_torch.tracer import init_beam
    from synthpy_tpu_torch.tracer.propagator import default_n_steps, dt_of

    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi()}
    src = _build.CSRC / time_march.KERNEL.source
    kern, _, _ = ptxas(src, time_march.KERNEL.flags)
    threads = _threads(src)
    out["ptxas"] = {}
    for n, v in kern.items():
        m = re.search(r"rk4_kernel.*LayoutILi(\d)ELi(\d)ELi(\d)E", n)
        if m:
            ib, ps, bon = (int(x) for x in m.groups())
            out["ptxas"][f"C{3 + ib + ps + 3 * bon}_{ib}{ps}{bon}"] = {
                **v, **occupancy(v["regs"], threads, v.get("smem", 0))}

    domain = ScalarDomain(2 * EXT, DIM, device=dev).test_lens(ne_0=5e24,
                                                              LR=1.5e-3)
    tpack = build_pack(domain)
    tgrid = (tpack.channels, tpack.origin, tpack.inv_spacing)
    n_steps = default_n_steps(domain, domain.extent)
    dt = dt_of(n_steps, domain.extent)
    s0 = init_beam(0, RAYS, 2e-3, 0.0, EXT, "circular", device=dev)
    rows = s0.T.contiguous()
    kw = dict(layout=layout_of(domain), n_steps=n_steps)
    order = march.ray_order(rows, tuple(tpack.channels.shape[:3]),
                            *tgrid[1:])
    out.update(n_steps=n_steps, rays=RAYS)
    out["k5_ms"] = min(batch_ms(lambda: time_march.march(
        rows, *tgrid, dt, **kw), calls=3) for _ in range(args.reps))
    out["k5_kernel_ms"] = min(batch_ms(lambda: time_march.launch(
        time_march.KERNEL, rows, *tgrid, dt, order, **kw), calls=3)
        for _ in range(args.reps))
    out["run_ms"] = best_ms(lambda: pipeline.run(
        domain, s0, solver="time", pack=tpack, bins=BINS), reps=args.reps)
    lens_rows = time_march.march(rows, *tgrid, dt, **kw)
    del tpack, tgrid
    # the widest layout, C = 8 (inverse bremsstrahlung, phase, Faraday) at
    # 512^3, on the first 1 M rays
    phys = ScalarDomain(2 * EXT, DIM, inv_brems=True, phaseshift=True,
                        device=dev).test_lens(ne_0=5e24, LR=1.5e-3)
    phys.external_Te(50.0 + 10.0 * torch.rand(
        phys.dims, generator=torch.Generator().manual_seed(1)))
    phys.external_Z(2.0 * torch.ones(phys.dims))
    phys.test_B(Bmax=10.0)
    ppack = build_pack(phys)
    pgrid = (ppack.channels, ppack.origin, ppack.inv_spacing)
    p_steps = default_n_steps(phys, phys.extent)
    pdt = dt_of(p_steps, phys.extent)
    prows = rows[:C8_RAYS].contiguous()
    pkw = dict(layout=layout_of(phys), n_steps=p_steps)
    out["c8"] = {"rays": C8_RAYS, "n_steps": p_steps,
                 "C": layout_of(phys).n_channels,
                 "k5_ms": min(batch_ms(lambda: time_march.march(
                     prows, *pgrid, pdt, **pkw), calls=2)
                     for _ in range(args.reps))}
    _rows_report(out, {"lens": lens_rows, "c8": time_march.march(
        prows, *pgrid, pdt, **pkw)}, args)
    print(json.dumps({"part": "time", **out}), flush=True)


C8_RAYS = 1_000_000   # the time and zscan parts' C = 8 case

# name -> text substitutions of slab_march.cu that ``zscan --variants``
# times beside the shipped kernel: a register cap for 8 blocks an SM; the
# carried corners shifted along a and b on a move of one, reading only the
# two that came in (K5's carry), which lost to reading all four
_READ4 = """  if (ia == K.ia && ib == K.ib) return;
  K.ia = ia;
  K.ib = ib;
"""
_SHIFT = """  unsigned need = 0;
  if (ib != K.ib) need |= corner_shift<1, C>(K.c, ib - K.ib);
  if (ia != K.ia) need |= corner_shift<2, C>(K.c, ia - K.ia);
  K.ia = ia;
  K.ib = ib;
  if (need == 0) return;
"""
_LOAD4 = """#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int m = 0; m < C; ++m)
      K.c[q][m] = load<DT>(w, (q & 2 ? r1 : r0) + C * (q & 1) + m);
"""
_LOAD_NEED = """#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (need & (1u << q)) {
#pragma unroll
      for (int m = 0; m < C; ++m)
        K.c[q][m] = load<DT>(w, (q & 2 ? r1 : r0) + C * (q & 1) + m);
    }
"""
_SHIFT_FN = """// Move the carried corners d cells along the axis of bit BIT of q (1: b,
// 2: a); returns the corners (a bit mask of q) to read anew.
template <int BIT, int C>
__device__ __forceinline__ unsigned corner_shift(float c[4][C], int d) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q & BIT) continue;
#pragma unroll
    for (int m = 0; m < C; ++m) {
      const float lo = c[q][m], hi = c[q | BIT][m];
      c[q][m] = d == 1 ? hi : lo;
      c[q | BIT][m] = d == -1 ? lo : hi;
    }
  }
  constexpr unsigned upper = BIT == 1 ? 0xAu : 0xCu;
  return d == 1 ? upper : d == -1 ? (~upper & 0xFu) : 0xFu;
}

// Bring K to cell (ia, ib)"""
_CAP = ("__global__ void __launch_bounds__(THREADS) slab_kernel(Params P) {",
        "__global__ void __launch_bounds__(THREADS, 8) slab_kernel(Params P) {")
ZSCAN_VARIANTS = {
    "cap64": [_CAP],
    "shift": [(_READ4, _SHIFT), (_LOAD4, _LOAD_NEED),
              ("// Bring K to cell (ia, ib)", _SHIFT_FN)]}


def zscan_part(args):
    """The ``zscan`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch import pipeline
    from synthpy_tpu_torch.fields import ScalarDomain
    from synthpy_tpu_torch.fields.domain import build_pack, layout_of
    from synthpy_tpu_torch.kernels import _build, march, slab_march
    from synthpy_tpu_torch.kernels.profiling import (batch_ms, best_ms,
                                                     nvidia_smi, ptxas)
    from synthpy_tpu_torch.tracer import init_beam, zscan

    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi()}
    src = _build.CSRC / slab_march.KERNEL.source
    kern, _, _ = ptxas(src, slab_march.KERNEL.flags)
    threads = _threads(src)
    out["ptxas"] = {}
    for n, v in kern.items():
        m = re.search(r"slab_kernelILi(\d)E.*LayoutILi(\d)ELi(\d)ELi(\d)E", n)
        if m:
            dt, ib, ps, bon = (int(x) for x in m.groups())
            out["ptxas"][f"{('f32', 'bf16')[dt]}_C{3 + ib + ps + 3 * bon}"
                         f"_{ib}{ps}{bon}"] = {
                **v, **occupancy(v["regs"], threads, v.get("smem", 0))}

    def case(domain, dtype):
        tpack = build_pack(domain)
        lay = layout_of(domain)
        zp = zscan.make_zscan_pack(tpack, lay, "z", dtype=dtype)
        del tpack
        zargs = (zp.planes, zp.origin_ab.tolist(), zp.inv_spacing_ab.tolist(),
                 zp.dp)
        kw = dict(layout=lay, n_slabs=zp.planes.shape[0] - 1)
        return zp, zargs, kw

    domain = ScalarDomain(2 * EXT, DIM, device=dev).test_lens(ne_0=5e24,
                                                              LR=1.5e-3)
    s0 = init_beam(0, RAYS, 2e-3, 0.0, EXT, "circular", device=dev)
    u = zscan.permute_state(s0, "z").contiguous()
    zp, zargs, kw = case(domain, torch.float32)
    order = march.ray_order(u, tuple(zp.planes.shape[1:3]), *zargs[1:3])
    arange = torch.arange(RAYS, device=dev)

    def best(fn, calls=3):
        return min(batch_ms(fn, calls=calls) for _ in range(args.reps))

    out.update(rays=RAYS, n_slabs=kw["n_slabs"])
    out["k4_ms"] = best(lambda: slab_march.march(u, *zargs, **kw))
    out["k4_kernel_ms"] = best(lambda: slab_march.launch(
        slab_march.KERNEL, u, *zargs, order, **kw))
    out["k4_caller_ms"] = best(lambda: slab_march.launch(
        slab_march.KERNEL, u, *zargs, arange, **kw))
    out["run_ms"] = best_ms(lambda: pipeline.run(
        domain, s0, solver="zscan", zpack=zp, bins=BINS), reps=args.reps)
    rows = {"lens": slab_march.march(u, *zargs, **kw),
            "lens_caller": slab_march.launch(slab_march.KERNEL, u, *zargs,
                                             arange, **kw)}
    del zp, zargs
    zp, zargs, kw = case(domain, torch.bfloat16)
    out["bf16"] = {"k4_ms": best(lambda: slab_march.march(u, *zargs,
                                                           **kw))}
    rows["lens_bf16"] = slab_march.march(u, *zargs, **kw)
    del zp, zargs
    # the widest layout, C = 8 (inverse bremsstrahlung, phase, Faraday) at
    # 512^3, on the first 1 M rays
    phys = ScalarDomain(2 * EXT, DIM, inv_brems=True, phaseshift=True,
                        device=dev).test_lens(ne_0=5e24, LR=1.5e-3)
    phys.external_Te(50.0 + 10.0 * torch.rand(
        phys.dims, generator=torch.Generator().manual_seed(1)))
    phys.external_Z(2.0 * torch.ones(phys.dims))
    phys.test_B(Bmax=10.0)
    zp, zargs, kw = case(phys, torch.float32)
    pu = u[:C8_RAYS].contiguous()
    out["c8"] = {"rays": C8_RAYS, "C": kw["layout"].n_channels,
                 "k4_ms": best(lambda: slab_march.march(pu, *zargs, **kw),
                               calls=2)}
    rows["c8"] = slab_march.march(pu, *zargs, **kw)
    _rows_report(out, rows, args)
    if args.variants:
        del zp, zargs
        out["variants"] = _zscan_variants(args, domain, u, case,
                                          rows["lens"])
    print(json.dumps({"part": "zscan", **out}), flush=True)


def _zscan_variants(args, domain, u, case, lens_rows):
    """K4 builds changed by ``ZSCAN_VARIANTS`` (and the first design's
    source at ``--first``, when given), each timed in entry-cell order and
    in the caller's order in turns with the shipped kernel (shipped,
    variant, variant, shipped), its rows held bit-equal."""
    import torch
    from synthpy_tpu_torch.kernels import _build, march, slab_march
    from synthpy_tpu_torch.kernels.profiling import batch_ms, ptxas, variant

    kernels = {n: variant(slab_march.KERNEL, n, subs)
               for n, subs in ZSCAN_VARIANTS.items()}
    if args.first:
        path = _build.BUILD_DIR / "slab_march_first.cu"
        path.write_text(Path(args.first).read_text())
        kernels["first_design"] = _build.Kernel(
            str(path), slab_march.KERNEL.functions, slab_march.KERNEL.flags)
    _build.build({k.source: k.flags for k in kernels.values()})
    zp, zargs, kw = case(domain, torch.float32)
    order = march.ray_order(u, tuple(zp.planes.shape[1:3]), *zargs[1:3])
    arange = torch.arange(u.shape[0], device=u.device)

    def ms(kern, o):
        return min(batch_ms(lambda: slab_march.launch(
            kern, u, *zargs, o, **kw), calls=3) for _ in range(args.reps))

    out = {}
    for name, kern in kernels.items():
        same = torch.equal(slab_march.launch(kern, u, *zargs, order, **kw)
                           .view(torch.int32), lens_rows.view(torch.int32))
        row = {"bit_equal": same}
        for label, o in (("entry_order", order), ("caller_order", arange)):
            row[label] = {"shipped_ms": [ms(slab_march.KERNEL, o)],
                          "variant_ms": [ms(kern, o), ms(kern, o)]}
            row[label]["shipped_ms"].append(ms(slab_march.KERNEL, o))
        rep, _, _ = ptxas(Path(kern.source), kern.flags)
        row["ptxas_f32_C3"] = next(
            (v for n, v in rep.items()
             if re.search(r"slab_kernelILi0E.*LayoutILi0ELi0ELi0E", n)),
            None)
        out[name] = row
    return out


# the grid-sharded time tracer's check trace (chip_smoke.py MESH): the
# 512^3 bench lens on four shards of one card, the first 1 M rays, the
# first quarter of the depth
K18_RAYS, K18_SHARDS = 1_000_000, 4


def k18_part(args):
    """The ``k18`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch.fields import ScalarDomain
    from synthpy_tpu_torch.fields.domain import build_pack, layout_of
    from synthpy_tpu_torch.kernels import _build, sharded_rhs
    from synthpy_tpu_torch.kernels.profiling import (best_ms, device_kernels,
                                                     kernel_ms, nvidia_smi,
                                                     ptxas)
    from synthpy_tpu_torch.parallel import Mesh, make_gridsharded_tracer
    from synthpy_tpu_torch.tracer import init_beam
    from synthpy_tpu_torch.tracer.propagator import default_n_steps, dt_of

    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi()}
    src = _build.CSRC / sharded_rhs.KERNEL.source
    kern, _, _ = ptxas(src, sharded_rhs.KERNEL.flags)
    threads = _threads(src)
    out["ptxas"] = kernel_report(
        kern, r"\d+(gather_kernel|stage_kernel|stage_gather_kernel)",
        {"gather_kernel": threads, "stage_kernel": threads,
         "stage_gather_kernel": threads})

    dom = ScalarDomain(2 * EXT, DIM, device=dev).test_lens(ne_0=5e24,
                                                           LR=1.5e-3)
    tp = build_pack(dom)
    n_full = default_n_steps(dom, dom.extent, 1.0)
    n = n_full // 4
    dt = dt_of(n_full, dom.extent)
    rows = init_beam(0, RAYS, 2e-3, 0.0, EXT, "circular",
                     device=dev)[:, :K18_RAYS].T.contiguous()
    mesh = Mesh((K18_SHARDS,), ("grid",), devices=[dev] * K18_SHARDS)
    tr = make_gridsharded_tracer(mesh, layout_of(dom), n, nx_global=DIM)

    def trace():
        return tr(rows, tp.channels, tp.origin, tp.inv_spacing, dt)

    stages = 4 * n
    out.update(rays=K18_RAYS, steps=n, stages=stages, shards=K18_SHARDS)
    out["trace_ms"] = best_ms(trace, reps=args.reps)
    out["trace_ms_per_stage"] = out["trace_ms"] / stages
    sharded_rhs.KERNEL.launches = 0
    res = trace()
    out["launches_on_trace"] = sharded_rhs.KERNEL.launches
    out["device_kernels_on_trace"] = device_kernels(trace, calls=1)
    os.makedirs("chiprun_out", exist_ok=True)
    dev_ms = kernel_ms(trace, Path("chiprun_out") / "k18_trace.json",
                       reps=1)
    out["device_ms_on_trace"] = dev_ms
    out["device_ms_per_stage"] = dev_ms["total"] / stages
    _rows_report(out, {"trace": res}, args)
    print(json.dumps({"part": "k18", **out}), flush=True)


def _here_profiling():
    """This tree's ``kernels/profiling.py`` (its SASS counter), loaded
    beside the ``--root`` tree's package, whose ``_build`` it uses."""
    import importlib.util

    path = (Path(__file__).resolve().parent / "synthpy_tpu_torch" / "kernels"
            / "profiling.py")
    spec = importlib.util.spec_from_file_location("profiling_here", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sass(kernel, name: str, subs, patterns, dump: str) -> dict:
    """The SASS mix (``profiling.sass_loop_mix``) of a build of
    ``kernel``'s source with the text substitutions ``subs`` (runtime
    switches folded to the path's values), for the first of ``patterns``
    found; registers beside it."""
    from synthpy_tpu_torch.kernels import profiling

    here = _here_profiling()
    var = profiling.variant(kernel, name, subs)
    kern, _, cubin = profiling.ptxas(Path(var.source), kernel.flags)
    for pattern in patterns:
        try:
            mix = here.sass_loop_mix(cubin, pattern,
                                     Path("chiprun_out") / dump)
        except RuntimeError:
            continue
        mix["ptxas"] = kern.get(mix["name"])
        return mix
    raise RuntimeError(f"{name}: no kernel matching {patterns}")


# the lens (form 4) at C = 3, probing along z; the parent's instances have
# no axis argument
K7_PATTERNS = (r"analytic_kernelILi4EN7layouts6LayoutILi0ELi0ELi0EEELi2E",
               r"analytic_kernelILi4EN7layouts6LayoutILi0ELi0ELi0EEE")
# K7 builds that ``analytic --variants`` times beside the shipped kernel
K7_VARIANTS = {
    "threads256": [("constexpr int THREADS = 128;",
                    "constexpr int THREADS = 256;")],
    "cap_8_blocks": [("__launch_bounds__(THREADS) analytic_kernel",
                      "__launch_bounds__(THREADS, 8) analytic_kernel")],
    "cap_12_blocks": [("__launch_bounds__(THREADS) analytic_kernel",
                       "__launch_bounds__(THREADS, 12) analytic_kernel")]}


def analytic_part(args):
    """The ``analytic`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch import constants, pipeline
    from synthpy_tpu_torch.fields import ScalarDomain
    from synthpy_tpu_torch.fields.domain import layout_of
    from synthpy_tpu_torch.kernels import _build, analytic
    from synthpy_tpu_torch.kernels.profiling import (batch_ms, best_ms,
                                                     kernel_of, nvidia_smi,
                                                     ptxas, variant)
    from synthpy_tpu_torch.tracer import init_beam, zscan

    here = _here_profiling()
    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi(),
           "sm_clock_mhz": here.sm_clock_mhz(),
           "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    src = _build.CSRC / analytic.KERNEL.source
    t = time.perf_counter()
    kern, _, _ = ptxas(src, analytic.KERNEL.flags)
    out["ptxas_s"] = time.perf_counter() - t
    out["instances"] = len(kern)
    out["ptxas"] = {n: v for n, v in kern.items()
                    if re.search(r"ILi4E.*LayoutILi0ELi0ELi0E", n)}
    out["sass"] = {k: _sass(analytic.KERNEL, f"sass_{k}",
                            here.FOLDS[f"k7_{k}"], K7_PATTERNS,
                            f"k7_{k}_{Path(args.root).name}.sass")
                   for k in ("rk2", "rk4")}

    domain = ScalarDomain(2 * EXT, DIM, device=dev).test_lens(ne_0=5e24,
                                                              LR=1.5e-3)
    s0 = init_beam(0, RAYS, 2e-3, 0.0, EXT, "circular", device=dev)
    u = zscan.permute_state(s0, "z").contiguous()
    lo = [float(c[0]) for c in (domain.x, domain.y, domain.z)]
    hi = [float(c[-1]) for c in (domain.x, domain.y, domain.z)]
    ne = domain.analytic["ne"]
    omega = constants.omega_from_lwl(1064e-9)
    rows, cases = {}, {"rk2": 64, "rk4": DIM - 1}
    for integrator, n in cases.items():
        kw = dict(layout=layout_of(domain), axes=(0, 1, 2), bounds=(lo, hi),
                  omega=omega, lwl=1064e-9, p0=lo[2], h=(hi[2] - lo[2]) / n,
                  n_steps=n, integrator=integrator)
        calls = 10 if integrator == "rk2" else 3
        res = {"n_steps": n, "k7_ms": min(batch_ms(lambda: analytic.march(
            u, ne, None, **kw), calls=calls) for _ in range(args.reps)),
            "run_ms": best_ms(lambda: pipeline.run(
                domain, s0, solver="analytic", integrator=integrator,
                n_steps=n, critical_guard=None, bins=BINS), reps=args.reps)}
        ins = out["sass"][integrator]["loop"]["total"]
        res["static_issue_ms"] = here.static_issue_ms(
            ins, RAYS * n, out["sms"], out["sm_clock_mhz"])
        rows[integrator] = analytic.march(u, ne, None, **kw)
        if args.variants:
            res["variants"] = {}
            for name, subs in K7_VARIANTS.items():
                var = variant(analytic.KERNEL, name, subs)
                with kernel_of(analytic, var):
                    got = analytic.march(u, ne, None, **kw)
                    ms = min(batch_ms(lambda: analytic.march(
                        u, ne, None, **kw), calls=calls)
                        for _ in range(args.reps))
                res["variants"][name] = {
                    "ms": ms, "bit_equal": torch.equal(
                        got.view(torch.int32),
                        rows[integrator].view(torch.int32))}
            res["k7_ms_after_variants"] = min(batch_ms(
                lambda: analytic.march(u, ne, None, **kw), calls=calls)
                for _ in range(args.reps))
        out[integrator] = res
    if args.variants:
        for name, subs in K7_VARIANTS.items():
            kv, _, _ = ptxas(Path(variant(analytic.KERNEL, name,
                                          subs).source),
                             analytic.KERNEL.flags)
            out.setdefault("variant_ptxas", {})[name] = {
                n: v for n, v in kv.items()
                if re.search(r"ILi4E.*LayoutILi0ELi0ELi0E", n)}
    _rows_report(out, rows, args)
    print(json.dumps({"part": "analytic", **out}), flush=True)


K17_K = 64            # the mesh path's segment depth (chip_smoke MESH)
K17_SHARDS = 4


def k17_part(args):
    """The ``k17`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch import pipeline
    from synthpy_tpu_torch.fields import ScalarDomain
    from synthpy_tpu_torch.fields.domain import layout_of
    from synthpy_tpu_torch.kernels import march, march_sharded
    from synthpy_tpu_torch.kernels.profiling import (batch_ms, best_ms,
                                                     nvidia_smi)
    from synthpy_tpu_torch.parallel import Mesh, psum
    from synthpy_tpu_torch.tracer import init_beam, zscan

    here = _here_profiling()
    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi(),
           "sm_clock_mhz": here.sm_clock_mhz(),
           "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    patterns = (r"(shards|owned)_kernelILi0E.*LayoutILi0ELi0ELi0E",)
    fold = here.FOLDS["core_rk2_slab"]
    out["sass_core"] = _sass(march_sharded.KERNEL, "sass_rk2_slab", fold,
                             patterns,
                             f"k17_core_{Path(args.root).name}.sass")
    out["sass_k1"] = _sass(march.KERNEL, "sass_rk2_slab", fold,
                           (r"march_kernelILi0E.*LayoutILi0ELi0ELi0E",),
                           f"k1_core_{Path(args.root).name}.sass")
    dom = ScalarDomain(2 * EXT, DIM, device=dev).test_lens(ne_0=5e24,
                                                           LR=1.5e-3)
    lay = layout_of(dom)
    s0 = init_beam(0, RAYS, 2e-3, 0.0, EXT, "circular", device=dev)
    u = zscan.permute_state(s0, "z").contiguous()
    G = K17_SHARDS
    seg_kw = dict(solver="zscan_seg", seg_K=K17_K, integrator="rk2",
                  seg_weights="slab", bins=BINS)
    grid = Mesh((G,), ("grid",), devices=[dev] * G)
    grid_rays = Mesh((2, 2), ("grid", "rays"), devices=[dev] * 4)
    rows = {}
    for tier, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        sp = zscan.build_segment_pack_device(dom, K=K17_K, dtype=dtype)
        na, nb = sp.shape_ab
        naloc = na // G
        kw = dict(shape_ab=sp.shape_ab, origin_ab=sp.origin_ab.tolist(),
                  inv_ab=sp.inv_spacing_ab.tolist(), dp=sp.dp, layout=lay,
                  K=sp.K, integrator="rk2", weights="slab", qbits=sp.qbits)
        table = sp.seg_planes[0].reshape(na, nb, -1)
        order = march.ray_order(u, sp.shape_ab, kw["origin_ab"],
                                kw["inv_ab"])
        halos = [table[((g + 1) % G) * naloc] for g in range(G)]
        if hasattr(march_sharded, "march_shards"):
            shards = [march_sharded.Shard(table[g * naloc:(g + 1) * naloc],
                                          halos[g], g * naloc)
                      for g in range(G)]

            def segment():
                return march_sharded.march_shards(
                    u, shards, None, naloc=naloc, line_shards=G, order=order,
                    **kw)
        else:
            def segment():
                return psum([march_sharded.march_owned(
                    u, table[g * naloc:(g + 1) * naloc], halos[g], None,
                    lo=g * naloc, naloc=naloc, order=order, **kw)
                    for g in range(G)], grid, "grid")[0]
        res = {"segment_ms": min(batch_ms(segment, calls=10)
                                 for _ in range(args.reps)),
               "k1_segment_ms": min(batch_ms(lambda: march.march(
                   u, sp.seg_planes[:1], None, **kw), calls=10)
                   for _ in range(args.reps)),
               # K1's launch alone, in the same precomputed order
               "k1_kernel_segment_ms": min(batch_ms(lambda: march.launch(
                   march.KERNEL, u, sp.seg_planes[:1], None, order, **kw),
                   calls=10) for _ in range(args.reps))}
        march_sharded.KERNEL.launches = 0
        rows[f"{tier}_segment"] = segment()
        res["launches_a_segment"] = march_sharded.KERNEL.launches
        res["static_issue_ms"] = here.static_issue_ms(
            out["sass_core"]["loop"]["total"], RAYS * K17_K, out["sms"],
            out["sm_clock_mhz"])
        for name, m in (("grid4", grid), ("grid2_rays2", grid_rays)):
            sps = zscan.build_segment_pack_device(
                dom, K=K17_K, dtype=dtype, mesh=m, mesh_axis="grid")
            run = lambda: pipeline.run(dom, s0, spack=sps, mesh=m,  # noqa
                                       grid_axis="grid", **seg_kw)
            march_sharded.KERNEL.launches = 0
            rows[f"{tier}_{name}"] = run()
            res[name] = {"ms": best_ms(run, reps=args.reps),
                         "launches": march_sharded.KERNEL.launches}
            del sps
        res["single_device_ms"] = best_ms(lambda: pipeline.run(
            dom, s0, spack=sp, **seg_kw), reps=args.reps)
        out[tier] = res
        del sp, table, halos
        torch.cuda.empty_cache()
    _rows_report(out, rows, args)
    print(json.dumps({"part": "k17", **out}), flush=True)


# K19's instances on the inversion path: the phase layout (C = 4), bf16
K19_PATTERNS = {
    kind: rf"{kind}_kernelIN7layouts6LayoutILi0ELi1ELi0EEE13__nv_bfloat16E"
    for kind in ("forward", "adjoint")}
# the cases: (name, probing axis, C, table dtype); the path's first, then
# its volume along x and y, then the other layouts and table types along z
# (C = 4 float32 is the renderer's default below 256^3)
K19_CASES = (("z", "z", 4, "bf16"), ("x", "x", 4, "bf16"),
             ("y", "y", 4, "bf16"), ("z_f32_C4", "z", 4, "f32"),
             ("z_bf16_C8", "z", 8, "bf16"), ("z_f32_C8", "z", 8, "f32"))


def _k19_sass(kpc, tag: str) -> tuple:
    """The static SASS of K19's path instances (the parent's kernel is one
    slot (forward) or cell (adjoint) a thread, so its whole function is a
    slot's count; the tiled kernel's innermost loops are its staging and
    its compute loop), and the ptxas registers and spills of every
    instance, by kernel, layout switches (inv_brems, phaseshift, B_on)
    and table type."""
    from synthpy_tpu_torch.kernels import _build
    from synthpy_tpu_torch.kernels.profiling import ptxas

    here = _here_profiling()
    kern, _, cubin = ptxas(_build.CSRC / kpc.KERNEL.source, kpc.KERNEL.flags)
    sass = {}
    for kind, short in (("forward", "fwd"), ("adjoint", "adj")):
        mix = here.sass_loop_mix(cubin, K19_PATTERNS[kind],
                                 Path("chiprun_out") / f"k19_{short}_{tag}"
                                 ".sass")
        mix["ptxas"] = kern.get(mix["name"])
        sass[kind] = mix
    regs = {}
    for name, v in kern.items():
        m = re.search(r"(forward|adjoint)_kernelIN7layouts6LayoutILi(\d)ELi"
                      r"(\d)ELi(\d)EEE(f|13__nv_bfloat16)E", name)
        if m:
            regs[f"{m[1]}_{m[2]}{m[3]}{m[4]}_"
                 f"{'f32' if m[5] == 'f' else 'bf16'}"] = v
    return sass, regs


def _k19_domain(dom, probe: str, C: int):
    """The inversion path's domain probed along ``probe`` in the layout of
    C channels (8: Te, Z and B made from a seed on the card)."""
    import copy

    import torch
    d = copy.copy(dom)
    d.probing_direction = probe
    if C == 8:
        g = torch.Generator(device=dom.ne.device).manual_seed(8)
        shape = tuple(dom.ne.shape)
        d.inv_brems = True
        d.external_Te(20.0 + 40.0 * torch.rand(shape, generator=g,
                                               device=dom.ne.device))
        d.external_Z(1.0 + 3.0 * torch.rand(shape, generator=g,
                                            device=dom.ne.device))
        d.external_B(5.0 * torch.randn(shape + (3,), generator=g,
                                       device=dom.ne.device))
    return d


def k19_part(args):
    """The ``k19`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch.kernels import pack_chain as kpc
    from synthpy_tpu_torch.kernels.profiling import batch_ms, nvidia_smi

    here = _here_profiling()
    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi(),
           "sm_clock_mhz": here.sm_clock_mhz(),
           "sms": torch.cuda.get_device_properties(0).multi_processor_count,
           "tiled": hasattr(kpc, "plan")}
    out["sass"], out["ptxas"] = _k19_sass(kpc, Path(args.root).name)
    builds = _k19_builds(kpc) if args.builds and out["tiled"] else {}
    dom, _, theta, volume, _, _ = inversion_inputs(dev)
    ne = volume(torch.nn.functional.softplus(theta))
    gen = torch.Generator(device=dev).manual_seed(19)
    hashes, cases = {}, {}

    def best(fn):
        return min(batch_ms(fn, calls=10) for _ in range(args.reps))

    for case, probe, C, tier in K19_CASES:
        dt = torch.bfloat16 if tier == "bf16" else torch.float32
        spec = kpc.chain_spec(_k19_domain(dom, probe, C), K=INV_K,
                              pack_dtype=dt)
        table = kpc.forward(ne, spec)
        dseg = torch.randn(table.shape, generator=gen, device=dev).to(
            table.dtype)
        dne = kpc.adjoint(ne, dseg, spec)
        res = {"forward_ms": best(lambda: kpc.forward(ne, spec)),
               "adjoint_ms": best(lambda: kpc.adjoint(ne, dseg, spec))}
        if case == "z":
            # the path's case against the plain versions
            want = kpc.seg_planes_plain(ne, spec)
            ref = kpc.seg_planes_vjp_plain(ne, dseg, spec)
            res["forward_bit_equal_plain"] = torch.equal(
                table.view(torch.int16), want.view(torch.int16))
            res["adjoint_rel_l2_plain"] = float(
                (dne - ref).double().norm() / ref.double().norm())
            del want, ref
        if out["tiled"]:
            _, _, na, nb, _ = kpc._dims(spec, ne)
            tb = 2 if tier == "bf16" else 4
            res["plans"] = {}
            for k in ("forward", "adjoint"):
                L = kpc.plan(k, na, nb, INV_K, C, tb)
                res["plans"][k] = {**L._asdict(), "smem": kpc.plan_smem(
                    k, L.TB, L.PB, C, INV_K, tb)}
            if args.variants and case in K19_VARIANTS:
                res["variants"] = _k19_variants(
                    kpc, K19_VARIANTS[case], ne, dseg, spec, best, table,
                    dne)
            if builds:
                res["builds"] = _k19_build_times(kpc, builds, ne, dseg, spec,
                                                 best, table, dne)
        hashes[case] = {
            k: hashlib.sha256(v.cpu().view(torch.int16 if v.dtype ==
                                           torch.bfloat16 else torch.int32)
                              .numpy().tobytes()).hexdigest()
            for k, v in (("table", table), ("dne", dne))}
        cases[case] = res
        del table, dseg, dne, spec
        torch.cuda.empty_cache()
    out["cases"] = cases
    out["sha256"] = hashes
    if args.save:
        Path(args.save).write_text(json.dumps(hashes))
    if args.against:
        ref = json.loads(Path(args.against).read_text())
        out["against"] = {"file": args.against, **{
            c: {k: hashes[c][k] == ref[c][k] for k in hashes[c]}
            for c in hashes if c in ref}}
    print(json.dumps({"part": "k19", **out}), flush=True)


# the plans ``k19 --variants`` times beside the default one, by case:
# cells a tile and rows a run of each kernel on the path's case; on the
# layouts whose slots take 16 or 32 bytes the tiles of both kernels
K19_VARIANTS = {
    "z": {"forward": [{"TB": 15}, {"TB": 31}, {"AR": 8}, {"AR": 32}],
          "adjoint": [{"TB": 8}, {"TB": 32}, {"AR": 8}, {"AR": 32}]},
    **{case: {"forward": [{"TB": 15}, {"TB": 31}],
              "adjoint": [{"TB": 16}, {"TB": 8}, {"TB": 4}]}
       for case in ("z_f32_C4", "z_bf16_C8", "z_f32_C8")}}


# builds of pack_chain.cu that ``k19 --builds`` times beside the shipped
# one in every case: two slots (cells) a trip in every layout, the compute
# loops unrolled by the compiler, both kernels without their register cap,
# and a probe that gives wrong numbers and only says where the time goes:
# the rows staged but not computed
K19_SOURCE_VARIANTS = {
    "pair_all": [("LY::inv_brems || LY::B_on ? 1 : 2;",
                  "LY::inv_brems || LY::B_on ? 2 : 2;")],
    "unrolled": [("#pragma unroll 1\n    for (int i = threadIdx.x; i < n_",
                  "    for (int i = threadIdx.x; i < n_")],
    "regs_free": [("constexpr int MIN_BLOCKS = 4;",
                   "constexpr int MIN_BLOCKS = 1;")],
    "stage_only": [("    compute(a, k & 3,",
                    "    if (false) compute(a, k & 3,")],
}


def _k19_variants(kpc, plans, ne, dseg, spec, best, table, dne):
    """Each of ``plans``' plans (the default plan's TB, PB or AR moved),
    timed with its shared bytes and held bit-equal to the default plan's
    outputs."""
    import torch

    shipped = kpc.plan
    C = spec.layout.n_channels
    tb = 2 if spec.pack_dtype == torch.bfloat16 else 4
    res = {}
    for kind, overs in plans.items():
        for over in overs:
            kpc.plan = lambda k, *a, _o=over, _k=kind: shipped(  # noqa
                k, *a, **(_o if k == _k else {}))
            try:
                L = kpc.plan(kind, *kpc._dims(spec, ne)[2:4], INV_K, C, tb)
                if kind == "forward":
                    fn = lambda: kpc.forward(ne, spec)  # noqa: E731
                    same = torch.equal(fn(), table)
                else:
                    fn = lambda: kpc.adjoint(ne, dseg, spec)  # noqa: E731
                    same = torch.equal(fn().view(torch.int32),
                                       dne.view(torch.int32))
                res[f"{kind}_" + "_".join(f"{k}{v}" for k, v in
                                          over.items())] = {
                    "ms": best(fn), "bit_equal": same, "plan": L._asdict(),
                    "smem": kpc.plan_smem(kind, L.TB, L.PB, C, INV_K, tb)}
            finally:
                kpc.plan = shipped
    return res


def _k19_builds(kpc):
    """``K19_SOURCE_VARIANTS``' builds (all built at once), each with the
    ptxas registers and spills of its instances."""
    from synthpy_tpu_torch.kernels import _build
    from synthpy_tpu_torch.kernels.profiling import ptxas, variant

    builds = {name: variant(kpc.KERNEL, f"k19_{name}", subs)
              for name, subs in K19_SOURCE_VARIANTS.items()}
    _build.build({b.source: b.flags for b in builds.values()})
    out = {}
    for name, b in builds.items():
        kern, _, _ = ptxas(Path(b.source), b.flags)
        out[name] = (b, {k: v for k, v in kern.items()
                         if "_kernelIN7layouts" in k})
    return out


def _k19_build_times(kpc, builds, ne, dseg, spec, best, table, dne):
    """Each build of ``_k19_builds`` on one case: timed, with whether its
    outputs are the shipped kernels' and the registers of the case's
    instances."""
    import torch
    from synthpy_tpu_torch.kernels import _build

    res = {}
    lay = spec.layout
    mangled = (f"LayoutILi{int(lay.inv_brems)}ELi{int(lay.phaseshift)}ELi"
               f"{int(lay.B_on)}EEE" + ("13__nv_bfloat16E" if
                                       spec.pack_dtype == torch.bfloat16
                                       else "fE"))
    shipped = kpc.KERNEL, kpc.BACKWARD_KERNEL
    for name, (b, kern) in builds.items():
        kpc.KERNEL = b
        kpc.BACKWARD_KERNEL = _build.Kernel(
            b.source, shipped[1].functions, b.flags)
        try:
            f = kpc.forward(ne, spec)
            g = kpc.adjoint(ne, dseg, spec)
            res[name] = {
                "forward_ms": best(lambda: kpc.forward(ne, spec)),
                "adjoint_ms": best(lambda: kpc.adjoint(ne, dseg, spec)),
                "forward_bit_equal": torch.equal(f, table),
                "adjoint_bit_equal": torch.equal(g.view(torch.int32),
                                                 dne.view(torch.int32)),
                "ptxas": {("forward" if "forward_kernel" in k else "adjoint"):
                          v for k, v in kern.items() if mangled in k}}
        finally:
            kpc.KERNEL, kpc.BACKWARD_KERNEL = shipped
    return res


# the X-ray path's table and scene (chip_smoke.py XRAY, xray_path)
XRAY_T = (0.0, 3.0, 30)
XRAY_RHO = (-5.0, 1.0, 40)
XRAY_HALF = 2.5e-3
# builds of xray.cu that ``xray --variants`` times beside the shipped one;
# a ``probe_`` build leaves out one part of the lookup (its outputs are not
# the shipped ones): what that part costs
_CAP = "__global__ void __launch_bounds__(THREADS, 3)\n    fold_kernel("
_COPIES = ("      if constexpr (B::A) __pipeline_memcpy_async(sa + at, F.a + e, 4);"
           "\n      if constexpr (B::B) __pipeline_memcpy_async(sb + at, F.b + e,"
           " 4);\n")
_WOUT = "    const bool keep_w = B::A && F.wout != nullptr && pix_ok;"
_CHUNK = "constexpr int CHUNK_PLANES = 8;"
XRAY_VARIANTS = {
    "libm_logf": [("    const float l = log_normal(fmaxf(v, first));",
                   "    const float l = logf(fmaxf(v, first));")],
    "no_cap": [(_CAP, _CAP.replace("(THREADS, 3)", "(THREADS)"))],
    "cap_2_blocks": [(_CAP, _CAP.replace("(THREADS, 3)", "(THREADS, 2)"))],
    "chunk_16": [(_CHUNK, _CHUNK.replace("8", "16"))],
    "probe_no_lookup": [("w = __fmul_rn(kappa<S, REG>(T, te, rho), rho);",
                         "w = __fmul_rn(te, rho);")],
    # the first kernel's NaN-dropping lookup (C.13's repair left out): its
    # query select and saturating clip
    "probe_no_nan": [
        ("    return v < INFINITY ? l : v;",
         "    return v == INFINITY ? v : l;"),
        ("    return max_nan(!(x >= c.y) ? q : 1.0f, 0.0f);",
         "    return clip01(x < c.y ? q : 1.0f);")],
    "probe_compute_only": [(_COPIES, ""),
                           (_WOUT, "    const bool keep_w = false;")],
}
# the survey's instance (mode 0 with em, along b, the table staged) and
# the parent's one kernel
K15_PATTERNS = (r"fold_kernelILi1ELi0ELb1ELb1E", r"11fold_kernelENS")


def _graph_ms():
    """``profiling.graph_ms`` of the tree imported (a parent's may lack it:
    then this script's own copy)."""
    from synthpy_tpu_torch.kernels import profiling
    if hasattr(profiling, "graph_ms"):
        return profiling.graph_ms
    here = _here_profiling()
    return here.graph_ms


def event_ms(kern, fn, calls: int = 20) -> dict:
    """Device time of one launch through ``kern`` (a ``_build.Kernel``),
    from the CUDA events its launches record around themselves on their
    stream, over ``calls`` back-to-back fn() calls: median and least [ms].
    Unlike ``batch_ms`` this leaves out the host's time between launches,
    which passes a kernel's own below ~0.05 ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    kern.events = []
    try:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        t = sorted(a.elapsed_time(b) for a, b in kern.events)
    finally:
        kern.events = None
    return {"median": t[len(t) // 2], "min": t[0]}


def _sha(t) -> str:
    import torch
    if t is None:
        return None
    t = t.detach().cpu().contiguous()
    if t.dtype in (torch.float32, torch.int32):
        t = t.view(torch.int32)
    elif t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _save_against(out: dict, hashes: dict, args) -> None:
    out["sha256"] = hashes
    if args.save:
        Path(args.save).write_text(json.dumps(hashes))
    if args.against:
        ref = json.loads(Path(args.against).read_text())
        # a case's hash, or its hashes by name
        out["against"] = {"file": args.against, **{
            c: hashes[c] == ref[c] if isinstance(hashes[c], str) else
            {k: hashes[c][k] == ref[c].get(k) for k in hashes[c]}
            for c in hashes if c in ref}}
        out["against"]["all_bit_equal"] = all(
            v for c in hashes if c in ref
            for v in ([out["against"][c]] if isinstance(hashes[c], str)
                      else out["against"][c].values()))


def _xray_scene(res: int, dev):
    """(rho, Te) (res, res, res) float32 on ``dev``: the shell and core of
    examples/xray_radiography.py over the (x, z) plane with a seeded
    ripple, broadcast along y."""
    import numpy as np
    import torch
    ax = np.linspace(-XRAY_HALF, XRAY_HALF, res).astype(np.float32)
    X2, Z2 = np.meshgrid(ax, ax, indexing="ij")
    r = np.sqrt(X2**2 + Z2**2)
    ripple = np.random.default_rng(7).standard_normal((res, res))
    r0 = 1.4e-3 * (1.0 + 0.012 * ripple)
    shell = np.exp(-((r - r0) / 2.5e-4) ** 2)
    core = np.exp(-(r / 8e-4) ** 2)
    rho2 = torch.from_numpy((0.5 * shell + 1e-2 * core).astype(np.float32))
    te2 = torch.from_numpy((15.0 + 485.0 * core).astype(np.float32))
    return [m.to(dev)[:, None, :].expand(res, res, res).contiguous()
            for m in (rho2, te2)], ax


def _fold_ptxas(kx, tag: str) -> tuple:
    """ptxas reports of every fold instance, and the static SASS of the
    survey's (its whole function, innermost loops, and the opcodes of its
    largest loop; written to chiprun_out/k15_<tag>.sass)."""
    from synthpy_tpu_torch.kernels import _build
    from synthpy_tpu_torch.kernels.profiling import ptxas
    kern, _, cubin = ptxas(_build.CSRC / kx.FOLD_KERNEL.source,
                           kx.FOLD_KERNEL.flags)
    dump = Path("chiprun_out") / f"k15_{tag}.sass"
    here = _here_profiling()
    for pattern in K15_PATTERNS:
        try:
            mix = here.sass_loop_mix(cubin, pattern, dump)
            break
        except RuntimeError:
            continue
    sass = {"name": mix["name"], "kernel": mix["kernel"],
            "loop": mix["loop"], "inner": mix["inner"],
            "loop_opcodes": _opcodes(dump)}
    return {k: v for k, v in kern.items() if "fold_kernel" in k}, sass


def xray_part(args):
    """The ``xray`` part (see the module's docstring)."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch.kernels import xray as kx
    from synthpy_tpu_torch.kernels.profiling import batch_ms, nvidia_smi
    from synthpy_tpu_torch.optics import xray

    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi(),
           "guided": hasattr(kx, "make_table")}
    out["ptxas"], out["sass"] = _fold_ptxas(kx, Path(args.root).name)
    Tg = np.logspace(*XRAY_T)
    rg = np.logspace(*XRAY_RHO)
    kfn = xray.make_opacity_lookup(Tg, rg, 5e3 * np.outer(Tg**-1.5,
                                                          rg**0.5),
                                   device=dev)
    T2, r2 = np.logspace(0, 3, 120), np.logspace(-5, 1, 130)
    big = xray.make_opacity_lookup(T2, r2, 5e3 * np.outer(T2**-1.5,
                                                          r2**0.5),
                                   device=dev)

    def best(fn):
        return min(batch_ms(fn, calls=10) for _ in range(args.reps))

    cases, hashes = {}, {}

    def fold_case(name, a, b, mode, table, tau, em, wout, w0, wlast):
        def call():
            kx.fold(a, b, mode=mode, table=table, w0=w0, wlast=wlast,
                    tau=tau, em=em, wout=wout)
        for t in (tau, em):
            if t is not None:
                t.zero_()
        call()
        torch.cuda.synchronize()
        hashes[name] = {k: _sha(v) for k, v in (("tau", tau), ("em", em),
                                                ("w", wout))
                        if v is not None}
        keep = [None if t is None else t.clone() for t in (tau, em)]
        cases[name] = {"ms": best(call),
                       "device_ms": event_ms(kx.FOLD_KERNEL, call, calls=10),
                       "shape": list(a.shape if a is not None
                                     else b.shape)}
        for t, k in zip((tau, em), keep):
            if t is not None:
                t.copy_(k)
        emit({"case": name, **cases[name]})

    # the survey's batch: planes 480-511 of the 1024^3 scene along y
    (rho, te), ax_s = _xray_scene(1024, dev)
    rb = rho.movedim(1, 0)[480:512].contiguous()
    tb = te.movedim(1, 0)[480:512].contiguous()
    del rho, te
    torch.cuda.empty_cache()
    f32 = dict(dtype=torch.float32, device=dev)
    img = [torch.zeros(rb.shape[1:], **f32) for _ in range(2)]
    wout = torch.empty(rb.shape, **f32)
    fold_case("survey", rb, tb, 0, kfn.table(dev), img[0], img[1], wout,
              False, False)
    fold_case("survey_large_table", rb, tb, 0, big.table(dev), img[0],
              img[1], wout, False, False)
    w_pl = kfn(tb, rb) * rb
    t2 = tb * tb
    j_pl = w_pl * (t2 * t2)
    fold_case("survey_mode1", w_pl, j_pl, 1, None, img[0], img[1], None,
              False, False)
    fold_case("survey_tau_only", rb, tb, 0, kfn.table(dev), img[0], None,
              None, False, False)
    if args.variants:
        cases["variants"] = _xray_variants(kx, rb, tb, kfn.table(dev), img,
                                           wout, best, hashes["survey"])
    _nan_te_case(kx, rb, tb, kfn.table(dev), cases, hashes)
    _pp_fold_cases(kx, xray, ax_s, rb, tb, kfn.table(dev), best, cases,
                   hashes)
    del rb, tb, w_pl, j_pl, t2, img, wout
    torch.cuda.empty_cache()

    # every float32 Te in [1, 2000] (rho 0.01) and every rho in [1e-5, 10]
    # (Te 50), 16 planes of one row, w kept: their logs, cells and
    # fractions against the other tree's
    for name, lo, hi, fixed in (("sweep_te", 1.0, 2000.0, 0.01),
                                ("sweep_rho", 1e-5, 10.0, 50.0)):
        bits = torch.arange(*(int(np.float32(v).view(np.int32))
                              for v in (lo, hi)), dtype=torch.int32,
                            device=dev)
        n = bits.numel() // 16 * 16
        sweep = bits[:n].view(torch.float32).view(16, 1, n // 16)
        other = torch.full_like(sweep, fixed)
        r, t = (other, sweep) if name == "sweep_te" else (sweep, other)
        tau = torch.zeros((1, n // 16), **f32)
        w = torch.empty_like(sweep)
        fold_case(name, r, t, 0, kfn.table(dev), tau, None, w, True, True)
        del bits, sweep, other, r, t, tau, w
        torch.cuda.empty_cache()

    # the dense route: tau over the whole volume, along x, y and z; at
    # 256^3 (the dense images' size) the chords too
    for res in (256, 512):
        (rho, te), ax_d = _xray_scene(res, dev)
        for p_ax, name in enumerate("xyz"):
            r, t = rho.movedim(p_ax, 0), te.movedim(p_ax, 0)
            tau = torch.zeros(r.shape[1:], **f32)
            fold_case(f"dense_{res}_{name}", r, t, 0, kfn.table(dev), tau,
                      None, None, True, True)
        if res == 256:
            _chords_cases(kx, xray, ax_d, rho, te, kfn.table(dev), best,
                          cases, hashes, args.variants)
        del rho, te
        torch.cuda.empty_cache()

    # the 1024^3 survey (tau, emission, point projection) from host and
    # from device volumes, best of 2 (s)
    (rho, te), ax = _xray_scene(1024, dev)
    pp_kw = dict(source_distance=8e-3, detector_distance=80e-3,
                 bins=(431, 321), Lx=90.0, Ly=67.0, probing_direction="y")
    jfn = xray.grey_emissivity(kfn)
    surveys = {}
    for where in ("device", "host"):
        if where == "host":
            rho, te = rho.cpu(), te.cpu()
            torch.cuda.empty_cache()
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs = xray.xray_survey_streamed(
                rho, te, kfn, [ax] * 3, emiss_fn=jfn, plane_batch=32,
                device=dev, **pp_kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        surveys[f"survey_{where}_s"] = min(times)
        hashes[f"survey_{where}"] = {k: _sha(v) for k, v in imgs.items()}
    emit(surveys)
    out["cases"] = cases
    out.update(surveys)
    _save_against(out, hashes, args)
    print(json.dumps({"part": "xray", **out}), flush=True)


def _masked_sha(t, nan):
    """SHA-256 of ``t`` with the elements where ``nan`` holds set to 0: two
    trees' outputs compared away from the NaN a NaN Te gives (C.13)."""
    import torch
    return _sha(torch.where(nan, torch.zeros_like(t), t))


def _nan_te_case(kx, rb, tb, tab, cases, hashes):
    """K15 on the survey batch with NaN Te planted at 64 seeded voxels:
    tau, em and w NaN at the elements where ``fold_plain``'s are
    (``nan_as_plain``; the first kernel took the table's first node), and
    the rest hashed for the other tree."""
    import numpy as np
    import torch
    dev = rb.device
    idx = torch.from_numpy(np.random.default_rng(13).choice(
        tb.numel(), 64, replace=False)).to(dev)
    t_nan = tb.clone()
    t_nan.view(-1)[idx] = float("nan")
    outs = {}
    for name, fn in (("kernel", kx.fold), ("plain", kx.fold_plain)):
        o = [torch.zeros(rb.shape[1:], device=dev) for _ in range(2)]
        w = torch.empty(rb.shape, device=dev)
        fn(rb, t_nan, mode=0, table=tab, w0=False, wlast=False, tau=o[0],
           em=o[1], wout=w)
        outs[name] = dict(zip(("tau", "em", "w"), (*o, w)))
    torch.cuda.synchronize()
    plain = outs["plain"]
    cases["survey_nan_te"] = {
        "nan_as_plain": {k: bool(torch.equal(v.isnan(), plain[k].isnan()))
                         for k, v in outs["kernel"].items()},
        "nan_elements": {k: int(v.isnan().sum()) for k, v in plain.items()}}
    hashes["survey_nan_te"] = {k: _masked_sha(v, plain[k].isnan())
                               for k, v in outs["kernel"].items()}
    emit({"case": "survey_nan_te", **cases["survey_nan_te"]})


# builds of xray.cu with other lanes a chord or sample-loop unrolls that
# ``xray --variants`` times
_LANES = "constexpr int CHORD_LANES = 2;"
_UNROLL = ("#pragma unroll 2\n"
           "  for (int k0 = 0; k0 <= last; k0 += LANES) {")
CHORDS_BUILD_VARIANTS = {
    "chord_lanes_1": [(_LANES, _LANES.replace("2", "1"))],
    "chord_lanes_4": [(_LANES, _LANES.replace("2", "4"))],
    "chord_unroll_1": [(_UNROLL, _UNROLL.replace("unroll 2", "unroll 1"))],
    "chord_unroll_4": [(_UNROLL, _UNROLL.replace("unroll 2", "unroll 4"))],
}


def _pp_fold_cases(kx, xray, ax, rb, tb, tab, best, cases, hashes):
    """K16's crossings of the survey batch (planes 480-511 of the 1024^3
    scene, the survey's 431 x 321 detector): w from K15, then ``pp_fold``;
    ms, the w nodes its crossings read (the bytes bound) and the 32-byte
    sectors they lie in, and a SHA-256 of tau."""
    import numpy as np
    import torch
    graph_ms = _graph_ms()
    dev = rb.device
    w = torch.empty(rb.shape, device=dev)
    kx.fold(rb, tb, mode=0, table=tab, w0=False, wlast=False, tau=None,
            em=None, wout=w)
    frame = xray._pp_frame([ax] * 3, 1, 0, 2, 8e-3, 80e-3, (431, 321), 90.0,
                           67.0)
    da, db = (torch.from_numpy(np.asarray(v, np.float32)).to(dev)
              for v in frame[:2])
    fr = torch.from_numpy(frame[3][480:512].astype(np.float32)).to(dev)
    wt = torch.from_numpy(np.asarray(frame[4][480:512])).to(dev)
    pargs = (da, db, fr, wt, float(frame[5]), float(frame[6]),
             float(np.float32(frame[7])), float(np.float32(frame[8])))
    tau = torch.zeros(da.shape[0], device=dev)
    kx.pp_fold(w, *pargs, tau)
    torch.cuda.synchronize()
    hashes["pp_fold"] = {"tau": _sha(tau)}
    c = {"ms": best(lambda: kx.pp_fold(w, *pargs, tau)),
         "graph_ms": graph_ms(lambda: kx.pp_fold(w, *pargs, tau)),
         "pixels": int(da.shape[0]), "planes": 32}
    # the w nodes the crossings read, each counted once, and the 32-byte
    # sectors they lie in: what the card moves to read them, crossings a
    # few nodes apart in the survey's geometry
    pb, na, nb = w.shape
    qa = (da[None] * fr[:, None] + pargs[4]) * pargs[6]
    qb = (db[None] * fr[:, None] + pargs[5]) * pargs[7]
    ins = (qa >= 0) & (qa <= na - 1) & (qb >= 0) & (qb <= nb - 1)
    ia = qa.floor().clamp(0, na - 2).long()
    ib = qb.floor().clamp(0, nb - 2).long()
    base = (torch.arange(pb, device=dev)[:, None] * (na * nb)
            + ia * nb + ib)[ins]
    corners = torch.cat([base, base + 1, base + nb, base + nb + 1])
    c["w_nodes"] = int(torch.unique(corners).numel())
    c["w_sectors"] = int(torch.unique(corners // 8).numel())
    c["bound_ms"] = (c["w_nodes"] * 4 + 4 * da.numel() * 4) / 3.35e12 * 1e3
    c["sector_bytes_ms"] = (c["w_sectors"] * 32 + 4 * da.numel() * 4
                            ) / 3.35e12 * 1e3
    cases["pp_fold"] = c
    emit({"case": "pp_fold", **c})


def _chords_cases(kx, xray, ax, rho, te, tab, best, cases, hashes,
                  variants=False):
    """K16's chord sampler on the 256^3 scene with the survey's geometry
    (431 x 321 pixels, 160 samples a chord): mode 0 probing along x, y and
    z, mode 1 along y (ms, SHA-256s), and along y with NaN Te planted at
    64 seeded voxels (NaN depth at the chords ``pp_chords_plain`` gives
    it, the rest hashed)."""
    import numpy as np
    import torch
    graph_ms = _graph_ms()
    for probe in "xyz":
        g = xray.chord_geometry([ax] * 3, 8e-3, 80e-3, (431, 321), 90.0,
                                67.0, probe)
        # the pixel offsets on the card: a graph captures no host copy
        g = g._replace(xa=g.xa.to(rho.device), xb=g.xb.to(rho.device))
        tau = kx.pp_chords(rho, te, g, 160, 0, tab)
        torch.cuda.synchronize()
        hashes[f"chords_{probe}"] = {"tau": _sha(tau)}
        cases[f"chords_{probe}"] = {
            "ms": best(lambda: kx.pp_chords(rho, te, g, 160, 0, tab)),
            "graph_ms": graph_ms(
                lambda: kx.pp_chords(rho, te, g, 160, 0, tab), calls=5)}
        emit({"case": f"chords_{probe}", **cases[f"chords_{probe}"]})
    g = xray.chord_geometry([ax] * 3, 8e-3, 80e-3, (431, 321), 90.0, 67.0,
                            "y")
    g = g._replace(xa=g.xa.to(rho.device), xb=g.xb.to(rho.device))
    smp = kx.pp_chords(rho, te, g, 160, 1)
    hashes["chords_y_mode1"] = {k: _sha(v) for k, v in zip(
        ("rho_s", "te_s", "path"), smp)}
    cases["chords_y_mode1"] = {
        "ms": best(lambda: kx.pp_chords(rho, te, g, 160, 1))}
    del smp
    if variants:
        res = {}
        from synthpy_tpu_torch.kernels import _build, profiling
        kern = kx.PP_CHORDS_KERNEL
        builds = {n: profiling.variant(kern, f"k16_{n}", subs)
                  for n, subs in CHORDS_BUILD_VARIANTS.items()}
        _build.build({v.source: v.flags for v in builds.values()})
        for name, v in builds.items():
            kx.PP_CHORDS_KERNEL = v
            try:
                tau = kx.pp_chords(rho, te, g, 160, 0, tab)
                smp = kx.pp_chords(rho, te, g, 160, 1)
                torch.cuda.synchronize()
                res[name] = {
                    "ms": best(lambda: kx.pp_chords(rho, te, g, 160, 0,
                                                    tab)),
                    "graph_ms": graph_ms(
                        lambda: kx.pp_chords(rho, te, g, 160, 0, tab),
                        calls=5),
                    "bit_equal": _sha(tau) == hashes["chords_y"]["tau"]
                    and all(_sha(a) == hashes["chords_y_mode1"][k]
                            for k, a in zip(("rho_s", "te_s", "path"),
                                            smp))}
                del smp
            finally:
                kx.PP_CHORDS_KERNEL = kern
            emit({"variant": name, **res[name]})
        cases["chords_variants"] = res
    idx = torch.from_numpy(np.random.default_rng(14).choice(
        te.numel(), 64, replace=False)).to(te.device)
    t_nan = te.clone()
    t_nan.view(-1)[idx] = float("nan")
    got = kx.pp_chords(rho, t_nan, g, 160, 0, tab)
    want = kx.pp_chords_plain(rho, t_nan, g, 160, 0, tab)
    cases["chords_nan_te"] = {
        "nan_as_plain": bool(torch.equal(got.isnan(), want.isnan())),
        "nan_chords": int(want.isnan().sum())}
    hashes["chords_nan_te"] = {"tau": _masked_sha(got, want.isnan())}
    emit({"case": "chords_nan_te", **cases["chords_nan_te"]})


def _xray_variants(kx, rb, tb, tab, img, wout, best, want):
    import concurrent.futures as cf

    import torch
    from synthpy_tpu_torch.kernels import _build, profiling
    from synthpy_tpu_torch.kernels.profiling import ptxas
    shipped = kx.FOLD_KERNEL
    builds = {name: profiling.variant(shipped, f"k15_{name}", subs)
              for name, subs in XRAY_VARIANTS.items()}
    # every build at once, and their ptxas reports beside them
    with cf.ThreadPoolExecutor(len(builds)) as pool:
        reports = {n: pool.submit(ptxas, Path(v.source), v.flags)
                   for n, v in builds.items()}
        _build.build({v.source: v.flags for v in builds.values()})
        reports = {n: f.result()[0] for n, f in reports.items()}
    res = {}
    for name, v in builds.items():
        kx.FOLD_KERNEL = v
        try:
            def call():
                kx.fold(rb, tb, mode=0, table=tab, w0=False, wlast=False,
                        tau=img[0], em=img[1], wout=wout)
            for t in img:
                t.zero_()
            call()
            torch.cuda.synchronize()
            same = (_sha(img[0]) == want["tau"] and _sha(img[1]) == want["em"]
                    and _sha(wout) == want["w"])
            res[name] = {"ms": best(call), "bit_equal": same,
                         "ptxas": {k: r for k, r in reports[name].items()
                                   if re.search(K15_PATTERNS[0], k)}}
        finally:
            kx.FOLD_KERNEL = shipped
        emit({"variant": name, **res[name]})
    return res


def cic_part(args):
    """The ``cic`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch.inverse import make_renderer
    from synthpy_tpu_torch.kernels import _build, cic
    from synthpy_tpu_torch.kernels.profiling import (batch_ms, kernel_ms,
                                                     nvidia_smi, ptxas)
    graph_ms = _graph_ms()

    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi(),
           "planned": hasattr(cic, "grid")}
    kern, _, cubin = ptxas(_build.CSRC / cic.KERNEL.source,
                           cic.KERNEL.flags)
    out["ptxas"] = {k: v for k, v in kern.items() if "cic" in k}
    # the opcodes of the forward's loop over rays, each form and V
    out["sass"] = {}
    here = _here_profiling()
    for V in (1, 4):
        for pat in (rf"cic_forward_sharedILi{V}E", rf"cic_forwardILi{V}E"):
            dump = Path("chiprun_out") / f"cic_{Path(args.root).name}_{V}.sass"
            try:
                here.sass_loop_mix(cubin, pat, dump)
            except RuntimeError:
                continue
            out["sass"][pat] = _opcodes(dump)

    # the path's exit rays and values: one render of each renderer of
    # inverse_path, its deposits recorded (cic.RECORD)
    dom, s0, theta, volume, _, _ = inversion_inputs(dev)
    kw = dict(bins=INV_BINS, K=INV_K, Lx=INV_LXY, Ly=INV_LXY,
              pack_dtype=torch.bfloat16,
              bench_kwargs={"schlieren_df": {"stop_R": INV_STOP_R}})
    inputs = {}
    cic.RECORD = []
    try:
        with torch.no_grad():
            for diag in (("shadowgraphy", "schlieren_df", "interferometry"),
                         ("shadowgraphy", "schlieren_df", "phase_map")):
                render = make_renderer(dom, s0, diagnostic=diag,
                                       n_fringes=16.0, **kw)
                render(volume(torch.nn.functional.softplus(theta)))
        for r in cic.RECORD:
            if r[0] == "deposit":
                inputs.setdefault(r[3].shape[1], r[1:])
    finally:
        cic.RECORD = None
    del dom, s0, theta, render
    torch.cuda.empty_cache()

    def best(fn):
        return min(batch_ms(fn, calls=20) for _ in range(args.reps))

    gen = torch.Generator(device=dev).manual_seed(12)
    cases, hashes = {}, {}
    for V in (1, 2, 4):
        x, y, vals, bins, lx, ly = inputs[V]
        N = x.shape[0]
        dacc = torch.randn(tuple(bins) + (V,), generator=gen, device=dev)
        acc = cic.deposit(x, y, vals, bins, lx, ly)
        ref = cic.cic_plain(x, y, vals, bins, lx, ly)
        grads = cic.adjoint(x, y, vals, dacc, bins, lx, ly)
        torch.cuda.synchronize()
        c = {"rays": N, "bins": list(bins),
             "forward_ms": best(lambda: cic.deposit(x, y, vals, bins, lx,
                                                    ly)),
             "adjoint_ms": best(lambda: cic.adjoint(x, y, vals, dacc, bins,
                                                    lx, ly)),
             "forward_graph_ms": graph_ms(lambda: cic.deposit(
                 x, y, vals, bins, lx, ly)),
             "adjoint_graph_ms": graph_ms(lambda: cic.adjoint(
                 x, y, vals, dacc, bins, lx, ly)),
             "forward_kernels_ms": kernel_ms(
                 lambda: cic.deposit(x, y, vals, bins, lx, ly),
                 Path("chiprun_out") / f"cic_V{V}_trace.json"),
             "forward_rel_err": float((acc - ref).abs().max())
             / float(ref.abs().max()),
             # the image's largest run-to-run spread over 5 launches
             "forward_repeat_max_abs": max(
                 float((cic.deposit(x, y, vals, bins, lx, ly) - acc).abs()
                       .max()) for _ in range(5))}
        nxy = bins[0] * bins[1]
        if out["planned"]:
            gf = cic.grid("forward", bins, V, N, dev)
            c["plan"] = {"forward": gf,
                         "adjoint": cic.grid("adjoint", bins, V, N, dev),
                         "partials": gf,
                         "shared_bytes": cic.pitch(bins, V) * 4}
            part = gf * cic.pitch(bins, V) * 4
        else:
            part = 0
        # bytes: each ray's position and values read once, the image
        # written once (the function's need), and beside it the design's
        # count, with its partial images written and read
        c["forward_bound_ms"] = (N * (8 + 4 * V)
                                 + nxy * V * 4) / 3.35e12 * 1e3
        c["forward_bound_design_ms"] = (N * (8 + 4 * V) + nxy * V * 4
                                        + 2 * part) / 3.35e12 * 1e3
        c["adjoint_bound_ms"] = (2 * N * (8 + 4 * V)
                                 + nxy * V * 4) / 3.35e12 * 1e3
        cases[f"V{V}"] = c
        hashes[f"V{V}"] = {"dx": _sha(grads[0]), "dy": _sha(grads[1]),
                           "dvals": _sha(grads[2])}
        emit({"case": f"V{V}", **c})
    # the large-image form: the path's rays onto 431 x 321 pixels at V = 4
    x, y, vals, _, lx, ly = inputs[4]
    big = (431, 321)
    dacc = torch.randn(big + (4,), generator=gen, device=dev)
    grads = cic.adjoint(x, y, vals, dacc, big, lx, ly)
    cases["V4_431x321"] = {
        "forward_graph_ms": graph_ms(lambda: cic.deposit(x, y, vals, big, lx,
                                                         ly)),
        "adjoint_graph_ms": graph_ms(lambda: cic.adjoint(x, y, vals, dacc,
                                                         big, lx, ly)),
        "forward_ms": best(lambda: cic.deposit(x, y, vals, big, lx, ly)),
        "adjoint_ms": best(lambda: cic.adjoint(x, y, vals, dacc, big, lx,
                                               ly))}
    hashes["V4_431x321"] = {"dx": _sha(grads[0]), "dy": _sha(grads[1]),
                            "dvals": _sha(grads[2])}
    emit({"case": "V4_431x321", **cases["V4_431x321"]})
    out["cases"] = cases
    _save_against(out, hashes, args)
    print(json.dumps({"part": "cic", **out}), flush=True)


# builds of btable.cu that ``btable --variants`` times beside the shipped one
BTABLE_VARIANTS = {
    "group_24": [("constexpr int GROUP = 12;", "constexpr int GROUP = 24;")],
    "cap_4_blocks": [("__global__ void __launch_bounds__(THREADS)\n"
                      "    to_int8(", "__global__ void __launch_bounds__("
                      "THREADS, 4)\n    to_int8(")],
}


def _opcodes(dump: Path) -> dict:
    """Opcode counts of the largest loop of a SASS dump (one function; the
    whole function where it has no loop)."""
    from synthpy_tpu_torch.kernels.profiling import _SASS_LINE
    code = []
    for line in dump.read_text().splitlines():
        m = _SASS_LINE.search(line)
        if m and m.group(2) != "NOP":
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    best_span = []
    for addr, op, rest in code:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            start = int(m.group(1), 16)
            span = [o for a, o, _ in code if start <= a <= addr]
            if len(span) > len(best_span):
                best_span = span
    counts = {}
    for op in best_span or [o for _, o, _ in code]:
        counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def btable_part(args):
    """The ``btable`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch import random as jrandom
    from synthpy_tpu_torch.kernels import _build, btable
    from synthpy_tpu_torch.kernels.profiling import batch_ms, nvidia_smi, ptxas

    here = _here_profiling()
    dev = torch.device("cuda")
    kern, _, cubin = ptxas(_build.CSRC / btable.KERNEL.source,
                           btable.KERNEL.flags)
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi(),
           "ptxas": kern}
    dump = Path("chiprun_out") / f"k14_int8_{Path(args.root).name}.sass"
    mix = here.sass_loop_mix(cubin, r"to_int8ILb1E(?:Lb1E)?E", dump)
    out["sass"] = {"name": mix["name"], "kernel": mix["kernel"],
                   "loop": mix["loop"], "loop_opcodes": _opcodes(dump)}

    def best(fn):
        return min(batch_ms(fn, calls=20) for _ in range(args.reps))

    gen = torch.Generator(device=dev).manual_seed(14)
    pb, n = 32, 1024
    batch = 10.0 * torch.randn((pb, n, n, 3), generator=gen, device=dev)
    scale = (batch.abs().amax(dim=(0, 1, 2)) / 127.0).contiguous()
    key = jrandom.key_data(jrandom.fold_in(jrandom.PRNGKey(5), 32))
    cases, hashes = {}, {}
    for name, dt, k in (("int8_dither", torch.int8, key),
                        ("int8", torch.int8, None),
                        ("bf16", torch.bfloat16, None)):
        tab = torch.zeros((2 * pb, n, n, 3), dtype=dt, device=dev)

        def call():
            btable.write(tab, batch, pb, scale, k)
        call()
        torch.cuda.synchronize()
        hashes[name] = {"codes": _sha(tab[pb:])}
        cases[name] = {"ms": best(call)}
        if dt == torch.int8:
            # the table one byte past a 4-byte boundary
            buf = torch.zeros(batch.numel() + 16, dtype=dt, device=dev)
            off = buf[1:1 + batch.numel()].view(batch.shape)

            def call_off():
                btable.write(off, batch, 0, scale, k)
            call_off()
            torch.cuda.synchronize()
            cases[name]["off_by_1_ms"] = best(call_off)
            cases[name]["off_by_1_equal"] = torch.equal(off, tab[pb:])
            # a 3-plane batch at every destination offset 0-15 mod 16
            small = batch[:3]
            for o in range(16):
                dst = buf[o:o + small.numel()].view(small.shape)
                btable.write(dst, small, 0, scale, k)
                hashes[name][f"offset_{o}"] = _sha(dst)
            del buf, off
        emit({"case": name, **cases[name]})
        del tab
        torch.cuda.empty_cache()
    if args.variants:
        cases["variants"] = _btable_variants(btable, batch, scale, key, best,
                                             hashes["int8_dither"]["codes"])
    out["cases"] = cases
    _save_against(out, hashes, args)
    print(json.dumps({"part": "btable", **out}), flush=True)


def _btable_variants(btable, batch, scale, key, best, want):
    import torch
    from synthpy_tpu_torch.kernels import profiling
    from synthpy_tpu_torch.kernels.profiling import ptxas
    res = {}
    for name, subs in BTABLE_VARIANTS.items():
        v = profiling.variant(btable.KERNEL, f"k14_{name}", subs)
        kern, _, _ = ptxas(Path(v.source), v.flags)
        tab = torch.zeros(batch.shape, dtype=torch.int8, device=batch.device)
        with profiling.kernel_of(btable, v):
            def call():
                btable.write(tab, batch, 0, scale, key)
            call()
            torch.cuda.synchronize()
            res[name] = {"ms": best(call), "bit_equal": _sha(tab) == want,
                         "ptxas": {k: v for k, v in kern.items()
                                   if "to_int8" in k}}
        emit({"variant": name, **res[name]})
    return res


# -- K10 (threefry draws) and K8 (the Fresnel deposit) ------------------------

# the SASS opcodes by the pipe that issues them on sm_90 (the CUDA C++
# programming guide's throughput table: 64 INT32 lanes an SM take the
# integer adds, logic, shifts, compares, selects and float min / max; 128
# FMA lanes the float adds and products and the integer multiply-adds)
PIPES = {
    "int32": ("IADD3", "LOP3", "SHF", "LEA", "ISETP", "IMNMX", "SEL", "PRMT",
              "FLO", "POPC", "BMSK", "IABS", "FSEL", "FMNMX", "FSETP",
              "SHL", "SHR", "LOP", "IADD", "VOTE", "PLOP3"),
    "fma": ("FFMA", "FMUL", "FADD", "IMAD", "IMUL", "FSWZADD"),
    "mufu": ("MUFU",),
}


def _pipes(opcodes: dict) -> dict:
    """``opcodes`` ({root: count}) summed by ``PIPES`` (the rest as
    ``other``), with the total."""
    out = {k: 0 for k in PIPES}
    out["other"] = 0
    for op, n in opcodes.items():
        pipe = next((k for k, ops in PIPES.items() if op in ops), "other")
        out[pipe] += n
    out["total"] = sum(opcodes.values())
    return out


def _sass_functions(cubin: Path, tag: str, keep) -> dict:
    """Every kernel of ``cubin`` whose name ``keep`` accepts: its whole
    SASS and each innermost loop as opcode counts (roots before the first
    '.', NOPs left out) and by pipe (``PIPES``). A static count."""
    import subprocess
    from synthpy_tpu_torch.kernels import _build
    from synthpy_tpu_torch.kernels.profiling import _SASS_LINE

    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(cubin)],
                          capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if keep(m.group(1)) else None
            if name:
                funcs[name] = []
            continue
        m = _SASS_LINE.search(line) if name else None
        if m and m.group(2) != "NOP":
            funcs[name].append((int(m.group(1), 16), m.group(2),
                                m.group(3)))
    dump = Path("chiprun_out") / f"sass_{tag}.txt"
    dump.parent.mkdir(parents=True, exist_ok=True)
    dump.write_text(sass)

    def count(ops):
        c = {}
        for op in ops:
            c[op] = c.get(op, 0) + 1
        return dict(sorted(c.items(), key=lambda kv: -kv[1]))

    out = {}
    for name, code in funcs.items():
        spans = []
        for addr, op, rest in code:
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and m and int(m.group(1), 16) < addr:
                spans.append((int(m.group(1), 16), addr))
        inner = [(lo, hi) for lo, hi in spans
                 if not any((a, b) != (lo, hi) and lo <= a and b <= hi
                            for a, b in spans)]
        whole = count(o for _, o, _ in code)
        loops = []
        for lo, hi in sorted(inner):
            ops = count(o for a, o, _ in code if lo <= a <= hi)
            loops.append({"opcodes": ops, "pipes": _pipes(ops)})
        out[name] = {"opcodes": whole, "pipes": _pipes(whole),
                     "inner_loops": loops}
    return out


# builds of random.cu that ``random --variants`` times beside the shipped
# one: each rotate as a 64-bit product by 2^r from constant memory (its two
# words or-ed: the rotate's bits on the FMA pipe, one LOP3 for the or and
# the xor), and half the blocks an SM
_ROT = ("      x1 = threefry::rotl(x1, rot[g & 1][r]);\n"
        "      x1 ^= x0;")
_PAIR_LOOP = """#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      a[k] = value<NORMAL>(bits_at<WIDE>(A, offset, i + k), 0.0f, 0.0f);
      b[k] = value<NORMAL>(bits_at<WIDE>(B, offset, i + k), 0.0f, 0.0f);
    }"""
_PAIR_LOOPS = """#pragma unroll
    for (int k = 0; k < VEC; ++k)
      a[k] = value<NORMAL>(bits_at<WIDE>(A, offset, i + k), 0.0f, 0.0f);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      b[k] = value<NORMAL>(bits_at<WIDE>(B, offset, i + k), 0.0f, 0.0f);"""

RANDOM_VARIANTS = {
    "rotate_by_product": [
        ("// threefry::hash's 20 rounds and injections",
         "__constant__ uint32_t ROTATE_MUL[2][4] = {\n"
         "    {1u << 13, 1u << 15, 1u << 26, 1u << 6},\n"
         "    {1u << 17, 1u << 29, 1u << 16, 1u << 24}};\n\n"
         "// threefry::hash's 20 rounds and injections"),
        (_ROT, "      {\n        const unsigned long long p_ =\n"
               "            (unsigned long long)x1 * ROTATE_MUL[g & 1][r];\n"
               "        x1 = ((uint32_t)p_ | (uint32_t)(p_ >> 32)) ^ x0;\n"
               "      }")],
    "blocks_8": [("constexpr int BLOCKS_PER_SM = 16;",
                  "constexpr int BLOCKS_PER_SM = 8;")],
    # the GRF's pair kernel: no register cap from the bounds; the two
    # streams' four draws in two loops
    "pair_bounds_1": [("__global__ void __launch_bounds__(THREADS)\n"
                       "    draw_pair(",
                       "__global__ void __launch_bounds__(THREADS, 1)\n"
                       "    draw_pair(")],
    "pair_two_loops": [(_PAIR_LOOP, _PAIR_LOOPS)],
}

# the draws' sizes: a beam's 4 M rays, path (b)'s 256^3 field, and
# random_vs_plain's 2 x 512^3
K10_SIZES = (4_000_000, 256 ** 3, 2 * 512 ** 3)


def random_part(args):
    """The ``random`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch import random as jrandom
    from synthpy_tpu_torch.kernels import _build
    from synthpy_tpu_torch.kernels import random as krand
    from synthpy_tpu_torch.kernels.profiling import (batch_ms, best_ms,
                                                     nvidia_smi, ptxas)
    from synthpy_tpu_torch.tracer import init_beam
    graph_ms = _graph_ms()

    dev = torch.device("cuda")
    many = hasattr(krand, "draw_many")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi(),
           "draw_many": many}
    kern, _, cubin = ptxas(_build.CSRC / krand.KERNEL.source,
                           krand.KERNEL.flags)
    out["ptxas"] = kern
    out["sass"] = _sass_functions(cubin, f"k10_{Path(args.root).name}",
                                  lambda n: True)

    def best(fn):
        return min(batch_ms(fn, calls=10) for _ in range(args.reps))

    def beam_draws(keys, n):
        """A circular beam's four draws: phi, chi, the two positions."""
        ks = [jrandom.key_data(keys[s]) for s in (2, 3, 0, 1)]
        modes = ["uniform", "normal", "uniform", "uniform"]
        if many:
            return krand.draw_many(ks, n, modes, device=dev)
        return [krand.draw(k, n, m, device=dev) for k, m in zip(ks, modes)]

    def pair(kr_, ki_, n):
        """The GRF's complex noise: normal(kr) + 1j normal(ki)."""
        a, b = jrandom.key_data(kr_), jrandom.key_data(ki_)
        if many:
            return krand.draw_pair(a, b, n, device=dev)
        return torch.complex(krand.draw(a, n, "normal", device=dev),
                             krand.draw(b, n, "normal", device=dev))

    key7 = jrandom.key_of(7)
    chunk_key = jrandom.split(jrandom.PRNGKey(7), 4)[0]
    beam_keys = jrandom.split(chunk_key, 5)
    kr0, ki0 = jrandom.split(jrandom.PRNGKey(0))
    n4, n256, n512 = K10_SIZES
    cases = {
        "uniform_4M": lambda: krand.draw(key7, n4, "uniform", device=dev),
        "normal_4M": lambda: krand.draw(key7, n4, "normal", device=dev),
        "beam_draws_4M": lambda: beam_draws(beam_keys, n4),
        "normal_256^3": lambda: krand.draw(jrandom.key_data(kr0), n256,
                                           "normal", device=dev),
        "grf_noise_256^3": lambda: pair(kr0, ki0, n256),
        "bits_2x512^3": lambda: krand.draw(key7, n512, "bits", device=dev),
        "uniform_2x512^3": lambda: krand.draw(key7, n512, "uniform", -0.5,
                                              0.5, device=dev),
        "normal_2x512^3": lambda: krand.draw(key7, n512, "normal",
                                             device=dev)}
    res, hashes = {}, {}
    for name, fn in cases.items():
        got = fn()
        torch.cuda.synchronize()
        got = torch.stack(got) if isinstance(got, list) else got
        hashes[name] = _sha(torch.view_as_real(got) if got.is_complex()
                            else got.view(torch.int32))
        res[name] = {"graph_ms": graph_ms(fn, calls=10),
                     "batch_ms": best(fn)}
        del got
        torch.cuda.empty_cache()
        emit({"case": name, **res[name]})
    # a whole init_beam of 4 M rays: device time (a CUDA graph) and the
    # host's wall time a call
    def beam():
        return init_beam(chunk_key, n4, 2.5e-3, 0.0, EXT, "circular",
                         device=dev)
    s0 = beam()
    hashes["init_beam_4M"] = _sha(s0)
    res["init_beam_4M"] = {"graph_ms": graph_ms(beam, calls=5),
                           "call_ms": best_ms(beam, reps=5)}
    krand.KERNEL.launches = 0
    beam()
    res["init_beam_4M"]["launches"] = krand.KERNEL.launches
    emit({"case": "init_beam_4M", **res["init_beam_4M"]})
    del s0
    # counters: odd offsets, a draw straddling 2^32, short draws
    for mode in ("bits", "uniform", "normal"):
        for n, off in ((1, 0), (3, 7), (5, 1), ((1 << 20) + 7, 12345),
                       (1 << 21, 2 ** 32 - 2 ** 20)):
            hashes[f"{mode}_{n}_at_{off}"] = _sha(krand.draw(
                (123, 456), n, mode, -0.5, 0.5, device=dev,
                offset=off).view(torch.int32))
    if args.variants:
        res["variants"] = _random_variants(krand, cases, hashes, graph_ms)
    out["cases"] = res
    _save_against(out, hashes, args)
    print(json.dumps({"part": "random", **out}), flush=True)


def _random_variants(krand, cases, hashes, graph_ms):
    """``RANDOM_VARIANTS``' builds on the cases of ``random_part``: device
    times in turns with the shipped build, outputs hashed against its."""
    import torch
    from synthpy_tpu_torch.kernels import profiling
    from synthpy_tpu_torch.kernels.profiling import ptxas
    res = {}
    timed = ("beam_draws_4M", "normal_256^3", "grf_noise_256^3",
             "bits_2x512^3", "uniform_2x512^3", "normal_2x512^3")
    for name, subs in RANDOM_VARIANTS.items():
        v = profiling.variant(krand.KERNEL, f"k10_{name}", subs)
        kern, _, cubin = ptxas(Path(v.source), v.flags)
        r = {"ptxas": kern, "sass": _sass_functions(
            cubin, f"k10_{name}", lambda n: "draw_" in n)}
        for case in timed:
            fn = cases[case]
            with profiling.kernel_of(krand, v):
                got = fn()
                got = torch.stack(got) if isinstance(got, list) else got
                same = _sha(torch.view_as_real(got) if got.is_complex()
                            else got.view(torch.int32)) == hashes[case]
                del got
                t_v = graph_ms(fn, calls=10)
            r[case] = {"graph_ms": t_v, "shipped_graph_ms": graph_ms(
                fn, calls=10), "bit_equal": same}
            torch.cuda.empty_cache()
        res[name] = r
        emit({"variant": name, **{k: v_ for k, v_ in r.items()
                                  if k != "sass"}})
    return res


def _fresnel_inputs(dev):
    """The diagnostics path's Fresnel deposit inputs (``chip_smoke.py``'s
    ``diagnostics_path``: the 512^3 lens, ne_0 = 2e25, 4 M rays of a 2.5 mm
    beam traced by ``solve_zscan``, ``fresnel_solve`` onto 512 x 512 nodes
    over [-3, 3] mm): (x, y, amplitude, phase, grid), recorded where
    ``ops.fresnel.propagate`` calls the deposit."""
    import torch
    from synthpy_tpu_torch.fields import layout_of
    from synthpy_tpu_torch.fields.domain import ScalarDomain, build_pack
    from synthpy_tpu_torch.ops import fresnel
    from synthpy_tpu_torch.optics import diagnostics as dg
    from synthpy_tpu_torch.tracer import init_beam, zscan

    lwl = 1064e-9
    lens = ScalarDomain(2 * EXT, DIM, phaseshift=True, device=dev)
    lens.test_lens(ne_0=2e25, LR=2e-3)
    zp = zscan.make_zscan_pack(build_pack(lens, lwl), layout_of(lens), "z")
    s0 = init_beam(0, RAYS, 2.5e-3, 0.0, EXT, "circular", device=dev)
    res = zscan.solve_zscan(s0, lens, lwl=lwl, return_E=True, zpack=zp)
    del zp, lens, s0
    grid = torch.linspace(-3.0, 3.0, 512, device=dev)
    fr = dg.Refractometry(lwl, res.rf, None, x=grid, y=grid, x_l=6e-3,
                          y_l=6e-3, amp=res.Jf[1].abs(), phase=res.sf[7])
    seen = []
    shipped = fresnel.deposit

    def record(*a, **k):
        seen.append(a)
        return shipped(*a, **k)

    fresnel.deposit = record
    try:
        fr.fresnel_solve(z=0.3)
    finally:
        fresnel.deposit = shipped
    x, y, vals = (t.contiguous() for t in seen[0][:3])
    return x, y, vals[:, 0].contiguous(), vals[:, 1].contiguous(), grid


def _tile_counts(x, y, grid, tile: int) -> dict:
    """Of the rays (x, y) on ``grid`` x ``grid`` nodes: the entries a
    ``tile`` x ``tile``-node tiling gives (a ray once in each tile its
    four corners touch; rays outside with finite positions none, NaN ones
    at index 0), the tiles holding any, the fullest tile's entries and the
    mean over those holding any."""
    import torch
    n = grid.shape[0]
    d = grid[1] - grid[0]
    ts = [(v - grid[0]) / d for v in (x, y)]
    inside = (torch.isfinite(ts[0]) & torch.isfinite(ts[1])
              & (ts[0] >= 0) & (ts[0] <= n - 1) & (ts[1] >= 0)
              & (ts[1] <= n - 1))
    keep = inside | ts[0].isnan() | ts[1].isnan()
    cs = [torch.floor(t).nan_to_num(0).clamp(0, n - 2).long()[keep]
          for t in ts]
    nt = (n + tile - 1) // tile
    ids = torch.cat([((cs[0] + a) // tile) * nt + (cs[1] + b) // tile
                     for a in (0, 1) for b in (0, 1)])
    # a ray's distinct tiles: its four corners' tiles, each ray once a tile
    ray = torch.arange(cs[0].numel(), device=x.device).repeat(4)
    pairs = torch.unique(ray * (nt * nt) + ids)
    counts = torch.bincount(pairs % (nt * nt), minlength=nt * nt)
    held = counts[counts > 0].double()
    return {"tile": tile, "tiles": nt * nt, "entries": int(counts.sum()),
            "rays_kept": int(keep.sum()), "tiles_held": int(held.numel()),
            "fullest": int(counts.max()),
            "mean_held": float(held.mean()) if held.numel() else 0.0}


# builds of deposit.cu that ``deposit --variants`` times beside the shipped
# one on the path's V = 2 deposit
DEPOSIT_VARIANTS = {
    "tile16": [("constexpr int TILE = 32;", "constexpr int TILE = 16;")],
    "items_4": [("constexpr int ITEMS_PER_SM = 8;",
                 "constexpr int ITEMS_PER_SM = 4;")],
    "rays_8": [("constexpr int RAYS = 4;", "constexpr int RAYS = 8;")],
    "sort_2": [("constexpr int SORT_PER_SM = 4;",
                "constexpr int SORT_PER_SM = 2;")],
    "sort_8": [("constexpr int SORT_PER_SM = 4;",
                "constexpr int SORT_PER_SM = 8;")],
}


def deposit_part(args):
    """The ``deposit`` part (see the module's docstring)."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch.kernels import _build, deposit
    from synthpy_tpu_torch.kernels.profiling import (batch_ms, kernel_ms,
                                                     nvidia_smi, ptxas)
    graph_ms = _graph_ms()

    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi()}
    kern, _, cubin = ptxas(_build.CSRC / deposit.KERNEL.source,
                           deposit.KERNEL.flags)
    out["ptxas"] = kern
    out["sass"] = _sass_functions(cubin, f"k8_{Path(args.root).name}",
                                  lambda n: True)
    x, y, amp, phase, grid = _fresnel_inputs(dev)
    N = x.shape[0]
    out["rays"] = N
    out["tiles"] = [_tile_counts(x, y, grid, t) for t in (16, 32, 64)]
    emit({"tiles": out["tiles"]})

    def best(fn):
        return min(batch_ms(fn, calls=20) for _ in range(args.reps))

    cases = {}
    for name, vals in (("V1", amp[:, None].contiguous()),
                       ("V2", torch.stack([amp, phase], 1))):
        def call(ret=False):
            return deposit.deposit(x, y, vals, grid, grid, return_acc=ret)
        acc, got = call(True), call()
        acc_p = deposit.deposit_plain(x, y, vals, grid, grid,
                                      return_acc=True)
        want = deposit.deposit_plain(x, y, vals, grid, grid)
        scale = acc_p.nan_to_num(0).abs().amax((0, 1)).clamp_min(1e-30)
        c = {"nan_as_plain": bool(torch.equal(acc.isnan(), acc_p.isnan())
                                  and torch.equal(got.isnan(),
                                                  want.isnan())),
             "sum_rel_err": ((acc - acc_p).nan_to_num(0).abs().amax((0, 1))
                             / scale).tolist(),
             "value_rel_err": float((got - want).nan_to_num(0).abs().max())
             / float(want.nan_to_num(0).abs().max()),
             "repeat_max_abs": max(float((call(True) - acc).nan_to_num(0)
                                         .abs().max()) for _ in range(3)),
             "graph_ms": graph_ms(call), "batch_ms": best(call),
             "acc_graph_ms": graph_ms(lambda: call(True)),
             "kernels_ms": kernel_ms(call, Path("chiprun_out")
                                     / f"k8_{name}_trace.json")}
        # bytes: the rays' positions and values read once, the grid
        # written once; the tiled design's count beside it: the positions
        # read twice (count, scatter), the values once, each 16-byte bucket
        # entry written and read, the grid written and each work item's
        # partial tile (at most one an item) written and read
        V = vals.shape[1]
        c["bound_ms"] = (N * (8 + 4 * V) + 512 * 512 * V * 4
                         + 2 * 512 * 4) / 3.35e12 * 1e3
        entries = out["tiles"][1]["entries"]
        items = 256 + torch.cuda.get_device_properties(
            dev).multi_processor_count * 8
        c["bound_design_ms"] = (N * (16 + 4 * V) + entries * 32
                                + 512 * 512 * V * 4
                                + 2 * items * (V + 1) * 4096) / 3.35e12 * 1e3
        cases[name] = c
        emit({"case": name, **c})
    if hasattr(deposit, "BATCH"):
        # the V = 2 deposit in batches of fewer rays than the call's (each
        # batch's sums added to those before it): device time, error and
        # scratch beside one batch's
        vals = torch.stack([amp, phase], 1)
        want = deposit.deposit_plain(x, y, vals, grid, grid, return_acc=True)
        scale = want.nan_to_num(0).abs().amax((0, 1)).clamp_min(1e-30)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        shipped, res = deposit.BATCH, {}
        for b in (1 << 20, 1 << 21, shipped):
            deposit.BATCH = b
            try:
                acc = deposit.deposit(x, y, vals, grid, grid, return_acc=True)
                res[str(b)] = {
                    "batches": -(-N // b),
                    "graph_ms": graph_ms(lambda: deposit.deposit(
                        x, y, vals, grid, grid)),
                    "sum_rel_err": ((acc - want).nan_to_num(0).abs()
                                    .amax((0, 1)) / scale).tolist(),
                    "scratch_mb": deposit.KERNEL.load()
                    .deposit_scratch_blocks(N, 2, 512, 512, sms, b, 0)
                    * 256 / 2**20}
            finally:
                deposit.BATCH = shipped
            emit({"batch": b, **res[str(b)]})
        out["batches"] = res
    if args.variants and hasattr(deposit, "tiles_plain"):
        from synthpy_tpu_torch.kernels import profiling
        vals = torch.stack([amp, phase], 1)
        want = deposit.deposit_plain(x, y, vals, grid, grid, return_acc=True)
        scale = want.nan_to_num(0).abs().amax((0, 1)).clamp_min(1e-30)
        var = {}
        for name, subs in DEPOSIT_VARIANTS.items():
            v = profiling.variant(deposit.KERNEL, f"k8_{name}", subs)
            with profiling.kernel_of(deposit, v):
                def call(ret=False):
                    return deposit.deposit(x, y, vals, grid, grid,
                                           return_acc=ret)
                acc = call(True)
                var[name] = {
                    "graph_ms": graph_ms(call),
                    "sum_rel_err": ((acc - want).nan_to_num(0).abs()
                                    .amax((0, 1)) / scale).tolist(),
                    "kernels_ms": kernel_ms(call, Path("chiprun_out")
                                            / f"k8_{name}_trace.json")}
            var[name]["shipped_graph_ms"] = graph_ms(
                lambda: deposit.deposit(x, y, vals, grid, grid))
            emit({"variant": name, **var[name]})
        out["variants"] = var
    out["cases"] = cases
    _save_against(out, {}, args)
    print(json.dumps({"part": "deposit", **out}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("part", nargs="?",
                    choices=["march", "adjoint", "boris", "adaptive", "time",
                             "k18", "zscan", "analytic", "k17", "k19",
                             "xray", "btable", "cic", "random",
                             "deposit"],
                    default="march")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--save")
    ap.add_argument("--against")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--builds", action="store_true")
    ap.add_argument("--first")
    args = ap.parse_args()
    if args.part == "adjoint":
        return adjoint(args)
    if args.part == "boris":
        return boris_part(args)
    if args.part == "adaptive":
        return adaptive_part(args)
    if args.part == "time":
        return time_part(args)
    if args.part == "k18":
        return k18_part(args)
    if args.part == "zscan":
        return zscan_part(args)
    if args.part == "analytic":
        return analytic_part(args)
    if args.part == "k17":
        return k17_part(args)
    if args.part == "k19":
        return k19_part(args)
    if args.part == "xray":
        return xray_part(args)
    if args.part == "btable":
        return btable_part(args)
    if args.part == "cic":
        return cic_part(args)
    if args.part == "random":
        return random_part(args)
    if args.part == "deposit":
        return deposit_part(args)
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from synthpy_tpu_torch import pipeline
    from synthpy_tpu_torch.fields import ScalarDomain, layout_of
    from synthpy_tpu_torch.kernels import _build, march
    from synthpy_tpu_torch.kernels.profiling import (best_ms, load_mix,
                                                     nvidia_smi, ptxas,
                                                     variant)
    from synthpy_tpu_torch.tracer import init_beam, zscan

    dev = torch.device("cuda")
    smi = nvidia_smi()
    report = {"nvidia_smi": smi}

    # -- ptxas -------------------------------------------------------------
    src = _build.CSRC / march.KERNEL.source
    kern, log, cubin = ptxas(src, march.KERNEL.flags)
    report["ptxas"] = kern
    pattern = r"march_kernelILi1E.*LayoutILi0ELi0ELi0E"
    main_k = {n: v for n, v in kern.items() if re.search(pattern, n)}
    for v in main_k.values():
        v.update(occupancy(v["regs"], 128, v.get("smem", 0)))
    emit({"part": "ptxas", "bf16_C3": main_k, "n_kernels": len(kern),
          "bf16_C3_loads": load_mix(cubin, pattern)})

    # -- inputs --------------------------------------------------------------
    domain = ScalarDomain(2 * EXT, DIM, device=dev).test_lens(ne_0=5e24,
                                                              LR=1.5e-3)
    layout = layout_of(domain)
    sp = zscan.build_segment_pack_device(domain, K=K, dtype=torch.bfloat16)
    s0 = init_beam(0, RAYS, 2e-3, 0.0, EXT, "circular", device=dev)
    u = zscan.permute_state(s0, "z").contiguous()
    kw = dict(shape_ab=sp.shape_ab, origin_ab=sp.origin_ab.tolist(),
              inv_ab=sp.inv_spacing_ab.tolist(), dp=sp.dp, layout=layout,
              K=sp.K, integrator="rk2", weights="slab", qbits=sp.qbits)
    geo = (sp.shape_ab, kw["origin_ab"], kw["inv_ab"])

    # -- sectors a warp's corner load touches (model) -------------------------
    C = layout.n_channels
    row = sp.seg_planes.shape[-1]
    es = sp.seg_planes.element_size()
    nb = sp.shape_ab[1]

    def sectors(order):
        cell = march.entry_cells(u, *geo)[order].long()
        n = cell.numel() // 32 * 32
        cell = cell[:n].reshape(-1, 32)
        out = []
        for off in (0, 1, nb, nb + 1):
            for c in range(C):
                sec = ((cell + off) * row + c) * es // 32
                s = sec.sort(dim=1).values
                out.append(1 + (s.diff(dim=1) != 0).sum(1).float())
        return float(torch.stack(out).mean())

    order = march.ray_order(u, *geo)
    cells = march.entry_cells(u, *geo)
    report["sectors"] = {
        "caller_order": sectors(torch.arange(RAYS, device=dev)),
        "entry_cell_order": sectors(order),
        "distinct_entry_cells": int(torch.unique(cells).numel()),
        "rays_per_cell": RAYS / int(torch.unique(cells).numel())}
    emit({"part": "sectors", **report["sectors"]})

    # -- variants ------------------------------------------------------------
    # Each variant is the shipped source with one change, built beside it:
    # (name, text substitutions, nvcc flags or None for the shipped)
    variants = {
        "no_carry": ([("if (!have) load_corners<DT, C>(X, k, w0);",
                       "load_corners<DT, C>(X, k, w0);")], None),
        "fmad_contracted": ([], []),
        "frcp_rn": ([("1.0f / s[4]", "__frcp_rn(s[4])")], None),
        "min_6_blocks": ([("__launch_bounds__(THREADS)",
                           "__launch_bounds__(THREADS, 6)")], None),
        "min_8_blocks": ([("__launch_bounds__(THREADS)",
                           "__launch_bounds__(THREADS, 8)")], None),
        "threads_256": ([("constexpr int THREADS = 128;",
                          "constexpr int THREADS = 256;")], None),
    }
    t0 = time.perf_counter()
    kernels = {name: variant(march.KERNEL, name, subs, flags)
               for name, (subs, flags) in variants.items()}
    _build.build({k.source: k.flags for k in kernels.values()})
    var = {"variant_build_s": time.perf_counter() - t0}

    identity = torch.arange(RAYS, device=dev)
    var["order_ms"] = best_ms(lambda: march.ray_order(u, *geo))
    ref = march.march(u, sp.seg_planes, sp.scales, **kw)
    for name, k in [("shipped", march.KERNEL), *kernels.items()]:
        def run(order=None):
            # the order computed in the call, as march does, or the given one
            o = march.ray_order(u, *geo) if order is None else order
            return march.launch(k, u, sp.seg_planes, sp.scales, o, **kw)

        var[name] = {"max_abs_vs_shipped": float(
            (run() - ref).abs().nan_to_num(0).max()), "ms": best_ms(run),
            "caller_order_ms": best_ms(lambda: run(identity))}
    report["variants"] = var
    emit({"part": "variants", **var})

    # -- torch.profiler over one pipeline.run ---------------------------------
    from torch.profiler import ProfilerActivity, profile, record_function

    def run_once():
        return pipeline.run(domain, s0, solver="zscan_seg", spack=sp,
                            integrator="rk2", seg_weights="slab", bins=BINS)

    run_once()
    torch.cuda.synchronize()
    trace = root / "chiprun_out" / "march_profile_trace.json"
    trace.parent.mkdir(exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("pipeline.run"):
            run_once()
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    ev = json.loads(trace.read_text())["traceEvents"]
    win = [e for e in ev if e.get("name") == "pipeline.run"
           and e.get("ph") == "X"][0]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev_ev = [e for e in ev if e.get("ph") == "X" and e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                   for e in dev_ev if e["ts"] < w1 and e["ts"] + e["dur"] > w0)
    busy, end = 0.0, w0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in dev_ev:
        by_name[e["name"][:90]] = by_name.get(e["name"][:90], 0.0) + e["dur"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    report["profile"] = {
        "window_us": w1 - w0, "device_busy_us": busy,
        "device_idle_share": 1 - busy / (w1 - w0),
        "device_us_by_name": dict(top), "n_device_events": len(dev_ev)}
    emit({"part": "profile", **report["profile"]})

    (root / "chiprun_out" / "march_profile.json").write_text(
        json.dumps(report, indent=1))
    (root / "chiprun_out" / "march_ptxas.log").write_text(log)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
