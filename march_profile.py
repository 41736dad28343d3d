#!/usr/bin/env python3
"""Profile kernel K1 (the segment march) at the main path's shapes on a
card, time kernel K11 (its adjoint) on the inversion path's inputs, or
time kernel K13 (the Boris push) on the proton path's.

    python3 march_profile.py        # from the repository root, one GPU
    python3 march_profile.py adjoint [--root DIR] [--reps N] [--save F]
                                     [--against F]
    python3 march_profile.py boris [--root DIR] [--reps N] [--save F]
                                   [--against F]
    python3 march_profile.py adaptive [--root DIR] [--reps N] [--save F]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("part", nargs="?",
                    choices=["march", "adjoint", "boris", "adaptive"],
                    default="march")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--save")
    ap.add_argument("--against")
    args = ap.parse_args()
    if args.part == "adjoint":
        return adjoint(args)
    if args.part == "boris":
        return boris_part(args)
    if args.part == "adaptive":
        return adaptive_part(args)
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
