#!/usr/bin/env python3
"""Profile kernel K1 (the segment march) at the main path's shapes on a card.

    python3 march_profile.py        # from the repository root, one GPU

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
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

DIM, K, RAYS, BINS = 512, 512, 4_000_000, (431, 321)
EXT = 5e-3


def emit(obj):
    print(json.dumps(obj), flush=True)


def load_mix(cubin: Path, pattern: str) -> dict:
    """Counts of load opcodes (LDG global, LDS shared, LD generic) in the
    SASS of the kernels whose name matches ``pattern``."""
    from synthpy_tpu_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    counts, on = {}, False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            on = re.search(pattern, m.group(1)) is not None
        if on:
            for op in re.findall(r"\b(LDG|LDS|LD|LDGSTS)\b", line):
                counts[op] = counts.get(op, 0) + 1
    return counts


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


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("march_profile: no CUDA device")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from synthpy_tpu_torch import pipeline
    from synthpy_tpu_torch.fields import ScalarDomain, layout_of
    from synthpy_tpu_torch.kernels import _build, march
    from synthpy_tpu_torch.kernels.profiling import (best_ms, nvidia_smi,
                                                     ptxas, variant)
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
