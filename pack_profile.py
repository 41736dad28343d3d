#!/usr/bin/env python3
"""Profile kernels K2 (pack build) and K3 (detector) at the main path's
shapes on a card.

    python3 pack_profile.py        # from the repository root, one GPU

What it measures on the 512^3 bench lens (K = 512, one segment; 4,000,000
rays of a 2 mm circular beam marched bf16/rk2/slab for K3):

- ``ptxas``: registers, shared memory and spills of the build and detector
  kernels of the main path (C = 3, z-probing);
- ``k2``: device times (CUDA events around 20 back-to-back calls, per
  call) and achieved bytes/s of the bf16 build as shipped and of builds of
  the same source that differ in one point: scalar ne loads (no 16-byte
  loads), a tile of half the size (two chunks of planes), 16 or one cell a
  block, and two that each leave a part of the work out (the channel
  arithmetic, the ne loads); the int8 build as shipped, with four times as
  many runs of cells in pass A and with pass A's atomics left out; the
  device time of each device kernel of the bf16, f32 and int8 builds
  (torch.profiler); yardsticks: a copy of ne and a fill of a table-sized
  tensor;
- ``k3``: device times (50 back-to-back calls) of the detector as shipped
  and of a build that adds once per (warp, bin) (``__match_any_sync``),
  each on the rays in the caller's order and in K1's entry-cell order (a
  permuted copy), with the CUDA-event time of the whole wrapper call; the
  grouped build reading the rays through K1's order (thread i takes ray
  order[i]) and the copy that permutes the exit states into that order;
  three variants that each leave a part out (the atomics, the optical
  stages, the arctans).

Every variant's output is compared with the shipped kernel's. It prints
one JSON line per part and writes everything to
``chiprun_out/pack_profile.json``. Nothing here imports JAX.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

DIM, K, RAYS, BINS = 512, 512, 4_000_000, (431, 321)
EXT = 5e-3
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet


def emit(obj):
    print(json.dumps(obj), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("pack_profile: no CUDA device")
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from synthpy_tpu_torch import constants
    from synthpy_tpu_torch.fields import ScalarDomain, layout_of
    from synthpy_tpu_torch.kernels import _build, detector, march, pack
    from synthpy_tpu_torch.kernels.profiling import (batch_ms, best_ms,
                                                     kernel_of, kernel_ms,
                                                     nvidia_smi, ptxas,
                                                     variant)
    from synthpy_tpu_torch.ops.histogram import bin_params, f32
    from synthpy_tpu_torch.optics.compose import shadowgraphy_two_lens
    from synthpy_tpu_torch.tracer import init_beam, zscan

    dev = torch.device("cuda")
    smi = nvidia_smi()
    report = {"nvidia_smi": smi}

    # -- ptxas ---------------------------------------------------------------
    def main_kernels(module, pattern):
        found = ptxas(_build.CSRC / module.KERNEL.source,
                      module.KERNEL.flags)[0]
        return {n: v for n, v in found.items() if re.search(pattern, n)}

    report["ptxas"] = {
        "pack": main_kernels(pack,
                             r"(rows|amax)_pass.*LayoutILi0ELi0ELi0EEELi1E"),
        "detector": main_kernels(detector, r"detect_kernel")}
    emit({"part": "ptxas", **report["ptxas"]})

    # -- K2 ------------------------------------------------------------------
    domain = ScalarDomain(2 * EXT, DIM, device=dev).test_lens(ne_0=5e24,
                                                              LR=1.5e-3)
    layout = layout_of(domain)
    C = layout.n_channels
    omega = constants.omega_from_lwl(1064e-9)
    ca = domain.x.cpu()
    dp = float(domain.z.cpu()[1] - domain.z.cpu()[0])
    build_kw = dict(p_ax=2, layout=layout, K=K, n_seg=1,
                    pref=-0.5 * constants.C**2
                    / constants.critical_density(omega),
                    da=float(ca[1] - ca[0]), db=float(ca[1] - ca[0]), dp=dp,
                    omega=omega, verdet=0.0)
    vols = {"ne": domain.ne, "Te": None, "Z": None, "B": None}

    def build_bf16():
        return pack.build_tables(vols, dtype=torch.bfloat16, **build_kw)

    variants = {
        "scalar_loads": [("F.vec_ok = sp == 1", "F.vec_ok = 0 && sp == 1")],
        "tile_12k": [("constexpr int TILE_BUDGET = 24 * 1024;",
                      "constexpr int TILE_BUDGET = 12 * 1024;")],
        "cells_16": [("constexpr int CB_ROWS = 8;",
                      "constexpr int CB_ROWS = 16;")],
        # where the time goes: each leaves one part of the work out
        "no_compute": [
            ("  v[0] = F.pref * grad1(",
             "  v[0] = body; if (0) v[0] = F.pref * grad1("),
            ("  v[1] = F.pref * grad1(",
             "  v[1] = body; if (0) v[1] = F.pref * grad1("),
            ("  v[2] = gp;", "  v[2] = body;")],
        "no_ne_loads": [("  if (P1 < P0) return;  // only pad planes",
                         "  if (true) return;  // only pad planes")],
        "one_cell_a_block": [("constexpr int CB_ROWS = 8;",
                              "constexpr int CB_ROWS = 1;")],
    }
    k2_kernels = {n: variant(pack.KERNEL, n, s)
                  for n, s in variants.items()}
    # pass A of the int8 build: four times as many (shorter) runs of cells,
    # and no atomics
    int8_variants = {
        "amax_runs_x4": [("const long long want = 132LL * 8 * 2 /",
                          "const long long want = 132LL * 8 * 8 /")],
        "amax_no_atomics": [(
            """        atomicMax(amax + ((long long)s * (F.Ko + 1) + ko) * C + c,
                  __float_as_uint(m[j][c]));""",
            "        if (m[j][c] < 0.0f) amax[0] = 0u;")]}
    k2_kernels.update({n: variant(pack.KERNEL, n, s)
                       for n, s in int8_variants.items()})
    _build.build({k.source: k.flags
                  for k in [pack.KERNEL, detector.KERNEL, march.KERNEL,
                            *k2_kernels.values()]})

    ref = build_bf16()
    nbytes = domain.ne.numel() * 4 + ref.numel() * 2
    k2 = {"bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}

    trace = root / "chiprun_out" / "pack_profile_trace.json"
    trace.parent.mkdir(exist_ok=True)

    def record(name, fn):
        out = fn()
        same = torch.equal(out.view(torch.int16), ref.view(torch.int16))
        ms = batch_ms(fn)
        k2[name] = {"ms": ms, "equal_to_shipped": same,
                    "bytes_per_s": nbytes / (ms * 1e-3)}

    def build_int8():
        return pack.build_quantized_tables(vols, bits=8, **build_kw)

    record("shipped", build_bf16)
    for name, k in k2_kernels.items():
        if name not in int8_variants:
            with kernel_of(pack, k):
                record(name, build_bf16)
    k2["int8/shipped"] = batch_ms(build_int8)
    for name in int8_variants:
        with kernel_of(pack, k2_kernels[name]):
            k2[f"int8/{name}"] = batch_ms(build_int8)
    record("shipped_again", build_bf16)
    # yardsticks: copying ne, and writing a table of the same size
    tab = torch.empty_like(ref)
    k2["copy_ne_ms"] = batch_ms(lambda: domain.ne.clone())
    k2["fill_table_ms"] = batch_ms(lambda: tab.fill_(1.0))
    del tab
    # device time of each kernel of the builds
    builds = {
        "bf16": build_bf16,
        "int8": lambda: pack.build_quantized_tables(vols, bits=8,
                                                    **build_kw),
        "f32": lambda: pack.build_tables(vols, dtype=torch.float32,
                                         **build_kw)}
    for name, fn in builds.items():
        k2[f"device_ms/{name}"] = kernel_ms(fn, trace)
    del ref
    emit({"part": "k2", **k2})
    report["k2"] = k2

    # -- K3 ------------------------------------------------------------------
    sp = zscan.build_segment_pack_device(domain, K=K, dtype=torch.bfloat16)
    s0 = init_beam(0, RAYS, 2e-3, 0.0, EXT, "circular", device=dev)
    u = zscan.permute_state(s0, "z").contiguous()
    mkw = dict(shape_ab=sp.shape_ab, origin_ab=sp.origin_ab.tolist(),
               inv_ab=sp.inv_spacing_ab.tolist(), dp=sp.dp, layout=layout,
               K=sp.K, integrator="rk2", weights="slab", qbits=sp.qbits)
    uf = march.march(u, sp.seg_planes, sp.scales, **mkw)
    # the same exit states in K1's entry-cell order
    uf_k1 = uf[march.ray_order(u, sp.shape_ab, mkw["origin_ab"],
                               mkw["inv_ab"])].contiguous()
    p_end = sp.p0 + sp.K * sp.dp
    det_args = (p_end, domain.extent, "z", shadowgraphy_two_lens(), BINS,
                ((-9.0, 9.0), (-6.75, 6.75)))
    one_add = ("  if (key >= 0) atomicAdd(H + key, weights ? weights[i] "
               ": 1.0f);")
    # one atomic per (warp, bin): the warp's rays grouped by bin, the
    # group's first lane adds its count (counts only: no weights)
    grouping = [(
        """  if (i >= N) return;
  const float4* u = reinterpret_cast<const float4*>(uf + i * 8);
  const int key = ray_bin(""", """  int key = -1;
  const float4* u =
      reinterpret_cast<const float4*>(uf + (i < N ? i : 0) * 8);
  if (i < N) key = ray_bin("""), (
        one_add, """  const unsigned group = __match_any_sync(0xffffffffu, key);
  if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(group) - 1)
    atomicAdd(H + key, (float)__popc(group));""")]
    grouped = variant(detector.KERNEL, "warp_grouped", grouping)
    # the same, thread i taking ray order[i] of an int64 order passed in
    # (the rays left in the caller's order, K1's order read through)
    through = variant(detector.KERNEL, "warp_grouped_through_order", [
        *grouping,
        ("uf + (i < N ? i : 0) * 8", "uf + order[i < N ? i : 0] * 8"),
        ("__global__ void detect_kernel(const float* uf, const float* "
         "weights,", "__global__ void detect_kernel(const float* uf, "
         "const long long* order, const float* weights,"),
        ('extern "C" int detect_image(const float* uf, const float* '
         'weights,', 'extern "C" int detect_image(const float* uf, '
         'const long long* order, const float* weights,'),
        ("      uf, weights, H, N,", "      uf, order, weights, H, N,")])
    fn = detector.KERNEL.functions["detect_image"]
    through.functions = {"detect_image": [fn[0], *fn]}
    # where the time goes: each leaves one part of the work out
    k3_parts = {
        "no_atomics": variant(detector.KERNEL, "no_atomics", [(
            one_add, "  if (key == -7) H[0] = 0.0f;")]),
        "no_stages": variant(detector.KERNEL, "no_stages", [(
            "for (int o = 0; o < n_ops; ++o) {",
            "for (int o = 0; o < n_ops * 0; ++o) {")]),
        "no_atan": variant(detector.KERNEL, "no_atan", [(
            "r[1] = atanf(va / vp);", "r[1] = va / vp;"), (
            "r[3] = atanf(vb / vp);", "r[3] = vb / vp;")]),
    }
    _build.build({k.source: k.flags
                  for k in [grouped, through, *k3_parts.values()]})
    Href = detector.detect(uf, *det_args)
    k3 = {"bytes": RAYS * 32 + BINS[0] * BINS[1] * 4}
    k3["bound_ms"] = k3["bytes"] / HBM_BYTES_PER_S * 1e3
    for name, k in (("shipped", detector.KERNEL), ("warp_grouped", grouped)):
        with kernel_of(detector, k):
            for oname, rays in (("caller_order", uf), ("K1_order", uf_k1)):
                def call():
                    return detector.detect(rays, *det_args)

                k3[f"{name}/{oname}"] = {
                    "ms": batch_ms(call, calls=50),
                    "call_ms": best_ms(call, reps=20),
                    "equal_to_shipped": torch.equal(call(), Href)}
    for name, k in k3_parts.items():
        with kernel_of(detector, k):
            k3[f"{name}/caller_order"] = {"ms": batch_ms(
                lambda: detector.detect(uf, *det_args), calls=50)}
    # K1's order read through an order, and the copy that puts the exit
    # states in it
    order = march.ray_order(u, sp.shape_ab, mkw["origin_ab"],
                            mkw["inv_ab"])
    ops = detector.stage_table(det_args[3])
    bx = bin_params(-9.0, 9.0, BINS[0])
    by = bin_params(-6.75, 6.75, BINS[1])

    def through_order():
        H = torch.zeros((BINS[1], BINS[0]), device=dev)
        through.launch("detect_image", dev, uf.data_ptr(), order.data_ptr(),
                       None, H.data_ptr(), RAYS, 0, f32(p_end),
                       f32(domain.extent), ops.ctypes.data, ops.shape[0],
                       BINS[0], BINS[1], *bx, *by)
        return H

    k3["warp_grouped_through_order/K1_order"] = {
        "ms": batch_ms(through_order, calls=50),
        "equal_to_shipped": torch.equal(through_order(), Href)}
    k3["copy_to_K1_order_ms"] = batch_ms(lambda: uf[order].contiguous(),
                                         calls=50)
    emit({"part": "k3", **k3})
    report["k3"] = k3

    out = root / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "pack_profile.json").write_text(json.dumps(report, indent=1))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
