#!/usr/bin/env python3
"""Run the PyTorch port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py        # from the repository root, one GPU

The port's three hand-written CUDA kernels (K1 segment march, K2 pack
builder/quantiser, K3 detector) are built from ``synthpy_tpu_torch/kernels/
csrc`` with nvcc, each is held to its plain PyTorch version on the card,
and the bench configuration (512^3 bench lens, K = 512, 4,000,000 rays,
rk2, slab weights, 431 x 321 bins) runs through the port's entry points
at the bf16, int8/rk2s2 and int4/rk2s4 tiers. K2 builds every tier and
``plane_stride=2`` straight from the volume, held bit-equal to the
two-step (float table, then quantiser) and post-hoc (full build, then
decimation) routes, each build timed with its bound and peak memory; K3
is held to the plain detector on the rays in the caller's order and in
K1's entry-cell order. Each phase prints one JSON line; then a
``{"kernels": [...]}`` line with each kernel's launches on the main path
(calls of its C entry point, which starts one device kernel, two for the
int8 and int4 builds; a K2 row per tier), its time
(CUDA events around a batch of back-to-back calls, per call), its bound,
its plain version's time and a library call's time (best single calls);
then the card's name and power limit; and last
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits nonzero and prints no "ok" line; it also exits nonzero without a
CUDA device or without the ``synthpy_tpu_torch`` package beside it.
Nothing here imports JAX.
"""

import json
import os
import sys
import time

DIM, K, RAYS, BINS = 512, 512, 4_000_000, (431, 321)
SUBSET = 65_536
EXT = 5e-3
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs only on a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from synthpy_tpu_torch import constants, pipeline
        from synthpy_tpu_torch.fields import ScalarDomain, layout_of
        from synthpy_tpu_torch.kernels import _build, detector, march, pack
        from synthpy_tpu_torch.kernels.profiling import (batch_ms, best_ms,
                                                         nvidia_smi)
        from synthpy_tpu_torch.ops.histogram import _bin_index
        from synthpy_tpu_torch.optics.compose import (apply_stages,
                                                      shadowgraphy_two_lens)
        from synthpy_tpu_torch.optics.rtm import m_to_mm
        from synthpy_tpu_torch.tracer import init_beam, ray_to_Jonesvector
        from synthpy_tpu_torch.tracer import zscan
    except ImportError as e:
        fail(f"the synthpy_tpu_torch package is not beside this script ({e})")

    dev = torch.device("cuda")
    kernels = {"march": march.KERNEL, "pack": pack.KERNEL,
               "detector": detector.KERNEL}

    # -- 1. device and kernel build ------------------------------------------
    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.build({k.source: k.flags for k in kernels.values()})
    for k in kernels.values():
        k.load()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "build_s": round(time.perf_counter() - t0, 3)})

    # -- 2. kernels against their plain versions ------------------------------
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

    k2 = {}
    f32_kernel = pack.build_tables(vols, dtype=torch.float32, **build_kw)
    f32_plain = pack.build_tables_plain(vols, dtype=torch.float32,
                                        **build_kw)
    bf16_kernel = pack.build_tables(vols, dtype=torch.bfloat16, **build_kw)
    bf16_plain = pack.build_tables_plain(vols, dtype=torch.bfloat16,
                                         **build_kw)
    for name, a, b in (("f32", f32_kernel, f32_plain),
                       ("bf16", bf16_kernel, bf16_plain)):
        a4 = a.float().reshape(-1, K + 1, C)
        b4 = b.float().reshape(-1, K + 1, C)
        rel = [float((a4[..., c] - b4[..., c]).abs().max()
                     / b4[..., c].abs().max().clamp_min(1e-30))
               for c in range(C)]
        check(max(rel) <= 1e-6, f"K2 {name} table off by {rel}")
        k2[name] = {"max_rel_per_channel": rel,
                    "max_abs_err": float((a4 - b4).abs().max())}
    k2["f32"]["bit_equal"] = torch.equal(f32_kernel, f32_plain)
    k2["bf16"]["bit_equal"] = torch.equal(bf16_kernel, bf16_plain)
    del f32_plain, bf16_plain
    for name, bits in (("int8", 8), ("int4", 4)):
        # the fused build straight from the volume == the two-step kernel
        # route (f32 table, then the quantiser), bit for bit
        codes, scales = pack.build_quantized_tables(vols, bits=bits,
                                                    **build_kw)
        tc, ts = pack.quantize_tables(f32_kernel, K, C, bits)
        fused_same = torch.equal(codes, tc) and torch.equal(scales, ts)
        check(fused_same, f"K2 {name} fused build != quantize_tables("
              "build_tables(f32))")
        pc, ps = pack.quantize_tables_plain(f32_kernel, K, C, bits)
        same = torch.equal(tc, pc) and torch.equal(ts, ps)
        check(same, f"K2 {name} quantiser differs from its plain version")
        del tc, ts, pc, ps
        # the fused build vs its plain version (plain f32 build + plain
        # quantiser): codes within +-1
        qc, qs = pack.build_quantized_tables_plain(vols, bits=bits,
                                                   **build_kw)
        if bits == 4:
            a = torch.stack([pack.nibble_lo(codes), pack.nibble_hi(codes)])
            b = torch.stack([pack.nibble_lo(qc), pack.nibble_hi(qc)])
        else:
            a, b = codes.to(torch.int16), qc.to(torch.int16)
        diff = (a - b).abs()
        srel = float(((scales - qs).abs() / qs.abs()).max())
        check(int(diff.max()) <= 1, f"K2 {name} codes differ by > 1")
        check(srel <= 1e-6, f"K2 {name} scales off by {srel}")
        k2[name] = {"fused_equals_two_step": fused_same,
                    "quantiser_bit_identical": same,
                    "max_code_diff": int(diff.max()),
                    "frac_codes_differ": float((diff > 0).float().mean()),
                    "scale_max_rel": srel}
        del codes, scales, qc, qs, a, b, diff
    # plane_stride = 2 built directly == the decimated full build, every
    # tier, bit for bit (the full f32 build is f32_kernel)
    for name in ("f32", "bf16", "int8", "int4"):
        if name in ("f32", "bf16"):
            dt = torch.float32 if name == "f32" else torch.bfloat16
            full = (f32_kernel if name == "f32" else
                    pack.build_tables(vols, dtype=dt, **build_kw))
            strided = pack.build_tables(vols, dtype=dt, plane_stride=2,
                                        **build_kw)
            same = torch.equal(strided,
                               pack.decimate_tables(full, K, C, 2))
        else:
            bits = 8 if name == "int8" else 4
            codes, scales = pack.build_quantized_tables(vols, bits=bits,
                                                        **build_kw)
            sc, ss = pack.build_quantized_tables(vols, bits=bits,
                                                 plane_stride=2, **build_kw)
            same = (torch.equal(sc, pack.decimate_tables(codes, K, C, 2,
                                                         nibbles=bits == 4))
                    and torch.equal(ss, scales[:, ::2]))
            del codes, scales, sc, ss
        check(same, f"K2 {name} plane_stride=2 != decimated full build")
        k2[name]["stride2_equals_decimated"] = same
    del f32_kernel, bf16_kernel, full, strided
    torch.cuda.empty_cache()
    emit({"phase": "K2_vs_plain", "shape": [1, DIM * DIM, (K + 1) * C],
          **k2})

    # each build's time, bound and peak device memory (above what was
    # allocated before it), and the routes it replaces in the same call
    def bound(nbytes, flops):
        tb_ = nbytes / HBM_BYTES_PER_S * 1e3
        tf_ = flops / F32_FLOPS_PER_S * 1e3
        return (max(tb_, tf_), "bytes" if tb_ >= tf_ else "operations")

    def out_bytes(res):
        ts = res if isinstance(res, tuple) else (res,)
        return sum(t.numel() * t.element_size() for t in ts)

    def build_stats(fn, reps=10):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        nbytes = domain.ne.numel() * 4 + out_bytes(res)
        del res
        b = bound(nbytes, 0)
        ms = batch_ms(fn)
        return {"ms": ms, "call_ms": best_ms(fn, reps=reps),
                "bound_ms": b[0], "bound_by": b[1], "bytes": nbytes,
                "peak_gb": peak / 1e9, "share_of_bound": b[0] / ms}

    def two_step(bits):
        return pack.quantize_tables(
            pack.build_tables(vols, dtype=torch.float32, **build_kw),
            K, C, bits)

    def post_hoc_bf16():
        full = pack.build_tables(vols, dtype=torch.float32, **build_kw)
        return pack.decimate_tables(full, K, C, 2).to(torch.bfloat16)

    builds = {
        "f32": lambda: pack.build_tables(vols, dtype=torch.float32,
                                         **build_kw),
        "bf16": lambda: pack.build_tables(vols, dtype=torch.bfloat16,
                                          **build_kw),
        "int8": lambda: pack.build_quantized_tables(vols, bits=8,
                                                    **build_kw),
        "int4": lambda: pack.build_quantized_tables(vols, bits=4,
                                                    **build_kw),
        "bf16_stride2": lambda: pack.build_tables(
            vols, dtype=torch.bfloat16, plane_stride=2, **build_kw),
        "int8_two_step": lambda: two_step(8),
        "int4_two_step": lambda: two_step(4),
        "bf16_stride2_post_hoc": post_hoc_bf16,
    }
    k2_builds = {}
    # A/B in turns: fused, two-step, two-step, fused
    for name in ("f32", "bf16", "bf16_stride2", "bf16_stride2_post_hoc",
                 "int8", "int8_two_step", "int4", "int4_two_step"):
        k2_builds[name] = build_stats(builds[name])
    for name in ("int8_two_step", "int8", "int4_two_step", "int4"):
        k2_builds[name]["ms_second"] = batch_ms(builds[name])
    for name in ("int8", "int4"):
        saved = (k2_builds[name + "_two_step"]["peak_gb"]
                 - k2_builds[name]["peak_gb"])
        k2_builds[name]["peak_gb_below_two_step"] = saved
        check(saved >= 1.5, f"K2 {name}: fused build peak only {saved} GB "
              "below the two-step route")
    k2_plain = {
        "bf16": best_ms(lambda: pack.build_tables_plain(
            vols, dtype=torch.bfloat16, **build_kw), reps=2),
        "int8": best_ms(lambda: pack.build_quantized_tables_plain(
            vols, bits=8, **build_kw), reps=2),
        "int4": best_ms(lambda: pack.build_quantized_tables_plain(
            vols, bits=4, **build_kw), reps=2)}
    torch.cuda.empty_cache()
    emit({"phase": "K2_builds", "plain_ms": k2_plain, **k2_builds})

    s0 = init_beam(0, RAYS, 2e-3, 0.0, EXT, "circular", device=dev)
    packs = {name: zscan.build_segment_pack_device(domain, K=K, dtype=dt)
             for name, dt in (("f32", torch.float32),
                              ("bf16", torch.bfloat16), ("int8", torch.int8),
                              ("int4", "int4"))}
    u_all = zscan.permute_state(s0, "z").contiguous()
    u_sub = u_all[:SUBSET].contiguous()

    def march_kw(sp, integrator, weights):
        return dict(shape_ab=sp.shape_ab, origin_ab=sp.origin_ab.tolist(),
                    inv_ab=sp.inv_spacing_ab.tolist(), dp=sp.dp,
                    layout=layout, K=sp.K, integrator=integrator,
                    weights=weights, qbits=sp.qbits)

    def march_close(a, b, what):
        """Per-column error of kernel output a against plain output b."""
        check(torch.equal(a.isnan(), b.isnan()), f"K1 {what} NaN pattern")
        scale = b.abs().nan_to_num(0).amax(0).clamp_min(1e-30)
        rel = ((a - b).abs().nan_to_num(0).amax(0) / scale).tolist()
        check(max(rel) <= 1e-5, f"K1 {what} off by {rel}")
        return {"max_rel_per_column": rel,
                "max_abs_err": float((a - b).abs().nan_to_num(0).max())}

    k1 = {}
    # bf16 / rk2s2 / slab is the march of scratch/proto_pallas_march.py:53
    for tier, integrator, weights in (("bf16", "rk2", "slab"),
                                      ("bf16", "rk2s2", "slab"),
                                      ("f32", "rk4", "stage"),
                                      ("int8", "rk2s2", "slab"),
                                      ("int4", "rk2s4", "slab")):
        sp = packs[tier]
        kw = march_kw(sp, integrator, weights)
        a = march.march(u_sub, sp.seg_planes, sp.scales, **kw)
        torch.cuda.synchronize()
        b = march.march_plain(u_sub, sp.seg_planes, sp.scales, **kw)
        k1[f"{tier}/{integrator}/{weights}"] = march_close(
            a, b, f"{tier}/{integrator}/{weights}")
    half = zscan.decimate_segment_pack(packs["int4"], 2)
    a = march.march(u_sub, half.seg_planes, half.scales,
                    **march_kw(half, "rk2s2", "slab"))
    b = march.march(u_sub, packs["int4"].seg_planes, packs["int4"].scales,
                    **march_kw(packs["int4"], "rk2s4", "slab"))
    check(torch.equal(a, b), "K1 int4 rk2s2/stride-2 != rk2s4/full")
    k1["int4 rk2s2 on stride 2 == rk2s4 on full"] = True
    del half, a, b
    # the main path's own call: every ray, bf16 / rk2 / slab
    sp = packs["bf16"]
    p_end = sp.p0 + sp.seg_planes.shape[0] * sp.K * sp.dp
    mkw = march_kw(sp, "rk2", "slab")
    geo = (sp.shape_ab, mkw["origin_ab"], mkw["inv_ab"])
    uf = march.march(u_all, sp.seg_planes, sp.scales, **mkw)
    torch.cuda.synchronize()
    uf_plain = march.march_plain(u_all, sp.seg_planes, sp.scales, **mkw)
    k1_main = march_close(uf, uf_plain, "bf16/rk2/slab, all rays")

    # every ray of the main path's call, fed in reversed and in entry-cell
    # order: the plain march is per ray, so its result for a permutation
    # of the rays is that permutation of its result
    for name, perm in (("reversed", torch.arange(RAYS - 1, -1, -1,
                                                 device=dev)),
                       ("entry-cell order", march.ray_order(u_all, *geo))):
        a = march.march(u_all[perm].contiguous(), sp.seg_planes, sp.scales,
                        **mkw)
        k1[f"bf16/rk2/slab, {RAYS} rays, {name}"] = march_close(
            a, uf_plain[perm], f"{name} rays")
    del a, perm
    # an 8-segment pack (K = 64)
    sp64 = zscan.build_segment_pack_device(domain, K=64, dtype=torch.bfloat16)
    check(sp64.seg_planes.shape[0] == 8, "K = 64 pack is not 8 segments")
    kw64 = march_kw(sp64, "rk2", "slab")
    k1[f"bf16/rk2/slab, K = 64 x 8 segments, {RAYS} rays"] = march_close(
        march.march(u_all, sp64.seg_planes, sp64.scales, **kw64),
        march.march_plain(u_all, sp64.seg_planes, sp64.scales, **kw64),
        "8 segments")
    del sp64
    # a square beam over the whole grid: ~15 rays a cell, and blocks that
    # straddle two rows of cells
    u_sq = zscan.permute_state(init_beam(1, RAYS, EXT, 0.0, EXT, "square",
                                         device=dev), "z").contiguous()
    k1[f"bf16/rk2/slab, whole-grid square beam, {RAYS} rays"] = march_close(
        march.march(u_sq, sp.seg_planes, sp.scales, **mkw),
        march.march_plain(u_sq, sp.seg_planes, sp.scales, **mkw),
        "square beam")
    del u_sq
    # the beam moved 4 mm along a: a fifth of it outside the grid, and
    # every 4099th ray with a NaN v_p
    u_out = u_all.clone()
    u_out[:, 0] += 4e-3
    u_out[::4099, 4] = float("nan")
    res = march.march(u_out, sp.seg_planes, sp.scales, **mkw)
    check(bool(res.isnan().any()), "no NaN in the partly-outside bundle")
    k1[f"bf16/rk2/slab, bundle partly outside, {RAYS} rays"] = {
        **march_close(res, march.march_plain(u_out, sp.seg_planes,
                                             sp.scales, **mkw),
                      "partly outside"),
        "outside": float(((u_out[:, 0] - mkw["origin_ab"][0])
                          * mkw["inv_ab"][0] > DIM - 1).float().mean())}
    del u_out, res
    emit({"phase": "K1_vs_plain", "rays": SUBSET, "tolerance":
          "atol 1e-5 * max|column|, same NaNs", **k1,
          f"bf16/rk2/slab at {RAYS} rays": k1_main})

    stages = shadowgraphy_two_lens()
    det_args = (p_end, domain.extent, "z", stages, BINS,
                ((-9.0, 9.0), (-6.75, 6.75)))
    # the exit states in the caller's order (as the main path hands them
    # over) and in K1's entry-cell order: counts do not depend on it
    k1_order = march.ray_order(u_all, *geo)
    uf_k1 = uf[k1_order].contiguous()
    Hp = detector.detect_plain(uf, *det_args)
    k3_err = 0.0
    for name, rays in (("caller order", uf), ("K1 order", uf_k1)):
        H = detector.detect(rays, *det_args)
        torch.cuda.synchronize()
        check(torch.equal(H, Hp), f"K3 image counts in {name} differ from "
              f"the plain detector (sum {float(H.sum())} vs "
              f"{float(Hp.sum())})")
        k3_err = max(k3_err, float((H - Hp).abs().max()))
    emit({"phase": "K3_vs_plain", "rays": RAYS,
          "counts_equal_caller_order": True, "counts_equal_K1_order": True,
          "image_sum": float(H.sum())})

    # bounds: bytes each input read once and each output written once, or
    # the float32 operations, over the card's peak rates
    N = RAYS

    # rows of the table this run's rays touch (one segment at K = 512)
    cell = march.entry_cells(u_all, *geo).long()
    rows = torch.unique(torch.cat([cell, cell + 1, cell + DIM,
                                   cell + DIM + 1]))
    del cell

    def k1_flops(integrator, quantized):
        """float32 operations of the march over all rays, counted from
        march.cu: a stage is the blend 7C and the right-hand side 6 (one
        division, five products), slab weights 24, an 8-wide update 16, a
        dequantised value 1; rk2 also z-blends 8C a slab and reads one
        plane a slab, rk2s2 / rk2s4 read two planes a step of 2 / 4 slabs."""
        stage = 7 * C + 6
        if integrator == "rk2":
            return N * K * (8 * C + 24 + 2 * stage + 32
                            + quantized * 4 * C)
        stride = {"rk2s2": 2, "rk2s4": 4}[integrator]
        return N * (K // stride) * (24 + 2 * stage + 32 + quantized * 8 * C)

    def k1_bound(spack, integrator):
        t = spack.seg_planes
        nbytes = (2 * N * 32 + rows.numel() * t.shape[-1] * t.element_size()
                  + (0 if spack.scales is None
                     else spack.scales.numel() * 4))
        return bound(nbytes, k1_flops(integrator, spack.scales is not None))

    # -- 3. the main path at full width ---------------------------------------
    main = {}
    tiers = (("bf16", torch.bfloat16, "rk2"), ("int8", torch.int8, "rk2s2"),
             ("int4", "int4", "rk2s4"))
    images, main_k1 = {}, {}
    launches = {}
    for tier, dtype, integrator in tiers:
        for k in kernels.values():
            k.launches = 0
        dom = ScalarDomain(2 * EXT, DIM, device=dev).test_lens(ne_0=5e24,
                                                               LR=1.5e-3)
        spack = zscan.build_segment_pack_device(dom, K=K, dtype=dtype)
        rays = init_beam(0, RAYS, 2e-3, 0.0, EXT, "circular", device=dev)
        Hm = pipeline.run(dom, rays, solver="zscan_seg", spack=spack,
                          integrator=integrator, seg_weights="slab",
                          bins=BINS)
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        check(all(v > 0 for v in counts.values()),
              f"{tier}: a kernel of the path was not launched: {counts}")
        launches[tier] = counts
        check(tuple(Hm.shape) == (BINS[1], BINS[0])
              and bool(torch.isfinite(Hm).all()), f"{tier}: bad image")
        ut = zscan.permute_state(rays, "z").contiguous()
        tkw = march_kw(spack, integrator, "slab")
        ufm = march.march(ut, spack.seg_planes, spack.scales, **tkw)
        if tier != "bf16":
            # the tier's own call at every ray (bf16's is held above)
            main_k1[f"{tier}/{integrator}/slab"] = march_close(
                ufm, march.march_plain(ut, spack.seg_planes, spack.scales,
                                       **tkw),
                f"{tier}/{integrator}/slab, all rays")
        kept = float(detector.detect_plain(
            ufm, spack.p0 + spack.seg_planes.shape[0] * spack.K * spack.dp,
            dom.extent, "z", stages,
            BINS, ((-9.0, 9.0), (-6.75, 6.75))).sum())
        check(float(Hm.sum()) == kept > 0,
              f"{tier}: image sum {float(Hm.sum())} != {kept} rays kept")

        def run_once():
            pipeline.run(dom, rays, solver="zscan_seg", spack=spack,
                         integrator=integrator, seg_weights="slab",
                         bins=BINS)

        ms = best_ms(run_once, reps=3)
        k1_t = best_ms(lambda: march.march(ut, spack.seg_planes,
                                           spack.scales, **tkw), reps=5)
        b = k1_bound(spack, integrator)
        images[tier] = Hm
        main[tier] = {"integrator": integrator, "launches": counts,
                      "image_sum": float(Hm.sum()), "run_ms": ms,
                      "rays_per_s": RAYS / (ms * 1e-3), "k1_ms": k1_t,
                      "k1_bound_ms": b[0], "k1_bound_by": b[1]}
        del dom, spack, rays, ufm, ut
        torch.cuda.empty_cache()
    for tier in ("int8", "int4"):
        main[tier]["rel_l1_vs_bf16"] = float(
            (images[tier] - images["bf16"]).abs().sum()
            / images["bf16"].sum())
    emit({"phase": "main_path", "dim": DIM, "K": K, "rays": RAYS,
          "bins": list(BINS), "weights": "slab", **main})
    emit({"phase": "K1_vs_plain_tiers", "rays": RAYS, "tolerance":
          "atol 1e-5 * max|column|, same NaNs", **main_k1})

    # -- 4. kernel times at the main path's shapes, bounds, plain times -------
    k1_call_ms = best_ms(lambda: march.march(u_all, sp.seg_planes,
                                             sp.scales, **mkw), reps=5)
    k1_ms = batch_ms(lambda: march.march(u_all, sp.seg_planes, sp.scales,
                                         **mkw))
    order_ms = best_ms(lambda: march.ray_order(u_all, *geo), reps=10)
    k1_plain_ms = best_ms(lambda: march.march_plain(
        u_all, sp.seg_planes, sp.scales, **mkw), reps=1)
    k3_call_ms = best_ms(lambda: detector.detect(uf, *det_args), reps=20)
    k3_ms = batch_ms(lambda: detector.detect(uf, *det_args), calls=50)
    k3_k1_order_ms = batch_ms(lambda: detector.detect(uf_k1, *det_args),
                              calls=50)
    k3_plain_ms = best_ms(lambda: detector.detect_plain(uf, *det_args),
                          reps=3)

    # the library yardstick for K3: index_put_(accumulate=True) of the
    # precomputed bin indices (the port never calls it)
    rf, _ = ray_to_Jonesvector(zscan.reassemble_state(uf, p_end, "z"),
                               domain.extent, probing_direction="z")
    r = apply_stages(m_to_mm(rf), stages)
    ix, vx = _bin_index(r[0], -9.0, 9.0, BINS[0])
    iy, vy = _bin_index(r[2], -6.75, 6.75, BINS[1])
    flat = iy * BINS[0] + ix
    w = (vx & vy).float()
    Hl = torch.zeros(BINS[0] * BINS[1], device=dev)

    def lib():
        Hl.zero_()
        Hl.index_put_((flat,), w, accumulate=True)

    k3_lib_ms = best_ms(lib, reps=20)
    check(torch.equal(Hl.reshape(BINS[1], BINS[0]), H),
          "index_put_ yardstick disagrees with the detector")

    def warp_bin_groups(order):
        """Distinct (warp, bin) pairs of the kept rays of each 32
        consecutive threads: the atomics a detector that adds once per
        (warp, bin) would issue (this one adds once per kept ray)."""
        key = flat if order is None else flat[order]
        kept = (w > 0) if order is None else (w > 0)[order]
        warp = torch.arange(N, device=dev) // 32
        pair = warp * (BINS[0] * BINS[1]) + key
        return int(torch.unique(pair[kept]).numel())

    k3_groups = {"caller_order": warp_bin_groups(None),
                 "K1_order": warp_bin_groups(k1_order),
                 "kept_rays": int((w > 0).sum()),
                 "distinct_bins": int(torch.unique(flat[w > 0]).numel())}

    k1_b = k1_bound(sp, "rk2")
    # per ray: back-projection 6, two divisions and arctans (~20 each),
    # the composed stages (4x4 matrices 28, apertures 4), binning 10; the
    # state row and the image (no weights on the shadowgraphy bench)
    k3_flops = N * (6 + 40 + 2 * 28 + 2 * 4 + 10)
    k3_bytes = N * 32 + BINS[0] * BINS[1] * 4
    k3_b = bound(k3_bytes, k3_flops)
    csrc = "synthpy_tpu_torch/kernels/csrc/"
    rows_out = [
        {"name": "march", "route": "cuda", "source": csrc + "march.cu",
         "replaces": "synthpy_tpu/tracer/zscan.py:756",
         "launches": launches["bf16"]["march"],
         "max_abs_err": k1_main["max_abs_err"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_b[0],
         "bound_by": k1_b[1], "library_ms": None}]
    # K2 per tier; max_abs_err: bf16 values against the plain build, codes
    # (int8, int4) against the plain build's codes
    for tier in ("bf16", "int8", "int4"):
        st = k2_builds[tier]
        rows_out.append({
            "name": f"pack_{tier}", "route": "cuda",
            "source": csrc + "pack.cu",
            "replaces": "synthpy_tpu/tracer/zscan.py:"
                        + ("1812" if tier == "bf16" else "1852"),
            "launches": launches[tier]["pack"],
            "max_abs_err": (k2["bf16"]["max_abs_err"] if tier == "bf16"
                            else k2[tier]["max_code_diff"]),
            "ms": st["ms"], "plain_ms": k2_plain[tier],
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "library_ms": None})
    rows_out.append(
        {"name": "detector", "route": "cuda", "source": csrc + "detector.cu",
         "replaces": "synthpy_tpu/pipeline.py:76",
         "launches": launches["bf16"]["detector"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_b[0],
         "bound_by": k3_b[1], "library_ms": k3_lib_ms})
    detail = {"k1_table_rows_touched": int(rows.numel()),
              "k1_order_ms": order_ms,
              "k1_flops": {i: k1_flops(i, q) for i, q in (
                  ("rk2", False), ("rk2s2", True), ("rk2s4", True))},
              "k3_bytes": k3_bytes, "k3_caller_order_ms": k3_ms,
              "k3_K1_order_ms": k3_k1_order_ms, "k3_call_ms": k3_call_ms,
              "k1_call_ms": k1_call_ms, "k3_warp_bin_groups": k3_groups,
              "launches_by_tier": launches,
              # device kernels one counted launch starts: the int8 and
              # int4 builds run amax_pass, then rows_pass
              "device_kernels_per_launch": {
                  "march": 1, "pack_bf16": 1, "pack_int8": 2,
                  "pack_int4": 2, "detector": 1},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit({"phase": "bounds", **detail})
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"nvidia_smi": smi, "K1": k1, "K1_tiers": main_k1,
                   "K2": k2, "K2_builds": k2_builds, "K2_plain_ms": k2_plain,
                   "main": main,
                   "kernels": rows_out, **detail}, f, indent=1)
    emit({"kernels": rows_out})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
