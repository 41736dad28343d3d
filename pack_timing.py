#!/usr/bin/env python3
"""Time kernel K2's single-device builds, its decimator and K14's bf16
batch write at the main path's shapes.

    python3 pack_timing.py [--root DIR] [--reps N] [--variants]

Imports ``synthpy_tpu_torch`` from ``DIR`` (default: beside this script),
so that two checkouts can be compared in turns on one card (parent,
change, change, parent). On the 512^3 bench lens (``bench.py``'s field)
at K = 512 it builds the f32, bf16, int8 and int4 tables with
``kernels.pack`` (the calls ``build_segment_pack_device`` makes), then
decimates each tier's full table at stride 2 (``decimate_tables``, with
the strided copy ``table[:, :, ::2].contiguous()`` beside the float and
int8 tables), then writes one 32-plane batch of a 1024^2 x 3 B grid into a
bfloat16 table with ``kernels.btable.write`` (K14, with ``copy_`` beside
it; the dithered int8 write is timed as a control). For each it takes
``N`` rounds of CUDA events around 20 back-to-back calls after a warm-up
and prints one JSON line with each item's per-call median, best, worst
and spread ((worst - best) / median) [ms] and the card's name and power
limit.

``--variants`` (the tree beside this script only) times builds of
``pack.cu`` changed by text substitution (``VARIANTS``: what the
z-probing build leaves out of the row window's code) in turns with the
shipped code (shipped, variant, variant, shipped). Nothing here imports
JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

DIM, K = 512, 512
EXT = 5e-3
BATCH, CAST_N = 32, 1024    # K14: a 32-plane batch of a 1024^2 x 3 B grid
# name -> text substitutions of pack.cu that put back what the shipped
# z-probing code leaves out (timing only; each builds the same tables):
# the per-row plane strides stored by every block, and the window's
# first row added to the cell's row in the hot loop
ROW_STRIDE = ("    if constexpr (!PC) T.rowsp[r] = sp;\n",
              "    T.rowsp[r] = sp;\n")
ROW_ADD = [("T.ab[i] = make_int2(F.a0 + a, cell - a * F.nb);",
            "T.ab[i] = make_int2(a, cell - a * F.nb);"),
           ("grad1(alo, ahi, a, F.na_total, F.da)",
            "grad1(alo, ahi, F.a0 + a, F.na_total, F.da)")]
VARIANTS = {"row_strides_stored": [ROW_STRIDE], "row_added": ROW_ADD,
            "both": [ROW_STRIDE, *ROW_ADD]}


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("pack_timing: no CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch import constants
    from synthpy_tpu_torch.fields import ScalarDomain, layout_of
    from synthpy_tpu_torch.kernels import btable, pack

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dom = ScalarDomain(2 * EXT, DIM, device=dev).test_lens(ne_0=5e24,
                                                           LR=1.5e-3)
    omega = constants.omega_from_lwl(1064e-9)
    h = float(dom.x[1].cpu() - dom.x[0].cpu())
    kw = dict(p_ax=2, layout=layout_of(dom), K=K, n_seg=1,
              pref=-0.5 * constants.C**2
              / constants.critical_density(omega),
              da=h, db=h, dp=float(dom.z[1].cpu() - dom.z[0].cpu()),
              omega=omega, verdet=0.0)
    vols = {"ne": dom.ne, "Te": None, "Z": None, "B": None}
    builds = {
        "f32": lambda: pack.build_tables(vols, dtype=torch.float32, **kw),
        "bf16": lambda: pack.build_tables(vols, dtype=torch.bfloat16, **kw),
        "int8": lambda: pack.build_quantized_tables(vols, bits=8, **kw),
        "int4": lambda: pack.build_quantized_tables(vols, bits=4, **kw)}

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(20):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 20)
        med = statistics.median(times)
        return {"median_ms": med, "best_ms": min(times),
                "worst_ms": max(times),
                "spread": (max(times) - min(times)) / med}

    out = {"root": os.path.abspath(args.root), "nvidia_smi": smi,
           "reps": args.reps, "calls": 20}
    for tier, fn in builds.items():
        out[tier] = timed(fn)

    # the decimator on each tier's full table (K2's decimate_segment_pack
    # route), stride 2
    C = kw["layout"].n_channels
    full = {"f32": builds["f32"](), "bf16": builds["bf16"](),
            "int8": builds["int8"]()[0], "int4": builds["int4"]()[0]}

    def dec(tier):
        return lambda: pack.decimate_tables(full[tier], K, C, 2,
                                            nibbles=tier == "int4")

    def strided(tier):
        t = full[tier]
        t4 = t.reshape(t.shape[0], t.shape[1], K + 1, C)
        return lambda: t4[:, :, ::2].contiguous()

    for tier in full:
        out[f"decimate_{tier}"] = timed(dec(tier))
        if tier != "int4":
            out[f"decimate_{tier}"]["strided_copy"] = timed(strided(tier))

    # K14: one 32-plane batch of a 1024^2 x 3 grid into a table (plane 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = 5.0 * torch.randn((BATCH, CAST_N, CAST_N, 3), device=dev,
                              generator=gen)
    tab16 = torch.empty(batch.shape, dtype=torch.bfloat16, device=dev)
    tab8 = torch.empty(batch.shape, dtype=torch.int8, device=dev)
    scale = (batch.abs().amax(dim=(0, 1, 2)) / 127.0).contiguous()
    key = (1234, 5678)
    cast = {"btable_bf16": lambda: btable.write(tab16, batch, 0),
            "btable_int8_dither_unchanged": lambda: btable.write(
                tab8, batch, 0, scale, key)}
    for name, fn in cast.items():
        out[name] = timed(fn)
    out["btable_bf16"]["copy_"] = timed(lambda: tab16.copy_(batch))
    if args.variants:
        from synthpy_tpu_torch.kernels import _build, profiling

        kernels = {n: profiling.variant(pack.KERNEL, n, subs)
                   for n, subs in VARIANTS.items()}
        _build.build({k.source: k.flags for k in kernels.values()})
        ref = builds["bf16"]()
        for name, kern in kernels.items():
            # in turns: shipped, variant, variant, shipped (bf16 and int4)
            row = {}
            for tier in ("bf16", "int4"):
                s = [timed(builds[tier])["median_ms"]]
                with profiling.kernel_of(pack, kern):
                    if tier == "bf16":
                        assert torch.equal(builds[tier](), ref)
                    t = [timed(builds[tier])["median_ms"]
                         for _ in range(2)]
                s.append(timed(builds[tier])["median_ms"])
                row[tier] = {"variant_ms": t, "shipped_ms": s}
            out[name] = row
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
