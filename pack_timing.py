#!/usr/bin/env python3
"""Time kernel K2's single-device builds at the main path's shapes.

    python3 pack_timing.py [--root DIR] [--reps N]

Imports ``synthpy_tpu_torch`` from ``DIR`` (default: beside this script),
so that two checkouts can be compared in turns on one card (parent,
change, change, parent). On the 512^3 bench lens (``bench.py``'s field)
at K = 512 it builds the f32, bf16, int8 and int4 tables with
``kernels.pack`` (the calls ``build_segment_pack_device`` makes) and, for
each tier, takes ``N`` rounds of CUDA events around 20 back-to-back builds
after a warm-up; it prints one JSON line with each tier's per-build median
and best [ms] and the card's name and power limit. ``--variants`` (the
tree beside this script only) also times builds of ``pack.cu`` changed by
text substitution, each in turns with the shipped build: ``VARIANTS``
names what each puts back of the row window's code that the z-probing
build leaves out. Nothing
here imports JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

DIM, K = 512, 512
EXT = 5e-3
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
    from synthpy_tpu_torch.kernels import pack

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
        return {"median_ms": statistics.median(times), "best_ms": min(times)}

    out = {"root": os.path.abspath(args.root), "nvidia_smi": smi,
           "reps": args.reps, "calls": 20}
    for tier, fn in builds.items():
        out[tier] = timed(fn)
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
