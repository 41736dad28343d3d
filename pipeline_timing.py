#!/usr/bin/env python3
"""Time ``pipeline.run`` of the PyTorch port at the main path's three tiers.

    python3 pipeline_timing.py [--root DIR] [--reps N]

Imports ``synthpy_tpu_torch`` from ``DIR`` (default: beside this script),
so that two checkouts can be compared in turns on one card (parent,
change, change, parent). On the 512^3 bench lens (K = 512) with 4,000,000
rays of a 2 mm circular beam and 431 x 321 bins, for bf16/rk2,
int8/rk2s2 and int4/rk2s4 (slab weights) on a prebuilt pack, it times
``N`` single calls with CUDA events after a warm-up and prints one JSON
line with each tier's median and best [ms] and the card's name and power
limit. Nothing here imports JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

DIM, K, RAYS, BINS = 512, 512, 4_000_000, (431, 321)
EXT = 5e-3


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("pipeline_timing: no CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from synthpy_tpu_torch import pipeline
    from synthpy_tpu_torch.fields import ScalarDomain
    from synthpy_tpu_torch.tracer import init_beam, zscan

    dev = torch.device("cuda")
    # timed here, not by kernels/profiling.py: the tree at --root may
    # predate that module
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"root": os.path.abspath(args.root), "nvidia_smi": smi,
           "reps": args.reps}
    for tier, dtype, integrator in (("bf16", torch.bfloat16, "rk2"),
                                    ("int8", torch.int8, "rk2s2"),
                                    ("int4", "int4", "rk2s4")):
        dom = ScalarDomain(2 * EXT, DIM, device=dev).test_lens(ne_0=5e24,
                                                               LR=1.5e-3)
        spack = zscan.build_segment_pack_device(dom, K=K, dtype=dtype)
        rays = init_beam(0, RAYS, 2e-3, 0.0, EXT, "circular", device=dev)

        def run():
            return pipeline.run(dom, rays, solver="zscan_seg", spack=spack,
                                integrator=integrator, seg_weights="slab",
                                bins=BINS)

        run()
        torch.cuda.synchronize()
        ms = []
        for _ in range(args.reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        out[tier] = {"median_ms": statistics.median(ms), "best_ms": min(ms)}
        del dom, spack, rays
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
