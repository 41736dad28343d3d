#!/usr/bin/env python3
"""Run chip_smoke.py's multi-device phases (``mesh_path``, then
``sharded_field_path``) alone.

    python3 mesh_timing.py        # from the repository root
    python3 mesh_timing.py mesh   # mesh_path alone

On a host with four or more cards the mesh's four shards go on cuda:0-3,
otherwise all on cuda:0, as in chip_smoke.py. Builds the kernels the
phases run, then prints their JSON lines (``K17_vs_plain``,
``mesh_path``, ``K18_vs_plain``, ``multihost_nccl``, then
``sharded_field_build`` per tier and ``sharded_field_path``: each shard
card's peak memory of the 1024^3 sharded synthesis and build), their
kernel rows and the card's name and power limit. Every check of the
phases holds; a failed one exits nonzero.
"""

import json
import os
import sys
import time


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("mesh_timing: no CUDA device: this script runs only on a "
                 "GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from synthpy_tpu_torch.kernels import (_build, binning, detector, march,
                                           march_sharded, pack,
                                           sharded_rhs, time_march)
    from synthpy_tpu_torch.kernels import random as krandom
    from synthpy_tpu_torch.kernels.profiling import nvidia_smi

    kernels = {"march": march.KERNEL, "pack": pack.KERNEL,
               "detector": detector.KERNEL,
               "detector_field": detector.FIELD_KERNEL,
               "time_march": time_march.KERNEL,
               "bin_image": binning.BIN_KERNEL,
               "march_shards": march_sharded.KERNEL,
               "march_exchange": march_sharded.EXCHANGE_KERNEL,
               "sharded_rhs": sharded_rhs.KERNEL,
               "pack_window": pack.WINDOW_KERNEL,
               "random": krandom.KERNEL}
    _build.build({k.source: k.flags for k in kernels.values()})

    def reset():
        for k in kernels.values():
            k.launches = 0

    def path_launches(names, path):
        counts = {n: kernels[n].launches for n in names}
        cs.check(all(v > 0 for v in counts.values()),
                 f"{path}: a kernel of the path was not launched: {counts}")
        return counts

    def bound(nbytes, flops):
        tb = nbytes / cs.HBM_BYTES_PER_S * 1e3
        tf = flops / cs.F32_FLOPS_PER_S * 1e3
        return (max(tb, tf), "bytes" if tb >= tf else "operations")

    def close(a, b, what):
        cs.check(torch.equal(a.isnan(), b.isnan()), f"{what}: NaN pattern")
        scale = b.abs().nan_to_num(0).amax(0).clamp_min(1e-30)
        diff = (a - b).abs().nan_to_num(0)
        rel = (diff.amax(0) / scale).tolist()
        cs.check(max(rel) <= 1e-5, f"{what}: off by {rel}")
        return {"max_rel_per_column": rel, "max_abs_err": float(diff.max()),
                "bit_equal": bool(torch.equal(a.nan_to_num(0),
                                              b.nan_to_num(0)))}

    t = time.perf_counter()
    rows, _ = cs.mesh_path(torch, torch.device("cuda"), kernels, bound,
                           reset, path_launches, close)
    if sys.argv[1:] != ["mesh"]:
        more, _ = cs.sharded_field_path(torch, torch.device("cuda"),
                                        kernels, bound, reset, path_launches)
        rows += more
    print(json.dumps({"kernels": rows,
                      "script_s": time.perf_counter() - t}), flush=True)
    print(nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
