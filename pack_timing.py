#!/usr/bin/env python3
"""Time kernel K2's single-device builds, its decimator and K14's bf16
batch write at the main path's shapes.

    python3 pack_timing.py [--root DIR] [--reps N] [--variants]
    python3 pack_timing.py fill [--root DIR] [--reps N] [--save F]
                                [--against F]

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
shipped code (shipped, variant, variant, shipped).

``fill`` times kernel K9 (``kernels.fill.fill``) on ``chip_smoke.py``'s
``scale_path`` batch: the MAGPIE z-pinch at 1024^3 (C = 8, its ne and
pointwise volumes from the closures), planes 256-287 (segment 1's first
32 of a K = 256 pack), written at the int4 pack's columns with the
scene's dither (7), then int4 undithered, int8 with and without the
dither, f32 and bf16 into tables of the same K. For each it prints the
per-call median, best, worst and spread of ``N`` rounds of 10 calls, each
device kernel's time a call from a ``torch.profiler`` trace, and SHA-256s
of the batch's codes (values) and scales; ``ptxas`` gives registers,
spills and occupancy of every K9 instance at C = 8 and C = 3. With
``--save F`` the hashes are written to F; with ``--against F`` (another
tree's file) it says, mode by mode, whether codes and scales are
bit-equal to that tree's. Nothing here imports JAX.
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


def timed(fn, reps, calls=20):
    """Per-call median, best, worst and spread of ``reps`` rounds of CUDA
    events around ``calls`` back-to-back calls, after a warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    med = statistics.median(times)
    return {"median_ms": med, "best_ms": min(times), "worst_ms": max(times),
            "spread": (max(times) - min(times)) / med}


FILL_DIM, FILL_K, FILL_PB, FILL_DITHER = 1024, 256, 32, 7


def fill_part(args):
    """The ``fill`` part (see the module's docstring)."""
    import hashlib
    import re
    from pathlib import Path

    import torch
    sys.path.insert(0, os.path.abspath(args.root))
    from chip_smoke import magpie_fields
    from synthpy_tpu_torch.fields import ScalarDomain, layout_of
    from synthpy_tpu_torch.kernels import _build, fill
    from synthpy_tpu_torch.kernels.profiling import (kernel_ms, nvidia_smi,
                                                     ptxas)
    from synthpy_tpu_torch.tracer import zscan

    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root), "nvidia_smi": nvidia_smi(),
           "reps": args.reps, "calls": 10}
    src = _build.CSRC / fill.KERNEL.source
    kern, _, _ = ptxas(src, fill.KERNEL.flags)
    threads = int(re.search(r"constexpr int THREADS = (\d+);",
                            src.read_text()).group(1))
    report = {}
    for n, v in kern.items():
        m = re.search(r"\d+(amax_pass|write_pass)I.*?LayoutILi(\d)ELi(\d)E"
                      r"Li(\d)E(?:EELi(\d)ELb(\d))?", n)
        if not m or m.group(2, 3, 4) not in (("0", "0", "0"),
                                              ("1", "1", "1")):
            continue
        C = 8 if m.group(2) == "1" else 3
        key = f"{m.group(1)}_C{C}"
        if m.group(5) is not None:
            key += ("_" + ("f32", "bf16", "int8", "int4")[int(m.group(5))]
                    + ("_dither" if m.group(6) == "1" else ""))
        report[key] = {**v, "threads": threads}
    out["ptxas"] = report

    dm = ScalarDomain(2 * EXT, FILL_DIM, device=dev)
    dm.inv_brems = dm.phaseshift = dm.B_on = True
    geo = zscan._geometry_of(dm, 1064e-9)
    lay = layout_of(dm)
    C = lay.n_channels
    (_, k0, pb, lone, slab, ex), = list(zscan._closure_batches(
        dm, geo, magpie_fields(torch), lay, [(1, 0, FILL_PB, False)],
        FILL_K))
    cells = FILL_DIM ** 2
    hashes, times = {}, {}
    for name, dtype, dither in (
            ("int4_dither", "int4", FILL_DITHER), ("int4", "int4", None),
            ("int8_dither", torch.int8, FILL_DITHER),
            ("int8", torch.int8, None), ("f32", torch.float32, None),
            ("bf16", torch.bfloat16, None)):
        mode = fill.mode_of(dtype)
        blocks = FILL_K // 2 + 1 if mode == 3 else FILL_K + 1
        col0 = (k0 // 2 if mode == 3 else k0) * C
        width = ((pb + 1) // 2 if mode == 3 else pb) * C
        tdt = {0: torch.float32, 1: torch.bfloat16}.get(mode, torch.int8)
        buf = torch.zeros((1, cells, blocks * C), dtype=tdt, device=dev)
        scl = (torch.ones((1, FILL_K + 1, C), device=dev) if mode >= 2
               else None)
        fkw = zscan._fill_kw(geo, lay, mode, dither)

        def call():
            fill.fill(buf, scl, slab, ex, g0=FILL_K + k0, seg_i=0,
                      col0=col0, k0=k0, pb=pb, lone=lone, **fkw)

        rec = timed(call, args.reps, calls=10)
        rec["device_ms"] = kernel_ms(call, Path("chiprun_out")
                                     / f"fill_{name}_trace.json", reps=5)
        call()
        torch.cuda.synchronize()
        codes = buf[0, :, col0:col0 + width].contiguous()
        hashes[name] = {
            "codes": hashlib.sha256(codes.view(torch.uint8).cpu().numpy()
                                    .tobytes()).hexdigest(),
            "scales": None if scl is None else hashlib.sha256(
                scl[0, k0:k0 + pb].cpu().numpy().tobytes()).hexdigest()}
        times[name] = rec
        del buf, scl, codes
        torch.cuda.empty_cache()
    out["batch"] = {"dim": FILL_DIM, "K": FILL_K, "planes": pb,
                    "first_plane": FILL_K + k0, "channels": C}
    out["times"] = times
    out["sha256"] = hashes
    if args.save:
        with open(args.save, "w") as f:
            json.dump(hashes, f)
    if args.against:
        with open(args.against) as f:
            ref = json.load(f)
        out["against"] = {"file": args.against, **{
            k: {"codes_bit_equal": v["codes"] == ref[k]["codes"],
                "scales_bit_equal": v["scales"] == ref[k]["scales"]}
            for k, v in hashes.items()}}
    print(json.dumps({"part": "fill", **out}), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("pack_timing: no CUDA device")
    ap = argparse.ArgumentParser()
    ap.add_argument("part", nargs="?", choices=["pack", "fill"],
                    default="pack")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--save")
    ap.add_argument("--against")
    args = ap.parse_args()
    os.makedirs("chiprun_out", exist_ok=True)
    if args.part == "fill":
        return fill_part(args)
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

    def timed_(fn):
        return timed(fn, args.reps)

    out = {"root": os.path.abspath(args.root), "nvidia_smi": smi,
           "reps": args.reps, "calls": 20}
    for tier, fn in builds.items():
        out[tier] = timed_(fn)

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
        out[f"decimate_{tier}"] = timed_(dec(tier))
        if tier != "int4":
            out[f"decimate_{tier}"]["strided_copy"] = timed_(
                strided(tier))

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
        out[name] = timed_(fn)
    out["btable_bf16"]["copy_"] = timed_(lambda: tab16.copy_(batch))
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
                s = [timed_(builds[tier])["median_ms"]]
                with profiling.kernel_of(pack, kern):
                    if tier == "bf16":
                        assert torch.equal(builds[tier](), ref)
                    t = [timed_(builds[tier])["median_ms"]
                         for _ in range(2)]
                s.append(timed_(builds[tier])["median_ms"])
                row[tier] = {"variant_ms": t, "shipped_ms": s}
            out[name] = row
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
