"""Timing, ptxas reports and source variants of the CUDA kernels, and the
load models of K13 and K5, shared by ``chip_smoke.py`` and the root
profilers (``march_profile.py``, ``pack_profile.py``). Nothing in the
package calls it; everything here but the load models needs a CUDA device
or ``nvcc`` when it is called, not when it is imported.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from synthpy_tpu_torch.kernels import _build


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def best_ms(fn: Callable, reps: int = 5, warmup: int = 1) -> float:
    """Best of ``reps`` CUDA-event timings of one fn() call [ms], the
    host's work in the call included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def batch_ms(fn: Callable, calls: int = 20) -> float:
    """Device time of one fn() call [ms]: CUDA events around ``calls``
    back-to-back calls (the host enqueues ahead of the card, so its own
    time per call is hidden), divided by the count."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def kernel_ms(fn: Callable, trace: Path, reps: int = 5) -> Dict[str, float]:
    """Device time of one fn() call [ms] by device kernel (``total`` for
    all), from a torch.profiler trace over ``reps`` calls written to
    ``trace``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    by = {"total": 0.0}
    for e in json.loads(trace.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memset",
                                                   "gpu_memcpy"):
            name = re.sub(r"\(anonymous namespace\)::", "", e["name"])[:48]
            ms = e["dur"] / reps / 1e3
            by[name] = by.get(name, 0.0) + ms
            by["total"] += ms
    return by


def device_kernels(fn: Callable, calls: int = 4) -> Dict[str, float]:
    """Device kernels one fn() call starts, by name (namespace, template
    arguments and parameters stripped), from a torch.profiler trace of
    ``calls`` calls; copies and fills are not counted."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    count: Dict[str, float] = {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name.startswith(("Memcpy", "Memset"))):
            continue
        name = re.sub(r"\(anonymous namespace\)::", "", e.name)
        name = re.split(r"[<(]", name)[0].split()[-1]
        count[name] = count.get(name, 0) + 1 / calls
    return count


def ptxas(source: Path, flags: Sequence[str]
          ) -> Tuple[Dict[str, dict], str, Path]:
    """Registers, shared bytes and spills of each kernel of ``source``
    (``nvcc -Xptxas -v``): ({mangled name: report}, log, cubin)."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / (source.stem + "_ptxas.cubin")
    cmd = [_build.nvcc(), *_build.ARCH, "-std=c++17", "-O3",
           "-split-compile=0", "-cubin", "-Xptxas", "-v", *flags, "-I",
           str(_build.CSRC), "-o", str(out), str(source)]
    log = subprocess.run(cmd, capture_output=True, text=True, check=True)
    text = log.stdout + log.stderr
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            # the spill line comes first: keep it
            kernels.setdefault(name, {}).update(
                regs=int(m.group(1)),
                smem=int(smem.group(1)) if smem else 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            kernels.setdefault(name, {})["spill"] = [int(m.group(1)),
                                                     int(m.group(2))]
    return kernels, text, out


def load_mix(cubin: Path, pattern: str) -> dict:
    """Counts of load opcodes (LDG global, LDS shared, LD generic) in the
    SASS of the kernels whose name matches ``pattern``."""
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


# SASS opcodes by class (the root before the first '.')
SASS_CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FMNMX", "FCHK", "FSWZADD", "FSET"),
    "mufu": ("MUFU",),
    "compare": ("FSETP", "ISETP", "PLOP3", "DSETP", "VOTE", "VOTEU"),
    "select": ("FSEL", "SEL"),
    "integer": ("IMAD", "IADD3", "IADD", "LEA", "LOP3", "SHF", "SHL", "SHR",
                "IMNMX", "IABS", "PRMT", "POPC", "FLO", "BMSK", "BREV",
                "IDP", "LOP", "UIADD3", "UIMAD", "ULEA", "ULOP3", "USHF",
                "USEL", "UISETP", "UPRMT"),
    "load": ("LDG", "LD", "LDS", "LDC", "LDL", "ULDC", "LDGSTS", "LDSM"),
    "store": ("STG", "ST", "STS", "STL", "RED", "ATOM", "ATOMG"),
    "conversion": ("F2I", "I2F", "F2F", "FRND", "F2FP", "I2FP", "F2IP"),
    "control": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "WARPSYNC",
                "BAR", "YIELD", "JMP", "BREAK", "BPT", "NANOSLEEP", "KILL"),
    "move": ("MOV", "S2R", "S2UR", "CS2R", "P2R", "R2P", "UMOV", "R2UR",
             "SHFL", "MOVM"),
}
_SASS_CLASS = {op: c for c, ops in SASS_CLASSES.items() for op in ops}
_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_]*)"
    r"([^;]*);")


def sass_loop_mix(cubin: Path, pattern: str,
                  dump: Optional[Path] = None) -> dict:
    """The SASS of the first kernel whose mangled name matches ``pattern``,
    by class (``SASS_CLASSES``; NOPs left out): ``kernel`` the whole
    function, ``loop`` the body of its largest loop (from the target of a
    backward branch to the branch, the code a trip issues with the branches
    inside it counted once each), ``loops`` the number of backward
    branches, ``inner`` each innermost loop's body (one holding no other
    loop) in address order, with its global and shared loads and stores
    and asynchronous copies (``LDG``, ``STG``, ``LDS``, ``STS``,
    ``LDGSTS``). A static count: a block a branch skips on most trips is
    counted as if it ran. ``dump``: a file for the function's SASS."""
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    code, text, name, on = [], [], None, False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if on:
                break
            on = re.search(pattern, m.group(1)) is not None
            name = m.group(1) if on else None
            continue
        if not on:
            continue
        text.append(line)
        m = _SASS_LINE.search(line)
        if m and m.group(2) != "NOP":
            code.append((int(m.group(1), 16), m.group(2), m.group(3)))
    if not code:
        raise RuntimeError(f"no kernel matching {pattern!r} in {cubin}")
    if dump is not None:
        dump.parent.mkdir(parents=True, exist_ok=True)
        dump.write_text(name + "\n" + "\n".join(text) + "\n")

    def mix(ops):
        out = {c: 0 for c in SASS_CLASSES}
        out["other"] = 0
        for op in ops:
            out[_SASS_CLASS.get(op, "other")] += 1
        out["total"] = len(ops)
        return out

    loops, spans = [], []
    for i, (addr, op, args) in enumerate(code):
        m = re.search(r"0x([0-9a-f]+)", args)
        if op == "BRA" and m and int(m.group(1), 16) < addr:
            start = int(m.group(1), 16)
            loops.append([o for a, o, _ in code if start <= a <= addr])
            spans.append((start, addr, loops[-1]))
    body = max(loops, key=len) if loops else []
    inner = [dict(mix(ops), **{k: ops.count(k) for k in (
                 "LDG", "STG", "LDS", "STS", "LDGSTS")})
             for lo, hi, ops in sorted(spans)
             if not any((l2, h2) != (lo, hi) and lo <= l2 and h2 <= hi
                        for l2, h2, _ in spans)]
    return {"name": name, "kernel": mix([o for _, o, _ in code]),
            "loop": mix(body), "loops": len(loops), "inner": inner}


# Text substitutions that fold a kernel's runtime switches to one path's
# values, for counting that path's SASS (``variant`` + ``sass_loop_mix``):
# K1's and K17's core (march_core.cuh) on rk2 with slab weights, the mesh
# path's; K7 (analytic.cu) on rk2 and on rk4; K19 (pack_chain.cu) has none
# to fold (its instances are its layouts and table types)
FOLDS = {
    "core_rk2_slab": [
        ("  const bool rk4 = P.integrator == RK4;",
         "  const bool rk4 = false;"),
        ("  if (P.slab_weights) slab_weights(P, X, s, ws);",
         "  slab_weights(P, X, s, ws);"),
        ("  if (P.slab_weights) {", "  if (true) {"),
        ("  if (P.integrator == RK2S4) {", "  if (false) {"),
        ("  } else if (P.integrator == RK2S2) {", "  } else if (false) {")],
    "k7_rk2": [("    if (!P.rk4) {", "    if (true) {")],
    "k7_rk4": [("    if (!P.rk4) {", "    if (false) {")],
    "k19": [],
}


def sm_clock_mhz() -> float:
    """The card's highest SM clock [MHz] (``nvidia-smi clocks.max.sm``)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


def static_issue_ms(instructions: float, units: float, sms: int,
                    clock_mhz: float) -> float:
    """The time [ms] to issue ``instructions`` SASS instructions for each
    of ``units`` threads' work items at one instruction a lane a clock: 4
    schedulers of 32 lanes on each of ``sms`` SMs at ``clock_mhz``. Fed a
    static count (``sass_loop_mix``, which counts every block of a loop
    body as if each trip ran it), it is an estimate, not a floor: a kernel
    whose trips skip blocks (an out-of-box path, a division's slow-path
    call) can run under it."""
    return instructions * units / (sms * 4 * 32 * clock_mhz * 1e6) * 1e3


def _inline_headers(text: str, seen: set) -> str:
    """``text`` with each ``#include "x.cuh"`` of ``csrc/`` replaced by the
    header's text, once per header (``#pragma once``)."""
    def sub(m):
        name = m.group(1)
        if name in seen:
            return ""
        seen.add(name)
        body = (_build.CSRC / name).read_text().replace("#pragma once", "")
        return _inline_headers(body, seen)

    return re.sub(r'^#include "([^"]+\.cuh)"[ \t]*$', sub, text,
                  flags=re.M)


def variant(kernel: _build.Kernel, name: str,
            subs: Sequence[Tuple[str, str]],
            flags: Optional[Sequence[str]] = None) -> _build.Kernel:
    """A build of ``kernel``'s source with the text substitutions ``subs``
    (each must match) and ``flags`` (default: the kernel's own)."""
    text = (_build.CSRC / kernel.source).read_text()
    for a, b in subs:
        if a not in text:
            # the text may be in a header the source shares (march_core.cuh)
            text = _inline_headers(text, set())
        if a not in text:
            raise RuntimeError(f"variant {name}: {a!r} not in the source")
        text = text.replace(a, b)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"{Path(kernel.source).stem}_{name}.cu"
    path.write_text(text)
    return _build.Kernel(str(path), kernel.functions,
                         kernel.flags if flags is None else flags)


@contextlib.contextmanager
def kernel_of(module, kernel: _build.Kernel):
    """Launch ``module``'s wrappers through another build of its source."""
    shipped = module.KERNEL
    module.KERNEL = kernel
    try:
        yield
    finally:
        module.KERNEL = shipped


# -- K13's load model (kernels/boris.py) -------------------------------------

# the corners' node offsets (dx, dy, dz) in the kernel's order q = 4 dx +
# 2 dy + dz, the trilinear weights' order
CORNERS = tuple((q >> 2, (q >> 1) & 1, q & 1) for q in range(8))
# the corners on the upper side of each axis (x, y, z), as bit masks of q
UPPER = (0xF0, 0xCC, 0xAA)
WARP = 32


def node_offsets(shape: Sequence[int]) -> List[int]:
    """The elements from a cell's first node (i, j, k) to its eight corner
    nodes (q order) in an (nx, ny, nz, 3) table: the kernel's 32-bit
    offsets a * 3 ny nz + b * 3 nz + 3 c (``boris.launch`` refuses a
    table where they do not fit an int)."""
    ny, nz = int(shape[1]), int(shape[2])
    return [a * 3 * ny * nz + b * 3 * nz + 3 * c for a, b, c in CORNERS]


def corners_to_read(old: Sequence[int], new: Sequence[int]) -> int:
    """The corners (a bit mask of q) the kernel reads on moving its carried
    corners from cell ``old`` to cell ``new`` (each (i, j, k)): along an
    axis that moved by one, the side that came in; on a larger move, all.
    (The kernel carries (-2, -2, -2) before its first in-grid step.)"""
    need = 0
    for axis in range(3):
        d = new[axis] - old[axis]
        up = UPPER[axis]
        need |= (0 if d == 0 else up if d == 1 else (~up & 0xFF)
                 if d == -1 else 0xFF)
    return need


def _move_tables(dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """(3, 5) ``corners_to_read`` of a move of d (-2 .. 2, index d + 2;
    beyond two reads as two) along each axis alone, and the popcount of
    each of the 256 masks."""
    tables = torch.tensor([[corners_to_read((0, 0, 0), [
        d if a == axis else 0 for a in range(3)]) for d in range(-2, 3)]
        for axis in range(3)], device=dev)
    popcount = torch.tensor([bin(m).count("1") for m in range(256)],
                            device=dev)
    return tables, popcount


def walk_model(rows: torch.Tensor, shape: Sequence[int],
               origin: Sequence[float], inv_spacing: Sequence[float],
               h: float, n_steps: int, elem_size: int,
               order: Optional[torch.Tensor] = None, every: int = 16
               ) -> Dict[str, float]:
    """A model of K13's corner reads along straight lines (no deflection):
    the protons of (N, 6) ``rows`` in ``order`` (None: the rows' own),
    warps of 32 lanes, midpoints x + (2 s + 1) h v. Counts the
    in-grid lane-steps, the nodes this design reads (``corners_to_read``
    per lane) and the load instructions an in-grid step takes (3 a node;
    the first design read all 8 nodes, 24); on every ``every``-th step,
    the distinct 32-byte sectors of each warp load instruction's active
    lanes (a table at a 256-byte boundary, ``elem_size`` bytes an
    element), in this design (the lanes that read the node) and in the
    first (every in-grid lane)."""
    dev = rows.device
    r = rows if order is None else rows[order]
    n = r.shape[0] // WARP * WARP
    r = r[:n].double()
    x0, v = r[:, :3], r[:, 3:]
    o = torch.tensor([float(a) for a in origin], dtype=torch.float64,
                     device=dev)
    inv = torch.tensor([float(a) for a in inv_spacing], dtype=torch.float64,
                       device=dev)
    dims = torch.tensor(list(shape), dtype=torch.float64, device=dev)
    ny, nz = int(shape[1]), int(shape[2])
    tables, popcount = _move_tables(dev)
    offs = torch.tensor(node_offsets(shape), device=dev)
    key = torch.full((n, 3), -2, dtype=torch.long, device=dev)
    in_grid = reads = 0
    acc = {"design": [0, 0], "first": [0, 0]}   # [sectors, instructions]
    warp_steps = 0

    def sectors(elem, active):
        """Distinct sectors of each warp's active lanes; (sum, warps with
        an active lane)."""
        sec = torch.where(active, elem * elem_size // 32,
                          torch.full_like(elem, -1)).view(-1, WARP)
        s = sec.sort(dim=1).values
        d = (s[:, :1] >= 0).sum(1) + ((s[:, 1:] != s[:, :-1])
                                      & (s[:, 1:] >= 0)).sum(1)
        return int(d.sum()), int((d > 0).sum())

    for step in range(n_steps):
        t = (x0 + (2 * step + 1) * h * v - o) * inv
        inside = ((t >= 0) & (t <= dims - 1)).all(dim=1)
        if not bool(inside.any()):
            continue
        cell = torch.minimum(torch.floor(t).nan_to_num(0.0).clamp_min(0),
                             dims - 2).long()
        d = (cell - key).clamp(-2, 2) + 2
        need = (tables[0][d[:, 0]] | tables[1][d[:, 1]]
                | tables[2][d[:, 2]]) * inside
        key = torch.where(inside[:, None], cell, key)
        in_grid += int(inside.sum())
        reads += int(popcount[need].sum())
        if step % every:
            continue
        warp_steps += int(inside.view(-1, WARP).any(dim=1).sum())
        first = 3 * ((cell[:, 0] * ny + cell[:, 1]) * nz + cell[:, 2])
        for q in range(8):
            act = inside & ((need >> q) & 1).bool()
            for m in range(3):
                for k, lanes in (("design", act), ("first", inside)):
                    a, b = sectors(first + offs[q] + m, lanes)
                    acc[k][0] += a
                    acc[k][1] += b
    out = {"protons": n, "in_grid_lane_steps": in_grid,
           "node_reads": reads,
           "loads_per_in_grid_step": 3 * reads / max(in_grid, 1),
           "first_loads_per_in_grid_step": 24.0,
           "sampled_warp_steps": warp_steps}
    for k, (sec, ins) in acc.items():
        out[f"{k}_sectors_per_warp_load"] = sec / max(ins, 1)
        out[f"{k}_sectors_per_warp_step"] = sec / max(warp_steps, 1)
    return out


# -- K5's load model (kernels/time_march.py) ---------------------------------

class CornerWalk:
    """The carried corners of ``n`` lanes as K5's gather keeps them
    (``time_rhs.cuh`` ``trilinear_carried``) on an (nx, ny, nz, C) grid:
    ``visit`` takes the lanes' (n, 3) float32 gather points, computes the
    fractional index, the inside mask and the corner cell in float32 as
    the kernel does, and returns the corners (a bit mask of q, as
    ``corners_to_read``) each lane reads; a point outside the box reads
    nothing and keeps the lane's carry. Before its first in-grid point a
    lane carries (-2, -2, -2)."""

    def __init__(self, n: int, shape: Sequence[int], origin, inv_spacing,
                 device=None):
        self.o = torch.tensor([float(a) for a in origin],
                              dtype=torch.float32, device=device)
        self.inv = torch.tensor([float(a) for a in inv_spacing],
                                dtype=torch.float32, device=device)
        self.top = torch.tensor([float(v - 1) for v in shape[:3]],
                                dtype=torch.float32, device=device)
        self.key = torch.full((n, 3), -2, dtype=torch.long, device=device)
        self.tables, self.popcount = _move_tables(device)

    def visit(self, pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the corners each lane reads, the lanes inside the box) at the
        (n, 3) points ``pos``."""
        t = (pos.to(torch.float32) - self.o) * self.inv
        inside = ((t >= 0) & (t <= self.top)).all(dim=1)
        cell = torch.minimum(torch.floor(t).nan_to_num(0.0),
                             self.top - 1).long()
        d = (cell - self.key).clamp(-2, 2) + 2
        need = (self.tables[0][d[:, 0]] | self.tables[1][d[:, 1]]
                | self.tables[2][d[:, 2]]) * inside
        self.moved = (cell != self.key) & inside[:, None]
        self.key = torch.where(inside[:, None], cell, self.key)
        return need, inside


def time_walk_model(rows: torch.Tensor, channels: torch.Tensor, origin,
                    inv_spacing, dt, *, layout, n_steps: int,
                    atten_sign: float = -1.0,
                    order: Optional[torch.Tensor] = None
                    ) -> Dict[str, float]:
    """A model of K5's corner reads along the plain march's stage points:
    the (N, 9) ``rows`` in ``order`` (None: the rows' own) marched by
    ``time_march.march_plain``'s arithmetic, each of the 4 stage points of
    every step visited by a ``CornerWalk``. Counts the in-grid
    lane-stages, the nodes the carried gather reads and its loads (C a
    node; the first design read all 8 nodes, 8C loads, at every in-grid
    stage), and, for warps of 32 lanes, the share of warp-stages in which
    some lane reads and in which some lane shifts along z, y or x (a warp
    issues a read or a shift when any of its lanes needs it)."""
    from synthpy_tpu_torch.kernels.time_march import Steps, rhs
    from synthpy_tpu_torch.ops.interp import fma

    r = rows if order is None else rows[order]
    n = r.shape[0] // WARP * WARP
    s = r[:n].contiguous()
    dev = s.device
    C = layout.n_channels
    st = Steps.of(dt)
    o = torch.tensor(np.asarray(origin, np.float32), device=dev)
    inv = torch.tensor(np.asarray(inv_spacing, np.float32), device=dev)
    walk = CornerWalk(n, channels.shape, origin, inv_spacing, dev)
    # in-grid lane-stages, node reads, warp-stages with a lane inside, with
    # a lane reading, with a lane shifting along x, y, z (on the device)
    tally = torch.zeros(7, dtype=torch.long, device=dev)

    def f(x):
        need, inside = walk.visit(x[:, 0:3])
        warps = torch.stack([inside, need > 0, *walk.moved.T]).view(
            5, -1, WARP).any(2).sum(1)
        tally.add_(torch.cat([inside.sum()[None],
                              walk.popcount[need].sum()[None], warps]))
        return rhs(x, channels, o, inv, layout, atten_sign)

    for _ in range(n_steps):
        k1 = f(s)
        k2 = f(fma(st.hh, k1, s))
        k3 = f(fma(st.hh, k2, s))
        k4 = f(fma(st.dt, k3, s))
        s = fma(st.h6, k1 + 2 * k2 + 2 * k3 + k4, s)
    in_grid, reads, warp_in, warp_read, *shift = tally.tolist()
    g, w = max(in_grid, 1), max(warp_in, 1)
    return {"rays": n, "steps": n_steps, "C": C,
            "in_grid_lane_stages": in_grid,
            "node_reads": reads,
            "nodes_per_in_grid_stage": reads / g,
            "loads_per_in_grid_stage": C * reads / g,
            "loads_per_in_grid_step": 4 * C * reads / g,
            "first_loads_per_in_grid_stage": 8 * C,
            "first_loads_per_in_grid_step": 32 * C,
            "warp_stages_reading": warp_read / w,
            "warp_stages_shifting_zyx": [v / w for v in shift[::-1]]}


# -- K4's load model (kernels/slab_march.py) ---------------------------------

# slab_march.cu's stage modes (Mode there)
PLANE0, PLANE1, MID, LERP = range(4)


class SlabWalk:
    """K4's two carried planes (``slab_march.cu`` ``Corners`` X, plane k,
    and Y, plane k + 1) for ``n`` lanes on (na, nb) planes. ``new_slab``
    moves Y's cell to X and empties Y; ``visit`` takes the lanes' (n, 8)
    stage states and the stage's mode, computes the fractional index, the
    inside test and the clamped cell in float32 as the kernel does, and
    returns the nodes each lane reads for X and for Y: none where the
    plane's carried cell is the stage's, all four where it moved (a point
    outside reads nothing and keeps the carry)."""

    def __init__(self, n: int, na: int, nb: int, origin_ab, inv_ab,
                 device=None):
        self.o = [float(np.float32(v)) for v in origin_ab]
        self.inv = [float(np.float32(v)) for v in inv_ab]
        self.na, self.nb = na, nb
        self.x = torch.full((n, 2), -2, dtype=torch.long, device=device)
        self.y = self.x.clone()

    def new_slab(self) -> None:
        self.x = self.y
        self.y = torch.full_like(self.x, -2)

    @staticmethod
    def _move(key, cell, inside):
        moved = (cell != key).any(dim=1) & inside
        return 4 * moved.long(), torch.where(inside[:, None], cell, key)

    def visit(self, u: torch.Tensor, mode: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(nodes read for X, nodes read for Y, lanes inside)."""
        u = u.to(torch.float32)
        ta = (u[:, 0] - self.o[0]) * self.inv[0]
        tb = (u[:, 1] - self.o[1]) * self.inv[1]
        inside = ((ta >= 0) & (ta <= self.na - 1) & (tb >= 0)
                  & (tb <= self.nb - 1))
        cell = torch.stack([
            torch.minimum(torch.floor(ta).nan_to_num(0.0),
                          torch.tensor(float(self.na - 2))),
            torch.minimum(torch.floor(tb).nan_to_num(0.0),
                          torch.tensor(float(self.nb - 2)))], 1).long()
        nx = ny = torch.zeros_like(inside, dtype=torch.long)
        if mode != PLANE1:
            nx, self.x = self._move(self.x, cell, inside)
        if mode != PLANE0:
            ny, self.y = self._move(self.y, cell, inside)
        return nx, ny, inside


def slab_walk_model(u: torch.Tensor, planes: torch.Tensor, origin_ab,
                    inv_ab, dp, *, layout, n_slabs: int, substeps: int = 1,
                    atten_sign: float = -1.0,
                    order: Optional[torch.Tensor] = None
                    ) -> Dict[str, float]:
    """A model of K4's corner reads along the plain march's stage points:
    the (N, 8) permuted states ``u`` in ``order`` (None: their own)
    marched by ``slab_march.march_plain``'s arithmetic, each stage visited
    by a ``SlabWalk``. Counts the in-grid lane-slabs (a stage inside),
    the values the carried design reads there (C a node) beside those the
    first design read along the same stages (4 nodes of one plane for k1
    and k4, of two planes for the midpoint stages: 24C a slab inside), and,
    for warps of 32 lanes, the share of warp-slabs (with a lane inside) in
    which some lane reads more than plane k + 1's four nodes once."""
    from synthpy_tpu_torch.kernels.slab_march import _f32, _steps, deriv

    r = u if order is None else u[order]
    n = r.shape[0] // WARP * WARP
    uc = r[:n].contiguous()
    dev = uc.device
    C = layout.n_channels
    oab = [_f32(v) for v in origin_ab]
    iab = [_f32(v) for v in inv_ab]
    h, hh, h6 = _steps(dp, substeps)
    walk = SlabWalk(n, planes.shape[1], planes.shape[2], oab, iab, dev)
    # in-grid lane-slabs, nodes read, nodes the first design read,
    # warp-slabs with a lane inside, with a lane reading beyond plane k+1
    tally = torch.zeros(5, dtype=torch.long, device=dev)
    slab = {}

    def d(uu, pl, mode):
        nx, ny, inside = walk.visit(uu, mode)
        slab["x"] += nx
        slab["y"] += ny
        slab["in"] |= inside
        slab["first"] += inside.long() * (8 if mode in (MID, LERP) else 4)
        return deriv(uu, pl, oab, iab, layout, atten_sign)

    def step(uc, p0, ph, p1, m0, mh, m1):
        k1 = d(uc, p0, m0)
        k2 = d(uc + hh * k1, ph, mh)
        k3 = d(uc + hh * k2, ph, mh)
        k4 = d(uc + h * k3, p1, m1)
        return uc + h6 * (k1 + 2 * k2 + 2 * k3 + k4)

    for k in range(n_slabs):
        walk.new_slab()
        zero = torch.zeros(n, dtype=torch.long, device=dev)
        slab.update(x=zero, y=zero.clone(), first=zero.clone(),
                    **{"in": torch.zeros(n, dtype=torch.bool, device=dev)})
        w0, w1 = planes[k], planes[k + 1]
        if substeps == 1:
            uc = step(uc, w0, 0.5 * (w0 + w1), w1, PLANE0, MID, PLANE1)
        else:
            dw = (w1 - w0).to(torch.float32)
            w0f = w0.to(torch.float32)
            S = np.float32(substeps)
            for j in range(substeps):
                fj = np.float32(j)
                uc = step(uc, w0f + float(fj / S) * dw,
                          w0f + float((fj + np.float32(0.5)) / S) * dw,
                          w0f + float((fj + np.float32(1.0)) / S) * dw,
                          LERP, LERP, LERP)
        beyond = (slab["x"] > 0) | (slab["y"] > 4)
        warps = torch.stack([slab["in"], beyond]).view(2, -1, WARP).any(2)
        tally.add_(torch.stack([
            slab["in"].sum(), (slab["x"] + slab["y"]).sum(),
            slab["first"].sum(), *warps.sum(1)]))
    in_grid, reads, first, warp_in, warp_beyond = tally.tolist()
    g = max(in_grid, 1)
    return {"rays": n, "slabs": n_slabs, "substeps": substeps, "C": C,
            "in_grid_lane_slabs": in_grid, "node_reads": reads,
            "nodes_per_in_grid_slab": reads / g,
            "loads_per_in_grid_slab": C * reads / g,
            "first_loads_per_in_grid_slab": C * first / g,
            "first_loads_per_slab_inside": (24 if substeps == 1
                                            else 32 * substeps) * C,
            "warp_slabs_beyond_plane_k1": warp_beyond / max(warp_in, 1)}
