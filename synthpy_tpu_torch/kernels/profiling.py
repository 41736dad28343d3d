"""Timing, ptxas reports and source variants of the CUDA kernels, and K13's
load model, shared by ``chip_smoke.py`` and the root profilers
(``march_profile.py``, ``pack_profile.py``). Nothing in the package calls
it; everything here but the load model needs a CUDA device or ``nvcc``
when it is called, not when it is imported.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
    # corners_to_read of a move of d (-2 .. 2) along each axis alone
    tables = torch.tensor([[corners_to_read((0, 0, 0), [
        d if a == axis else 0 for a in range(3)]) for d in range(-2, 3)]
        for axis in range(3)], device=dev)
    popcount = torch.tensor([bin(m).count("1") for m in range(256)],
                            device=dev)
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
