"""Timing, ptxas reports and source variants of the CUDA kernels, shared by
``chip_smoke.py`` and the root profilers (``march_profile.py``,
``pack_profile.py``). Nothing in the package calls it; everything here
needs a CUDA device or ``nvcc`` when it is called, not when it is
imported.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

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
