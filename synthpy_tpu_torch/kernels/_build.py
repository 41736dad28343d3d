"""Build the CUDA sources in ``csrc/`` at first use and load them.

Each source has a plain C interface and becomes one shared library,
compiled by ``nvcc`` for ``sm_90a`` into ``kernels/_build/`` (git-ignored)
and loaded with ``ctypes``. A library is named by a hash of its source and
flags, so an edited source is rebuilt and an unchanged one is reused.
Fast-math is never used: the quantiser's rounding and the detector's bin
edges depend on IEEE division and square root.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -split-compile=0 optimises a source's kernels on all cores: march.cu, 32
# template instances, builds in ~20 s instead of ~45 s on the H100 host
BASE_FLAGS = ["-std=c++17", "-O3", "-split-compile=0", "-shared",
              "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return path


def _target(source: str, flags: Sequence[str]) -> Path:
    # the shared headers are part of every source's key
    text = (CSRC / source).read_bytes() + " ".join(flags).encode()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    key = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{key}.so"


def _command(source: str, flags: Sequence[str], out: Path):
    return [nvcc(), *ARCH, *BASE_FLAGS, *flags, "-I", str(CSRC), "-o",
            str(out), str(CSRC / source)]


def build(specs: Dict[str, Sequence[str]]) -> Dict[str, Path]:
    """Compile every {source: extra flags} that is not built yet, all
    ``nvcc`` processes at once; returns {source: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {s: _target(s, f) for s, f in specs.items()}
    procs = {}
    for s, f in specs.items():
        if out[s].exists():
            continue
        tmp = out[s].with_suffix(f".{os.getpid()}.tmp")
        procs[s] = (tmp, subprocess.Popen(
            _command(s, f, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    errors = []
    for s, (tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{s}: nvcc exited {p.returncode}\n{log}")
        else:
            os.replace(tmp, out[s])
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return out


class Kernel:
    """One CUDA source: built and loaded at first launch, with a count of
    the launches made through it.

    ``functions`` maps each exported C function to its argument types; each
    returns the ``cudaError_t`` of its launches (0 when all launched).
    ``helpers``: host functions of the source that launch nothing (no
    stream argument), with their argument types; each returns an int.
    ``events``: None, or a list to which each launch appends its (start,
    end) CUDA events, recorded on its stream, for timing a launch where a
    caller makes it (off by default).
    """

    def __init__(self, source: str, functions: Dict[str, Sequence],
                 flags: Sequence[str] = (),
                 helpers: Optional[Dict[str, Sequence]] = None):
        self.source = source
        self.functions = functions
        self.helpers = dict(helpers or {})
        self.flags = list(flags)
        self.launches = 0
        self.events = None
        self._lib = None

    def load(self):
        if self._lib is None:
            path = build({self.source: self.flags})[self.source]
            lib = ctypes.CDLL(str(path))
            for name, argtypes in {**self.functions,
                                   **self.helpers}.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def launch(self, name: str, device, *args) -> None:
        """Call C function ``name`` with ``args`` and, last, the current
        CUDA stream of ``device``, with ``device`` the current device (a
        launch on another card's stream fails); raise if it reports an
        error."""
        if len(args) + 1 != len(self.functions[name]):
            raise TypeError(f"{self.source}:{name} takes "
                            f"{len(self.functions[name]) - 1} arguments "
                            f"and the stream, not {len(args)}")
        fn = getattr(self.load(), name)
        stream = torch.cuda.current_stream(device)
        if self.events is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record(stream)
        with torch.cuda.device(device):
            rc = fn(*args, stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.source}:{name} failed to launch "
                               f"(cudaError {rc})")
        if self.events is not None:
            ev[1].record(stream)
            self.events.append(tuple(ev))
        self.launches += 1


def refuse_grad(what: str, *tensors) -> None:
    """Raise ``NotImplementedError`` when autograd is on and a tensor not on
    the CPU requires grad. A ctypes launch records no ``grad_fn``, so the
    kernel's result would be cut from the graph without a word; on the CPU
    the plain versions run and autograd flows through them, so CPU tensors
    pass. ``None`` entries are skipped."""
    if not torch.is_grad_enabled():
        return
    for t in tensors:
        if (isinstance(t, torch.Tensor) and t.requires_grad
                and t.device.type != "cpu"):
            raise NotImplementedError(
                f"{what} has no backward on the card: a tensor that "
                "requires grad would be cut from the graph (ROADMAP "
                "Residuals (no backward))")
