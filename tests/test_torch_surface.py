"""The port's surface: what it imports, where it runs, how it refuses.

* no module of synthpy_tpu_torch, and not chip_smoke.py, imports JAX or
  the JAX package;
* entry points default to CUDA and raise on a host without a card;
* kernel wrappers never fall back to their plain versions for a tensor
  that is not on the CPU;
* chip_smoke.py fails without a card, and alone in a directory.
"""

import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import synthpy_tpu_torch
from synthpy_tpu_torch.kernels import _build

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    names = ["synthpy_tpu_torch"]
    for m in pkgutil.walk_packages(synthpy_tpu_torch.__path__,
                                   "synthpy_tpu_torch."):
        names.append(m.name)
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'synthpy_tpu.'))\n"
        "             or m == 'synthpy_tpu')\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(_modules()) >= 20


def test_sources_carry_their_note_and_build_flags():
    for src in ("march.cu", "pack.cu", "detector.cu", "analytic.cu",
                "deposit.cu", "fill.cu", "random.cu", "march_adjoint.cu",
                "cic.cu", "boris.cu", "btable.cu", "xray.cu",
                "march_sharded.cu", "sharded_rhs.cu"):
        text = (_build.CSRC / src).read_text()
        assert "Replaces" in text and "bounds it on the H100" in text, src
        assert "synthpy_tpu/" in text, src
    cmd = " ".join(_build.ARCH + _build.BASE_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "fast-math" not in cmd and "fast_math" not in cmd


def test_kernel_argtypes_match_the_c_entry_points():
    """Each wrapper's ctypes signature has as many arguments as its C entry
    point, the stream last (a missing pointer type would pass the stream
    as a 32-bit int); each host helper's as many as its C function."""
    import re

    from synthpy_tpu_torch.kernels import (adaptive, analytic, binning,
                                           boris, btable, cic, deposit,
                                           detector, fill, march,
                                           march_adjoint, march_sharded,
                                           pack, random, sharded_rhs,
                                           slab_march, time_march, xray)

    kernels = [m.KERNEL for m in (adaptive, analytic, boris, btable, cic,
                                  deposit, detector, fill, march,
                                  march_adjoint, march_sharded, pack,
                                  random, sharded_rhs, slab_march,
                                  time_march)]
    kernels += [detector.FIELD_KERNEL, binning.BIN_KERNEL,
                binning.BIN_FIELD_KERNEL, cic.BACKWARD_KERNEL,
                xray.FOLD_KERNEL, xray.PP_FOLD_KERNEL,
                xray.PP_CHORDS_KERNEL, march_sharded.EXCHANGE_KERNEL]
    seen = set()
    for k in kernels:
        text = (_build.CSRC / k.source).read_text()
        macros = {m.group(1): m.group(2).replace("\\\n", " ")
                  for m in re.finditer(r"#define (\w+)\s+((?:.*\\\n)*.*)",
                                       text)}
        for name, argtypes in k.functions.items():
            m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
            assert m, (k.source, name)
            params = [a for p in m.group(1).split(",")
                      for a in macros.get(p.strip(), p).split(",")
                      if a.strip()]
            assert len(params) == len(argtypes), (name, len(params),
                                                  len(argtypes))
            assert params[-1].split()[-1] == "stream", name
            seen.add(name)
        for name, argtypes in k.helpers.items():
            m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
            assert m, (k.source, name)
            params = [p for p in m.group(1).split(",") if p.strip()]
            assert len(params) == len(argtypes), (name, len(params),
                                                  len(argtypes))
            seen.add(name)
    assert {"analytic_march", "detect_field", "detect_image", "bin_image",
            "bin_field", "deposit_cic", "pack_fill", "random_draw",
            "march_adjoint", "cic_deposit", "cic_adjoint", "boris_push",
            "btable_write", "xray_fold", "pp_fold", "pp_chords",
            "march_shards", "exchange_rows", "stage_gather",
            "sharded_trace_fill", "k3_plan"} <= seen


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from synthpy_tpu_torch import convert
    from synthpy_tpu_torch.fields import ScalarDomain
    from synthpy_tpu_torch.tracer import init_beam

    for call in (lambda: ScalarDomain(1e-2, 9),
                 lambda: init_beam(0, 16, 1e-3, 0.0, 5e-3),
                 lambda: convert.tensor(np.zeros(3))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert ScalarDomain(1e-2, 9, device="cpu").device.type == "cpu"


def test_wrappers_do_not_fall_back_off_the_cpu():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present: the wrappers would build and launch")
    from synthpy_tpu_torch.fields.domain import ChannelLayout
    from synthpy_tpu_torch.fields.forms import ClosedForm
    from synthpy_tpu_torch.kernels import (analytic, binning, boris, btable,
                                           cic, deposit, detector, fill,
                                           march, march_adjoint,
                                           march_sharded, pack, sharded_rhs,
                                           xray)
    from synthpy_tpu_torch.kernels import random as kernel_random
    from synthpy_tpu_torch.kernels.time_march import Steps
    from synthpy_tpu_torch.ops import fresnel, histogram

    meta = torch.device("meta")
    u = torch.empty((8, 8), device=meta)
    table = torch.empty((1, 9, 9 * 3), device=meta)
    x = torch.empty(8, device=meta)
    e = torch.empty(8, dtype=torch.complex64, device=meta)
    c = torch.empty(5, device=meta)
    lay = ChannelLayout(False, False, False)
    calls = [
        lambda: march.march(u, table, None, shape_ab=(3, 3),
                            origin_ab=(0.0, 0.0), inv_ab=(1.0, 1.0),
                            dp=1.0, layout=lay, K=8),
        lambda: detector.detect(u, 1.0, 1.0, "z", [("aperture", 1.0)],
                                (4, 4), ((-1.0, 1.0), (-1.0, 1.0))),
        lambda: pack.quantize_tables(table, 8, 3, 8),
        lambda: pack.decimate_tables(table, 8, 3, 2),
        lambda: analytic.march(u, ClosedForm("lens", ne_0=1e24, LR=1e-3),
                               None, layout=lay, axes=(0, 1, 2),
                               bounds=([-1.0] * 3, [1.0] * 3), omega=1e15,
                               lwl=1e-6, p0=-1.0, h=0.5, n_steps=4),
        lambda: detector.detect_field(u, 1.0, 1.0, "z", [("phase",)],
                                      (4, 4), 2.0, 2.0, 1e-6),
        # a stage table longer than the kernel takes by value
        lambda: detector.detect(u, 1.0, 1.0, "z", [("aperture", 1.0)] * 40,
                                (4, 4), ((-1.0, 1.0), (-1.0, 1.0))),
        lambda: histogram.histogram2d(x, x, (4, 4), ((-1.0, 1.0),
                                                     (-1.0, 1.0))),
        lambda: histogram.histogram2d(x, x, (4, 4), ((-1.0, 1.0),
                                                     (-1.0, 1.0)), weights=x),
        lambda: histogram.complex_histogram(x, x, e, e, 5, 5, 2.0, 2.0),
        lambda: histogram.deposit_cic(x, x, x, c, c),
        lambda: histogram.deposit_cic(x, x, e, c, c),
        lambda: fresnel.propagate(1e-6, c, c, 1.0, 1.0, u[:4], x, x, 0.1),
        lambda: pack.quantize_tables(table, 8, 3, 8, dither=(0, 7)),
        lambda: kernel_random.draw((0, 7), 8, "normal", device=meta),
        lambda: fill.fill(
            torch.empty((1, 9, 9 * 3), dtype=torch.int8, device=meta),
            torch.empty((1, 9, 3), device=meta),
            torch.empty((4, 3, 3), device=meta),
            torch.empty((2, 0, 3, 3), device=meta), g0=0, seg_i=0, col0=0,
            k0=0, pb=2, lone=False, mode=2, layout=lay, n_p=9, pref=-1.0,
            da=1.0, db=1.0, dp=1.0, omega=1e15, verdet=0.0, dither=(0, 7)),
        lambda: march_adjoint.march_adjoint(
            u, table[0], u, shape_ab=(3, 3), origin_ab=(0.0, 0.0),
            inv_ab=(1.0, 1.0), dp=1.0, layout=lay, K=8,
            dseg=torch.empty((9, 9 * 3), device=meta)),
        lambda: cic.deposit(x, x, x[:, None], (4, 4), 2.0, 2.0),
        lambda: cic.adjoint(x, x, x[:, None], torch.empty((4, 4, 1),
                                                          device=meta),
                            (4, 4), 2.0, 2.0),
        lambda: boris.push(torch.empty((8, 6), device=meta),
                           torch.empty((4, 4, 4, 3), device=meta), None,
                           [0.0] * 3, [1.0] * 3, 1e-12, 1e-4, 2),
        lambda: btable.write(
            torch.empty((4, 4, 4, 3), dtype=torch.int8, device=meta),
            torch.empty((2, 4, 4, 3), device=meta), 0,
            torch.empty(3, device=meta), (0, 5)),
        lambda: xray.fold(u[:4, :2, None], None, mode=1, table=None,
                          w0=True, wlast=True,
                          tau=torch.empty((2, 1), device=meta), em=None),
        lambda: xray.pp_fold(u[:2, :2, None].contiguous(), x, x, x[:2],
                             x[:2], 0.0, 0.0, 1.0, 1.0, x),
        lambda: xray.pp_chords(
            torch.empty((4, 4, 4), device=meta),
            torch.empty((4, 4, 4), device=meta), xray.ChordGeometry(
                [0.0] * 3, [1.0] * 3, [0.0] * 3, [3.0] * 3,
                [1.5, 1.5, -1.0], 1.5, 1.5, 4.0, torch.zeros(2),
                torch.zeros(2), (2, 0, 1)), 4, 1),
        lambda: march_sharded.march_shards(
            u, [march_sharded.Shard(table[0, :6], table[0, 6:], 0)], None,
            naloc=2, line_shards=1, shape_ab=(3, 3), origin_ab=(0.0, 0.0),
            inv_ab=(1.0, 1.0), dp=1.0, layout=lay, K=8),
        lambda: sharded_rhs.Trace(
            torch.empty((9, 8), device=meta),
            [sharded_rhs.Shard(torch.empty((2, 4, 4, 3), device=meta),
                               torch.empty((4, 4, 3), device=meta), 0,
                               False)], origin=[0.0] * 3,
            inv_spacing=[1.0] * 3, nx_global=4, steps=Steps.of(1e-12),
            layout=lay),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
    assert march.KERNEL.launches == analytic.KERNEL.launches == 0
    assert (deposit.KERNEL.launches == binning.BIN_KERNEL.launches
            == binning.BIN_FIELD_KERNEL.launches == fill.KERNEL.launches
            == kernel_random.KERNEL.launches == 0)
    assert (march_adjoint.KERNEL.launches == cic.KERNEL.launches
            == cic.BACKWARD_KERNEL.launches == 0)
    assert (boris.KERNEL.launches == btable.KERNEL.launches
            == xray.FOLD_KERNEL.launches == xray.PP_FOLD_KERNEL.launches
            == xray.PP_CHORDS_KERNEL.launches == 0)
    assert march_sharded.KERNEL.launches == sharded_rhs.KERNEL.launches == 0


def test_refuse_grad_names_the_residual_off_the_cpu():
    """The shared guard of the wrappers without a backward: a tensor off
    the CPU (here on the meta device) that requires grad raises under
    autograd; CPU tensors, tensors without grad, None and autograd off
    pass."""
    meta = torch.empty(3, device="meta", requires_grad=True)
    with pytest.raises(NotImplementedError,
                       match=r"K13.*ROADMAP Residuals \(no backward\)"):
        _build.refuse_grad("boris.push (K13)", None, meta)
    _build.refuse_grad("x", torch.zeros(3, requires_grad=True),
                       torch.empty(3, device="meta"), None, 1.0)
    with torch.no_grad():
        _build.refuse_grad("x", meta)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, "chip_smoke.py"), (tmp_path, "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        res = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
