"""The port's public signatures against the JAX package's (ROADMAP C.10).

For every module of the port that has a JAX counterpart, each public
function and method that both define must accept every keyword that the
JAX signature names (a JAX call runs unchanged on the port), take its
positional parameters in JAX's order, and every public name of the JAX
module must exist in the port. ``ALLOWED`` lists the deliberate gaps, each
with its ROADMAP item and the reason.

Then one test per repaired keyword calls it: the keywords that only tune
XLA (``ray_chunk``, ``unroll``, ``fuse_threshold_bytes``) must leave the
result as it was; those that change results (``pack=``, ``lwl``,
``extras_dtype``, ``dtype``, ``key=``) are compared with JAX on the same
inputs, at the tolerances of the tests that hold each function
(``test_torch_march.py``, ``test_torch_scale_pack.py``,
``test_torch_domain.py``); a value the port cannot honour is refused with
a message that names the ROADMAP item.
"""

import importlib
import inspect
import pkgutil
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthpy_tpu_torch
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields import build_pack as jbuild_pack
from synthpy_tpu.optics import compose as jcompose
from synthpy_tpu.tracer import init_beam as jinit_beam
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu_torch import convert
from synthpy_tpu_torch.fields import build_pack, layout_of
from synthpy_tpu_torch.optics import compose
from synthpy_tpu_torch.tracer import analytic as tanalytic
from synthpy_tpu_torch.tracer import init_beam
from synthpy_tpu_torch.tracer import zscan as tz

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

# (port module, name[, keyword]) -> (ROADMAP item, reason)
ALLOWED = {
    ("synthpy_tpu_torch.ops.dft", "force_matmul"): (
        "A.10", "the matmul DFT exists for TPUs without an FFT; cuFFT has "
        "no such gap"),
    ("synthpy_tpu_torch.optics.rtm", "d2r"): ("A.18", "legacy helper"),
    ("synthpy_tpu_torch.optics.rtm", "mm_to_m"): ("A.18", "legacy helper"),
    ("synthpy_tpu_torch.optics.rtm", "ray"): ("A.18", "legacy helper"),
    ("synthpy_tpu_torch.tracer.beam", "Beam"): ("A.18", "legacy object "
                                                "API"),
    ("synthpy_tpu_torch.tracer.zscan", "march_segment"): (
        "B1", "the JAX march body; kernel K1 (kernels.march) replaces it"),
    **{("synthpy_tpu_torch.fields.domain", f"ScalarDomain.{m}"): (
        "A.18", "legacy object API")
       for m in ("calc_dndr", "clear_memory", "export_scalar_field",
                 "plot_midline_gradients", "solve", "solve_at_depth",
                 "solve_with_E")},
    **{("synthpy_tpu_torch.fields.grf", f"gaussian{n}D.export_scalar_field"):
       ("A.18", "needs io/vti.py (A.15)") for n in (1, 2, 3)},
    ("synthpy_tpu_torch.parallel.mesh", "Mesh.update"): (
        "A.17", "a method of jax.sharding.Mesh, which JAX's Mesh extends; "
        "the port's Mesh is a list of torch devices"),
}


def _paired_modules():
    """The names of the port's modules that have a JAX counterpart (the
    kernels have none)."""
    out = []
    for info in pkgutil.walk_packages(synthpy_tpu_torch.__path__,
                                      "synthpy_tpu_torch."):
        name = info.name
        if ".kernels" in name:
            continue
        try:
            importlib.import_module(
                "synthpy_tpu" + name[len("synthpy_tpu_torch"):])
        except ModuleNotFoundError:
            continue
        out.append(name)
    return out


MODULES = _paired_modules()


def _modules(name):
    jname = "synthpy_tpu" + name[len("synthpy_tpu_torch"):]
    return importlib.import_module(name), importlib.import_module(jname)


def _signature(f):
    try:
        return inspect.signature(f)
    except (TypeError, ValueError):
        return None


def _callables(tm, jm):
    """(qualified name, port callable, JAX callable) of the public
    functions and methods that both modules define."""
    out = []
    for attr in dir(tm):
        if attr.startswith("_") or not hasattr(jm, attr):
            continue
        tv, jv = getattr(tm, attr), getattr(jm, attr)
        if inspect.ismodule(tv) or not (callable(tv) and callable(jv)):
            continue
        if inspect.isclass(tv) and inspect.isclass(jv):
            for m in dir(tv):
                if m.startswith("_") and m != "__init__":
                    continue
                f1, f2 = getattr(tv, m, None), getattr(jv, m, None)
                if inspect.isfunction(f1) and inspect.isfunction(f2):
                    out.append((f"{attr}.{m}", f1, f2))
        elif not (inspect.isclass(tv) or inspect.isclass(jv)):
            out.append((attr, tv, jv))
    return out


def _named(sig):
    return [p for p, v in sig.parameters.items()
            if v.kind not in (v.VAR_POSITIONAL, v.VAR_KEYWORD)]


def test_the_comparison_covers_the_port():
    assert len(MODULES) >= 25
    assert "synthpy_tpu_torch.tracer.zscan" in MODULES
    assert "synthpy_tpu_torch.inverse" in MODULES


@pytest.mark.parametrize("name", MODULES)
def test_every_jax_keyword_is_accepted(name):
    tm, jm = _modules(name)
    missing = []
    for qual, tf, jf in _callables(tm, jm):
        ts, js = _signature(tf), _signature(jf)
        if ts is None or js is None or any(
                v.kind == v.VAR_KEYWORD for v in ts.parameters.values()):
            continue
        for kw in _named(js):
            if kw not in ts.parameters and (name, qual, kw) not in ALLOWED:
                missing.append(f"{qual}({kw}=)")
    assert not missing, f"{name}: the port refuses JAX keywords {missing}"


@pytest.mark.parametrize("name", MODULES)
def test_positional_parameters_keep_jaxs_order(name):
    tm, jm = _modules(name)
    bad = []
    for qual, tf, jf in _callables(tm, jm):
        ts, js = _signature(tf), _signature(jf)
        if ts is None or js is None:
            continue

        def pos(s):
            return [p for p, v in s.parameters.items()
                    if v.kind in (v.POSITIONAL_ONLY, v.POSITIONAL_OR_KEYWORD)]

        a, b = pos(ts), pos(js)
        if a[:len(b)] != b[:len(a)]:
            bad.append((qual, a, b))
    assert not bad, bad


@pytest.mark.parametrize("name", MODULES)
def test_every_jax_public_name_exists(name):
    tm, jm = _modules(name)
    jname = jm.__name__
    public = getattr(jm, "__all__", None) or [
        a for a in dir(jm) if not a.startswith("_")
        and (inspect.isfunction(getattr(jm, a))
             or inspect.isclass(getattr(jm, a)))
        and getattr(getattr(jm, a), "__module__", "") == jname]
    missing = [a for a in public
               if not hasattr(tm, a) and (name, a) not in ALLOWED]
    for a in public:
        tv, jv = getattr(tm, a, None), getattr(jm, a)
        if (inspect.isclass(tv) and inspect.isclass(jv)
                and tv.__module__ == name):
            missing += [f"{a}.{m}" for m in dir(jv)
                        if not m.startswith("_") and callable(getattr(jv, m))
                        and not hasattr(tv, m)
                        and (name, f"{a}.{m}") not in ALLOWED]
    assert not missing, f"{name} lacks {missing}"


def test_every_allowed_gap_is_real_and_named():
    """Each allow-list entry names a ROADMAP item and is still a gap (a
    repaired one must leave the list)."""
    for key, (item, why) in ALLOWED.items():
        assert re.fullmatch(r"[AC]\.\d+|B\d+", item) and why
        tm = importlib.import_module(key[0])
        obj = tm
        for part in key[1].split("."):
            obj = getattr(obj, part, None)
            if obj is None:
                break
        if len(key) == 2:
            assert obj is None, f"{key} is ported: drop it from ALLOWED"
        else:
            assert key[2] not in inspect.signature(obj).parameters, key


# -- the repaired keywords, called --------------------------------------

EXT = 5e-3


@pytest.fixture(scope="module")
def lens():
    jd = JDomain(2 * EXT, 17).test_lens(ne_0=5e24, LR=1.5e-3)
    s0 = jinit_beam(jax.random.PRNGKey(3), 1024, 2.2e-3, 2e-3, EXT,
                    "circular")
    return jd, convert.domain(jd, "cpu"), s0, convert.tensor(s0, "cpu")


def _rows_close(got, want, tol=2e-6):
    """Each row within ``tol`` of its largest |value| (test_torch_march.py:
    float order of the march), the same NaN entries."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert (np.isnan(got) == np.isnan(want)).all()
    for g, w in zip(got, want):
        ok = np.isfinite(w)
        scale = max(float(np.abs(w[ok]).max()), 1e-30)
        assert float(np.abs(g[ok] - w[ok]).max()) <= tol * scale


def test_solve_zscan_segments_takes_a_trace_pack(lens):
    """pack= (JAX's ScalarDomain.solve passes it): the segments are
    regrouped from that pack, not built by K2 (whose probe-axis edges
    differ, ROADMAP C.8), and the exits match JAX's for the same pack."""
    jd, td, js0, ts0 = lens
    want = jz.solve_zscan_segments(js0, jd, K=8, pack=jbuild_pack(jd)).sf
    pack = build_pack(td)
    got = tz.solve_zscan_segments(ts0, td, K=8, pack=pack, ray_chunk=256,
                                  unroll=4).sf
    _rows_close(got.numpy(), want)
    sp = tz.make_segment_pack(tz.make_zscan_pack(pack, layout_of(td), "z"),
                              K=8)
    same = tz.solve_zscan_segments(ts0, td, spack=sp).sf
    assert torch.equal(got, same)
    k2 = tz.solve_zscan_segments(ts0, td, K=8).sf
    assert not torch.equal(got, k2)


def test_xla_knobs_leave_the_results(lens):
    """ray_chunk, unroll and fuse_threshold_bytes tune XLA only."""
    _, td, _, ts0 = lens
    sp = tz.build_segment_pack_device(td, K=8, dtype=torch.float32)
    assert torch.equal(tz.build_segment_pack_device(
        td, K=8, dtype=torch.float32, fuse_threshold_bytes=1).seg_planes,
        sp.seg_planes)
    u = tz.permute_state(ts0)
    kw = dict(shape_ab=sp.shape_ab, layout=layout_of(td), K=8,
              n_seg=sp.seg_planes.shape[0])
    args = (u, sp.seg_planes, sp.origin_ab, sp.inv_spacing_ab, sp.dp)
    assert torch.equal(tz.trace_zscan_segments(*args, **kw),
                       tz.trace_zscan_segments(*args, ray_chunk=100,
                                               unroll=8, **kw))
    base = tz.solve_zscan_segments(ts0, td, spack=sp).sf
    host = sp._replace(host=True)
    streamed = tz.solve_zscan_segments_streamed(
        ts0, td, hpack=host, lwl=527e-9, ray_chunk=100, unroll=8).sf
    assert torch.equal(streamed, base)


def test_analytic_march_takes_unroll(lens):
    _, td, _, ts0 = lens
    from synthpy_tpu_torch.tracer.analytic import solve_zscan_analytic

    want = solve_zscan_analytic(ts0, td).sf
    spec = td.analytic
    u = tz.permute_state(ts0)
    kw = dict(axes=(0, 1, 2), bounds=([float(c[0]) for c in (td.x, td.y,
                                                             td.z)],
                                      [float(c[-1]) for c in (td.x, td.y,
                                                              td.z)]),
              omega=2.0 * np.pi * 2.99792458e8 / 1064e-9, lwl=1064e-9,
              p0=float(td.z[0]), h=float(td.z[1] - td.z[0]), n_steps=16)
    a = tanalytic.trace_zscan_analytic(u, spec, layout_of(td), **kw)
    b = tanalytic.trace_zscan_analytic(u, spec, layout_of(td), unroll=7,
                                       **kw)
    assert torch.equal(a, b) and want.shape[0] == 9


def test_streamed_march_ignores_lwl_as_jax_does(lens):
    """JAX's streamed march takes lwl and reads it nowhere (the pack's
    channels hold the wavelength it was built with): so does the port."""
    jd, td, js0, ts0 = lens
    jsp = jz.build_segment_pack_device(jd, K=8, dtype=jnp.float32)
    jhost = jsp._replace(seg_planes=np.asarray(jsp.seg_planes))
    a = jz.solve_zscan_segments_streamed(js0, jd, hpack=jhost).sf
    b = jz.solve_zscan_segments_streamed(js0, jd, hpack=jhost,
                                         lwl=527e-9).sf
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    sp = tz.build_segment_pack_device(td, K=8, dtype=torch.float32)
    got = tz.solve_zscan_segments_streamed(ts0, td, hpack=sp, lwl=527e-9).sf
    _rows_close(got.numpy(), a)


@pytest.fixture(scope="module")
def physics():
    """A full-physics 21^3 scene with host volumes on both sides."""
    jd = JDomain(2 * EXT, 21)
    rng = np.random.default_rng(5)
    n = (21, 21, 21)
    ne = (5e24 * (1.0 + 0.5 * rng.random(n))).astype(np.float32)
    te = (40.0 + 10.0 * rng.random(n)).astype(np.float32)
    zz = (3.0 + rng.random(n)).astype(np.float32)
    B = (5.0 * rng.standard_normal(n + (3,))).astype(np.float32)
    td = convert.domain(jd, "cpu")
    for d in (jd, td):
        d.external_ne(ne, host=True)
        d.external_Te(te, host=True)
        d.external_Z(zz, host=True)
        d.external_B(B, host=True)
        d.inv_brems = d.phaseshift = True
        d.B_on = True
    return jd, td


def test_upload_extras_dtype_gives_jaxs_pack(physics):
    """extras_dtype=bfloat16 rounds Te, Z and B as JAX's upload does: the
    float32 table matches JAX's to the channels' last place
    (test_torch_scale_pack.py's contract: 1e-6 of each channel's largest,
    the phase channel to omega times an ulp of 1), while the kappa and
    Faraday channels move by far more than that from the float32 extras'
    table."""
    jd, td = physics
    K = 8
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp = jz.build_segment_pack_upload(jd, K=K, dtype=jnp.float32,
                                          plane_batch=4,
                                          extras_dtype=jnp.bfloat16)
    got = tz.build_segment_pack_upload(td, K=K, dtype=torch.float32,
                                       plane_batch=4,
                                       extras_dtype=torch.bfloat16)
    want = np.asarray(jp.seg_planes)
    C = want.shape[-1] // (K + 1)
    a = got.seg_planes.numpy().reshape(-1, K + 1, C)
    b = want.reshape(-1, K + 1, C)
    phase_atol = 1.7703492e15 * 2.0**-23    # omega * ulp(1) at 1064 nm
    for c in range(C):
        scale = float(np.abs(b[..., c]).max())
        atol = max(1e-6 * scale, phase_atol if c == 4 else 0.0)
        np.testing.assert_allclose(a[..., c], b[..., c], rtol=0, atol=atol,
                                   err_msg=f"channel {c}")
    for dt in (jnp.bfloat16, "bfloat16"):
        again = tz.build_segment_pack_upload(td, K=K, dtype=torch.float32,
                                             plane_batch=4, extras_dtype=dt)
        assert torch.equal(again.seg_planes, got.seg_planes)
    f32 = tz.build_segment_pack_upload(td, K=K, dtype=torch.float32,
                                       plane_batch=4).seg_planes.numpy()
    f32 = f32.reshape(-1, K + 1, C)
    for c in (3, 5, 6, 7):       # kappa and the Faraday channels
        moved = np.abs(f32[..., c] - a[..., c]).max()
        assert moved > 1e-4 * np.abs(a[..., c]).max(), c
    with pytest.raises(ValueError, match="ROADMAP C.10"):
        tz.build_segment_pack_upload(td, K=K, dtype=torch.float32,
                                     plane_batch=4, extras_dtype=torch.int8)


@pytest.mark.parametrize("jones,dtype", [("complex64", "float64"),
                                         ("complex128", "float32"),
                                         ("complex64", "float32")])
def test_analyser_weight_dtype_matches_jax(jones, dtype):
    """dtype= holds the analyser angle, and JAX's promotion sets the
    weight's type: within 1e-6 of the largest weight for a float32 angle
    (its sin and cos are float32, XLA's to within an ulp), 1e-12 for a
    float64 one."""
    rng = np.random.default_rng(2)
    J = (rng.standard_normal((2, 300))
         + 1j * rng.standard_normal((2, 300))).astype(jones)
    with jax.enable_x64(True):
        want = np.asarray(jcompose.analyser_weight(
            jnp.asarray(J), 85.0, dtype=getattr(jnp, dtype)))
    got = compose.analyser_weight(torch.from_numpy(J), 85.0,
                                  dtype=getattr(torch, dtype)).numpy()
    assert got.dtype == want.dtype
    tol = 1e-12 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
    with pytest.raises(ValueError, match="ROADMAP C.10"):
        compose.analyser_weight(torch.from_numpy(J), 85.0,
                                dtype=torch.float16)


def test_init_beam_takes_key_by_name():
    """init_beam(key=...) draws JAX's stream (test_torch_domain.py's
    tolerance: 1e-6 of each row's largest), and n_trackers sits where JAX
    puts it."""
    jk = jax.random.PRNGKey(4)
    want = np.asarray(jinit_beam(key=jk, Np=400, beam_size=2e-3,
                                 divergence=1e-3, ne_extent=EXT))
    got = init_beam(key=convert.key(jk), Np=400, beam_size=2e-3,
                    divergence=1e-3, ne_extent=EXT, device="cpu").numpy()
    scale = np.maximum(np.abs(want).max(axis=1, keepdims=True), 1e-30)
    assert (np.abs(got - want) <= 1e-6 * scale).all()
    jw, jidx = jinit_beam(jk, 400, (2e-3, 2e-3), 1e-3, EXT, "rect_trackers",
                          "z", 5, 1e-3)
    tw, tidx = init_beam(convert.key(jk), 400, (2e-3, 2e-3), 1e-3, EXT,
                         "rect_trackers", "z", 5, 1e-3, device="cpu")
    np.testing.assert_array_equal(np.sort(np.asarray(jidx)),
                                  np.sort(tidx.numpy()))
