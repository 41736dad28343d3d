"""The renderer's pack chain (kernel K19's plain versions) against the JAX
package's ``build_pack`` -> ``make_zscan_pack`` -> ``make_segment_pack``
and its ``jax.vjp``, on the CPU.

Scenes: a (9, 3, 7) grid (non-cubic, an axis of length 3) probed along x,
y and z, in the layouts C = 3, C = 4 (phase) and C = 8 (kappa, phase,
Faraday), float32 and bf16 tables, with a K that divides the slab count
and one that pads the last segment. ne is seeded numpy noise between 0 and
1.6 nc with exact-vacuum cells (ne = 0) and overdense ones (ne >= nc).
Tolerances, observed values in brackets:

* forward: the plain chain equals JAX's chain run op by op bit for bit
  (float32 and bf16); JAX's jitted chain multiplies by the float32
  reciprocals of nc and h, so it is held within 1e-6 of each channel's
  largest |value| [2.5e-7 of the gradient channels, the rest equal];
* adjoint: ``seg_planes_vjp_plain`` within 1e-6 relative L2 of
  ``jax.vjp`` and of ``torch.autograd`` through ``seg_planes_plain``
  [<= 1e-7: the two sum the stencil's terms in another order]. For a bf16
  table JAX and autograd sum the two copies of a border plane in bf16, the
  port in float32: the port is held within 1e-6 of ``jax.vjp`` of the
  float32 chain fed the same bf16 cotangent (the same sum, unrounded), and
  within 2^-8 (one bf16 rounding of each border sum) of the bf16 chain's
  [<= 1e-3]. Where ne = 0 with C = 8, JAX's and autograd's kappa gradient
  is 0 * inf = NaN (omega_pe's square root under ``max``); they are
  compared elsewhere and the port gives 0 there;
* ``torch.autograd.gradcheck`` of ``SegPlanes`` in float64, C = 8;
* a planted fault (the second copy of each border plane dropped) must
  fail the adjoint's comparison.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields import build_pack as jbuild_pack
from synthpy_tpu.fields import layout_of as jlayout_of
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu_torch import constants, convert
from synthpy_tpu_torch.kernels import _build
from synthpy_tpu_torch.kernels import pack_chain as pc

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
LWL = 1064e-9
DIMS = (9, 3, 7)
NC = constants.critical_density(constants.omega_from_lwl(LWL))
# probing axis -> (a K that divides the slab count, one that pads)
KS = {"x": (4, 3), "y": (1, 3), "z": (3, 4)}
LAYOUTS = {3: (False, False, False), 4: (False, True, False),
           8: (True, True, True)}


def _fields(seed=0, dims=DIMS, lo=0.0, hi=1.6, special=True):
    rng = np.random.default_rng(seed)
    ne = (NC * (lo + (hi - lo) * rng.random(dims))).astype(np.float32)
    if special:
        ne[0, 0, 0] = ne[4, 1, 3] = 0.0          # exact vacuum
        ne[2, 2, 5] = np.float32(NC)             # at critical
        ne[8, 0, 6] = np.float32(3.0 * NC)       # overdense
    te = (20.0 + 40.0 * rng.random(dims)).astype(np.float32)
    zz = (1.0 + 3.0 * rng.random(dims)).astype(np.float32)
    B = (5.0 * rng.standard_normal(dims + (3,))).astype(np.float32)
    return ne, te, zz, B


def scene(probe, C, **kw):
    """(JAX domain, port domain, ne) with the fields of ``_fields``."""
    ne, te, zz, B = _fields(**kw)
    dims = ne.shape
    jd = JDomain(2 * EXT, dims, probing_direction=probe)
    jd.external_ne(ne)
    jd.external_Te(te)
    jd.external_Z(zz)
    jd.external_B(B)
    jd.inv_brems, jd.phaseshift, jd.B_on = LAYOUTS[C]
    return jd, convert.domain(jd, "cpu"), ne


def jax_chain(jd, K, pack_dtype=None):
    lay = jlayout_of(jd)

    def chain(n):
        g = copy.copy(jd)
        g.ne = n
        zp = jz.make_zscan_pack(jbuild_pack(g, LWL), lay,
                                jd.probing_direction, dtype=pack_dtype)
        return jz.make_segment_pack(zp, K=K).seg_planes

    return chain


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _rel_l2(a, b, where=None):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if where is not None:
        a, b = a[where], b[where]
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


CASES = [(p, C, t, k) for p in "xyz" for C in (3, 4, 8)
         for t in ("f32", "bf16") for k in (0, 1)]


def _ids(cases):
    return [f"{p}-C{C}-{t}-K{KS[p][k]}" for p, C, t, k in cases]


def _dtypes(tier):
    return ((None, None) if tier == "f32"
            else (jnp.bfloat16, torch.bfloat16))


@pytest.mark.parametrize("probe,C,tier,kk", CASES, ids=_ids(CASES))
def test_plain_forward_is_jaxs_chain(probe, C, tier, kk):
    K = KS[probe][kk]
    jdt, tdt = _dtypes(tier)
    jd, td, ne = scene(probe, C)
    want = jax_chain(jd, K, jdt)(jnp.asarray(ne))
    spec = pc.chain_spec(td, LWL, K=K, pack_dtype=tdt)
    got = pc.seg_planes_plain(torch.from_numpy(ne), spec)
    n_p = ne.shape["xyz".index(probe)]
    assert got.shape == (-(-(n_p - 1) // K), 21 * 9 // n_p, (K + 1) * C)
    a = got.float().numpy().reshape(-1, C)
    b = np.asarray(want).astype(np.float32).reshape(-1, C)
    rest = [c for c in range(C) if not (C == 8 and c == 3)]
    np.testing.assert_array_equal(a[:, rest], b[:, rest])
    if C == 8:
        # kappa: PyTorch's log and pow differ from XLA's in the last place
        # (as test_torch_scale_pack.py finds): a few float32 ulps, one bf16
        # step
        tol = 4e-7 if tier == "f32" else 2.0 ** -7
        assert (np.abs(a[:, 3] - b[:, 3]) <= tol * np.abs(b[:, 3])).all()
    # the Function on a CPU tensor runs this plain version
    n0 = pc.KERNEL.launches
    assert torch.equal(pc.seg_planes(torch.from_numpy(ne), spec), got)
    assert pc.KERNEL.launches == n0


@pytest.mark.parametrize("probe", ["x", "y", "z"])
def test_jitted_jax_chain_within_an_ulp(probe):
    """XLA folds the divisions by nc and h into float32 reciprocals (the
    rule found by emulation, kernels/pack_chain.py): within 1e-6 of each
    channel's largest |value|."""
    K = KS[probe][1]
    jd, td, ne = scene(probe, 8)
    want = np.asarray(jax.jit(jax_chain(jd, K))(jnp.asarray(ne)))
    got = pc.seg_planes_plain(torch.from_numpy(ne),
                              pc.chain_spec(td, LWL, K=K)).numpy()
    a, b = got.reshape(-1, 8), want.reshape(-1, 8)
    for c in range(8):
        scale = float(np.abs(b[:, c]).max())
        assert float(np.abs(a[:, c] - b[:, c]).max()) <= 1e-6 * scale, c


def _cotangent(shape, seed, tdt):
    ct = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    t = torch.from_numpy(ct)
    return t if tdt is None else t.to(tdt)


@pytest.mark.parametrize("probe,C,tier,kk", CASES, ids=_ids(CASES))
def test_plain_vjp_matches_jax_and_autograd(probe, C, tier, kk):
    K = KS[probe][kk]
    jdt, tdt = _dtypes(tier)
    jd, td, ne = scene(probe, C)
    spec = pc.chain_spec(td, LWL, K=K, pack_dtype=tdt)
    net = torch.from_numpy(ne).requires_grad_()
    table = pc.seg_planes_plain(net, spec)
    ct = _cotangent(table.shape, 7, tdt)
    got = pc.seg_planes_vjp_plain(net.detach(), ct, spec).numpy()
    assert np.isfinite(got).all()
    auto, = torch.autograd.grad(table, net, ct)
    ct32 = jnp.asarray(ct.float().numpy())
    _, vjp32 = jax.vjp(jax_chain(jd, K), jnp.asarray(ne))
    want32, = vjp32(ct32)
    _, vjp = jax.vjp(jax_chain(jd, K, jdt), jnp.asarray(ne))
    want, = vjp(ct32.astype(jdt) if jdt else ct32)
    want32, want = np.asarray(want32), np.asarray(want)
    # JAX's and autograd's kappa gradient is NaN only at exact vacuum
    ok = np.isfinite(want)
    assert (ne[~ok] == 0).all() and (C == 8 or ok.all())
    assert (np.isfinite(auto.numpy()) == ok).all()
    assert _rel_l2(got, want32, ok) <= 1e-6
    if tier == "f32":
        assert _rel_l2(got, want, ok) <= 1e-6
        assert _rel_l2(got, auto.numpy(), ok) <= 1e-6
    else:
        assert _rel_l2(got, want, ok) <= 2.0 ** -8
        assert _rel_l2(got, auto.numpy(), ok) <= 2.0 ** -8


def test_derivatives_are_zero_not_nan_at_vacuum_and_overdense():
    """A cotangent on the phase channel alone leaves d ne exactly 0 where
    the chain's 1 - (omega_pe / omega)^2 is not positive (ne >= nc, up to
    that product's rounding; the double where); on the kappa channel
    alone, 0 where ne = 0 (omega_pe below omega, and r = 0)."""
    jd, td, ne = scene("z", 8)
    spec = pc.chain_spec(td, LWL, K=3)
    lay = spec.layout
    net = torch.from_numpy(ne)
    table = pc.seg_planes_plain(net, spec)
    omega = constants.omega_from_lwl(LWL)
    k = np.float32(constants.OMEGA_PE_COEFF ** 2 * 1e-6 / omega ** 2)
    flat = np.float32(1.0) - k * ne <= 0
    assert flat[8, 0, 6] and (flat == (ne >= np.float32(NC))).mean() > 0.99
    for ch, where in ((lay.phase_index, flat), (lay.kappa_index, ne == 0)):
        ct = torch.zeros_like(table).reshape(*table.shape[:2], -1, 8)
        ct[..., ch] = 1.0
        d = pc.seg_planes_vjp_plain(net, ct.reshape(table.shape), spec)
        assert torch.isfinite(d).all()
        assert where.any() and (d.numpy()[where] == 0).all()
        assert (d.numpy()[~where] != 0).any()


@pytest.mark.parametrize("probe", ["x", "z"])
def test_function_gradcheck_float64(probe):
    """gradcheck of SegPlanes (the plain versions on the CPU) in float64,
    C = 8, ne between 0.1 and 0.7 nc (away from the kinks at critical and
    vacuum), each channel scaled to order one."""
    from synthpy_tpu_torch.fields import ScalarDomain

    ne, te, zz, B = (torch.from_numpy(v.astype(np.float64)) for v in
                     _fields(dims=(4, 3, 5), lo=0.1, hi=0.7, special=False))
    td = ScalarDomain(2 * EXT, (4, 3, 5), inv_brems=True, phaseshift=True,
                      B_on=True, probing_direction=probe,
                      dtype=torch.float64, device="cpu")
    td.ne, td.Te, td.Z, td.B = ne, te, zz, B
    ne = ne.numpy()
    spec = pc.chain_spec(td, LWL, K=2)
    x = torch.from_numpy(ne / NC).requires_grad_()
    with torch.no_grad():
        t0 = pc.seg_planes(x * NC, spec)
    scale = t0.reshape(-1, 8).abs().amax(0)

    def f(x):
        t = pc.SegPlanes.apply(x * NC, spec)
        return (t.reshape(-1, 8) / scale).reshape(t.shape)

    assert torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-7,
                                    rtol=1e-5)


def test_a_dropped_border_copy_fails_the_comparison(monkeypatch):
    """The adjoint without the second copy of each border plane (a planted
    fault) is far outside the 1e-6 tolerance against jax.vjp."""
    probe, K = "x", 3
    jd, td, ne = scene(probe, 4)
    spec = pc.chain_spec(td, LWL, K=K)
    table = pc.seg_planes_plain(torch.from_numpy(ne), spec)
    ct = _cotangent(table.shape, 3, None)
    _, vjp = jax.vjp(jax_chain(jd, K), jnp.asarray(ne))
    want, = vjp(jnp.asarray(ct.numpy()))
    good = pc.seg_planes_vjp_plain(torch.from_numpy(ne), ct, spec)
    assert _rel_l2(good.numpy(), want) <= 1e-6

    def no_border(dseg, n_p, na, nb, K, C, dtype):
        n_seg = dseg.shape[0]
        t = dseg.to(dtype).reshape(n_seg, na, nb, K + 1, C)
        planes = t[:, :, :, :K].permute(0, 3, 1, 2, 4).reshape(
            n_seg * K, na, nb, C)
        return torch.cat([planes, t[-1, :, :, K][None]])[:n_p]

    monkeypatch.setattr(pc, "_plane_cotangents", no_border)
    bad = pc.seg_planes_vjp_plain(torch.from_numpy(ne), ct, spec)
    assert _rel_l2(bad.numpy(), want) > 0.01


def test_renderer_saves_only_ne():
    """make_renderer's graph holds the chain as one SegPlanes node whose
    only saved tensor is ne (no checkpoint, no float32 intermediates)."""
    from synthpy_tpu_torch.inverse import make_renderer
    from synthpy_tpu_torch.tracer import init_beam

    jd, td, ne = scene("z", 4, special=False, lo=0.0, hi=0.05)
    s0 = init_beam(1, 200, 2e-3, 0.0, EXT, device="cpu")
    render = make_renderer(td, s0, bins=(8, 6), K=3, Lx=6.0, Ly=6.0)
    net = torch.from_numpy(ne).requires_grad_()
    img = render(net)
    seen, stack, nodes = set(), [img.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        nodes.append(fn)
        stack.extend(f for f, _ in fn.next_functions)
    chain = [n for n in nodes if type(n).__name__ == "SegPlanesBackward"]
    assert len(chain) == 1
    saved = chain[0].saved_tensors
    assert len(saved) == 1 and saved[0].data_ptr() == net.data_ptr()


def test_kernel_argtypes_match_the_c_entry_points():
    """pack_chain.cu's two entry points take as many arguments as the
    wrappers' ctypes signatures, the stream last; the source carries its
    note."""
    import re

    text = (_build.CSRC / "pack_chain.cu").read_text()
    assert "Replaces" in text and "bounds it on the H100" in text
    assert "synthpy_tpu/inverse.py" in text
    for k in (pc.KERNEL, pc.BACKWARD_KERNEL):
        assert k.source == "pack_chain.cu" and "--fmad=false" in k.flags
        for name, argtypes in k.functions.items():
            m = re.search(r'int ' + name + r"\(([^)]*)\)", text)
            assert m, name
            params = [a for a in m.group(1).split(",") if a.strip()]
            assert len(params) == len(argtypes), (name, len(params))
            assert params[-1].split()[-1] == "st", name


def test_wrappers_do_not_fall_back_off_the_cpu(monkeypatch):
    """On a tensor that is not on the CPU the wrappers launch K19 (here
    recorded, as no card is present) and never run the plain chain."""
    jd, td, ne = scene("z", 4)
    spec = pc.chain_spec(td, LWL, K=3)
    meta = torch.empty(ne.shape, device="meta")
    calls = []

    def record(self, name, device, *args):
        calls.append((name, len(args)))

    def plain(*a, **k):
        raise AssertionError("the plain chain ran off the CPU")

    monkeypatch.setattr(_build.Kernel, "launch", record)
    monkeypatch.setattr(pc, "seg_planes_plain", plain)
    monkeypatch.setattr(pc, "seg_planes_vjp_plain", plain)
    monkeypatch.setattr(pc, "_checked", lambda ne, spec: (ne, None, None,
                                                          None))
    table = pc.forward(meta, spec)
    assert table.device.type == "meta"
    pc.adjoint(meta, table, spec)
    assert calls == [
        ("pack_chain_forward",
         len(pc.KERNEL.functions["pack_chain_forward"]) - 1),
        ("pack_chain_adjoint",
         len(pc.BACKWARD_KERNEL.functions["pack_chain_adjoint"]) - 1)]


def test_kernel_inputs_are_checked():
    jd, td, ne = scene("z", 8)
    spec = pc.chain_spec(td, LWL, K=3)
    with pytest.raises(ValueError, match="float32"):
        pc._checked(torch.from_numpy(ne).double(), spec)
    with pytest.raises(ValueError, match="grid"):
        pc._checked(torch.from_numpy(ne)[:, :, :5], spec)
    bad = pc.chain_spec(td, LWL, K=3, pack_dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16"):
        pc._checked(torch.from_numpy(ne), bad)
