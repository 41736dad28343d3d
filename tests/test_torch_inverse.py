"""The differentiable renderer of the port (``synthpy_tpu_torch.inverse``)
against the JAX package's (``synthpy_tpu.inverse``), on the CPU.

The same numpy inputs (a JAX-drawn beam, JAX's field) go through both;
the port's kernels run their plain versions (K12's ``cic_plain`` /
``cic_vjp_plain``, K11's ``march_vjp_plain`` under the segment march's
autograd Function). Tolerances, each observed with a margin:

* CIC images (``cic_image``, ``cic_intensity_image``, the two-channel
  phase-map deposit) and their ``jax.vjp``: within 1e-6 of the largest
  value (the scatter's summation order; observed <= 2e-7);
* the march's cotangents (``trace_zscan_segments(remat=True)`` against
  ``jax.vjp``, C = 3, 4, 8): states within 2e-6 of each column's largest
  value, an f32 table's cotangent within 2e-6 relative L2 (observed
  ~2e-7). A bf16 table's cotangent is summed in float32 and rounded once
  in the port, in bf16 through the transposed ``astype`` in JAX: the port
  is held to JAX's float32-table cotangent rounded once (one bf16 step,
  2^-8 relative, of each value), and to JAX's bf16 one within twice
  JAX's own bf16-vs-float32 spread;
* the renderer (``test_render_matches_jax``, in ``test_torch_render.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import inverse as jinv
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields import layout_of as jlayout_of
from synthpy_tpu.tracer import init_beam as jinit_beam
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu_torch import convert
from synthpy_tpu_torch import pipeline
from synthpy_tpu_torch.fields import ScalarDomain
from synthpy_tpu_torch.inverse import (apply_stages_weighted, cic_image,
                                       cic_intensity_image, make_renderer)
from synthpy_tpu_torch.kernels import cic as kcic
from synthpy_tpu_torch.optics import rtm
from synthpy_tpu_torch.tracer import init_beam
from synthpy_tpu_torch.tracer import zscan as tz

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
CIC_TOL = 1e-6


def _lens_profile(dims, ne_0=5e24, LR=1.5e-3):
    d = ScalarDomain(2 * EXT, dims, device="cpu").test_lens(ne_0=ne_0,
                                                            LR=LR)
    return d, d.ne / ne_0


def _beam(seed, n, size=2e-3, probe="z"):
    """A JAX-drawn circular beam as a port tensor (JAX's key, JAX's rays)."""
    return init_beam(convert.key(jax.random.PRNGKey(seed)), n, size, 0.0,
                     EXT, "circular", probing_direction=probe, device="cpu")


# ---------------------------------------------------------------------------
# K12: the CIC deposit and its adjoint, against JAX
# ---------------------------------------------------------------------------

def _rays(n=600, seed=0):
    """Rays over and beyond an 18 x 13.5 mm detector: edge pixels, rays
    half off an edge, far off, one diverged to 1e12 mm, NaN and inf."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-11.0, 11.0, n).astype(np.float32)
    y = rng.uniform(-8.5, 8.5, n).astype(np.float32)
    x[:6] = [-9.0, 9.0, -9.0 + 0.375, 8.99, 1e12, -3e9]
    y[:6] = [0.0, -6.75, 6.75, 6.7, 0.0, 1.0]
    x[6:9] = [np.nan, 1.0, np.inf]
    y[6:9] = [0.0, np.nan, 2.0]
    w = rng.uniform(0.2, 1.5, n).astype(np.float32)
    E = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
         ).astype(np.complex64)
    return x, y, w, E


BINS, LX, LY = (24, 18), 18.0, 13.5


def _close(got, want, tol=CIC_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def test_cic_image_and_vjp_match_jax():
    x, y, w, _ = _rays()
    want, vjp = jax.vjp(lambda a, b, c: jinv.cic_image(a, b, c, BINS, LX,
                                                       LY), x, y, w)
    ct = np.random.default_rng(1).standard_normal(want.shape).astype(
        np.float32)
    jx, jy, jw = vjp(jnp.asarray(ct))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, y, w)]
    got = cic_image(*leaves, BINS, LX, LY)
    _close(got.detach(), want)
    tx, ty, tw = torch.autograd.grad(got, leaves, torch.from_numpy(ct))
    for a, b in ((tx, jx), (ty, jy), (tw, jw)):
        _close(a, b)
    # parked rays (NaN, inf) get exactly zero, not NaN; the far rays too
    for i in (4, 5, 6, 7, 8):
        assert tx[i] == 0.0 and ty[i] == 0.0 and tw[i] == 0.0


def test_cic_intensity_image_and_vjp_match_jax():
    x, y, w, E = _rays(seed=2)
    want, vjp = jax.vjp(lambda a, b, c, e: jinv.cic_intensity_image(
        a, b, c, e, BINS, LX, LY), x, y, w, E)
    ct = np.random.default_rng(3).standard_normal(want.shape).astype(
        np.float32)
    jx, jy, jw, jE = vjp(jnp.asarray(ct))
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (x, y, w, E)]
    got = cic_intensity_image(*leaves, BINS, LX, LY)
    _close(got.detach(), want)
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(ct))
    for a, b in zip(grads[:3], (jx, jy, jw)):
        _close(a, b)
    # JAX's cotangent of a complex input is the conjugate of PyTorch's
    _close(grads[3].real, np.real(jE))
    _close(grads[3].imag, -np.imag(jE))


def test_cic_two_channels_are_two_jax_images():
    """The phase map's one deposit of (w phi, w) equals two JAX cic_image
    calls, values and cotangents."""
    x, y, w, _ = _rays(seed=4)
    phi = np.random.default_rng(5).uniform(-3, 0, x.shape).astype(
        np.float32)
    vals = np.stack([w * phi, w], 1)

    def jax_two(a, b, v):
        return jnp.stack([jinv.cic_image(a, b, v[:, 0], BINS, LX, LY).T,
                          jinv.cic_image(a, b, v[:, 1], BINS, LX, LY).T],
                         -1)

    want, vjp = jax.vjp(jax_two, x, y, vals)
    ct = np.random.default_rng(6).standard_normal(want.shape).astype(
        np.float32)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, y, vals)]
    got = kcic.cic(*leaves, BINS, LX, LY)
    _close(got.detach(), want)
    for a, b in zip(torch.autograd.grad(got, leaves, torch.from_numpy(ct)),
                    vjp(jnp.asarray(ct))):
        _close(a, b)


def test_cic_plain_adjoint_is_the_function_backward():
    """On CPU tensors the Function's backward is ``cic_vjp_plain``, and the
    deposit rejects a channel count the kernel does not take."""
    x, y, w, _ = _rays(seed=7)
    vals = torch.from_numpy(np.stack([w, 2 * w, -w, w], 1))
    dacc = torch.randn(BINS + (4,), generator=torch.Generator().manual_seed(
        8))
    leaves = [torch.tensor(a, requires_grad=True)
              for a in (x, y)] + [vals.clone().requires_grad_()]
    got = torch.autograd.grad(kcic.cic(*leaves, BINS, LX, LY), leaves,
                              dacc)
    want = kcic.cic_vjp_plain(torch.from_numpy(x), torch.from_numpy(y), vals,
                              dacc, BINS, LX, LY)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="channels"):
        kcic._checked(leaves[0], leaves[1], vals[:, :3], BINS)


def test_cic_record_holds_each_deposit_and_adjoint():
    """``kcic.RECORD`` receives a deposit's inputs and its adjoint's
    cotangent, detached, while it is a list, and nothing while it is
    None."""
    x, y, w, _ = _rays(seed=9)
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, y)] + [
        torch.from_numpy(np.stack([w, -w], 1)).requires_grad_()]
    dacc = torch.randn(BINS + (2,), generator=torch.Generator().manual_seed(
        10))
    kcic.RECORD = []
    try:
        acc = kcic.cic(*leaves, BINS, LX, LY)
        torch.autograd.grad(acc, leaves, dacc)
        record = kcic.RECORD
    finally:
        kcic.RECORD = None
    assert [r[0] for r in record] == ["deposit", "adjoint"]
    dep, adj = record
    for got in (dep[1:4], adj[1:4]):
        for a, b in zip(got, leaves):
            assert a.data_ptr() == b.data_ptr() and not a.requires_grad
    assert dep[4:] == adj[5:] == (BINS, float(LX), float(LY))
    assert torch.equal(adj[4], dacc)
    kcic.cic(*leaves, BINS, LX, LY)
    assert kcic.RECORD is None


# ---------------------------------------------------------------------------
# K11: the march's cotangents, against jax.vjp
# ---------------------------------------------------------------------------

def _march_domain(C):
    d = JDomain(2 * EXT, 17).test_lens(ne_0=5e24, LR=1.5e-3)
    d.phaseshift = C >= 4
    if C == 8:
        d.inv_brems = True
        rng = np.random.default_rng(4)
        d.external_Te(50.0 + 10.0 * rng.random(d.dims))
        d.external_Z(2.0 * np.ones(d.dims))
        d.test_B(Bmax=10.0)
    return d


@pytest.fixture(scope="module")
def march_cases():
    """{C: (layout, u, f32 pack)}: 1,000 rays partly outside the grid
    through K = 6 segments (3 of them, the last padded)."""
    s0 = jinit_beam(jax.random.PRNGKey(3), 1000, 2.2e-3, 2e-3, EXT,
                    "circular")
    u = jnp.stack([s0[0], s0[1], s0[3], s0[4], s0[5], s0[6], s0[7], s0[8]],
                  axis=1)
    out = {}
    for C in (3, 4, 8):
        d = _march_domain(C)
        lay = jlayout_of(d)
        assert lay.n_channels == C
        out[C] = (lay, u, jz.build_segment_pack_device(d, K=6,
                                                       dtype=jnp.float32))
    return out


def _vjps(lay, u, jp, table, ct, remat=True):
    """(jax du, jax dtable as f32, port du, port dtable as f32)."""
    n_seg = table.shape[0]

    def f(uu, tt):
        return jz.trace_zscan_segments(
            uu, tt, jp.origin_ab, jp.inv_spacing_ab,
            jnp.asarray(jp.dp, jnp.float32), shape_ab=jp.shape_ab,
            layout=lay, K=jp.K, n_seg=n_seg, remat=True)

    _, vjp = jax.vjp(f, u, table)
    jdu, jdt = vjp(jnp.asarray(ct))
    uu = convert.tensor(u, "cpu").requires_grad_()
    tt = convert.tensor(table, "cpu").requires_grad_()
    out = tz.trace_zscan_segments(
        uu, tt, convert.tensor(jp.origin_ab, "cpu"),
        convert.tensor(jp.inv_spacing_ab, "cpu"), float(jp.dp),
        shape_ab=jp.shape_ab, layout=lay, K=jp.K, n_seg=n_seg, remat=remat)
    tdu, tdt = torch.autograd.grad(out, (uu, tt), torch.from_numpy(ct))
    assert tdt.dtype == tt.dtype
    return (np.asarray(jdu, np.float64),
            np.asarray(jdt.astype(jnp.float32), np.float64),
            tdu.double().numpy(), tdt.float().double().numpy())


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("C", [3, 4, 8])
def test_march_cotangents_match_jax_f32(march_cases, C):
    lay, u, jp = march_cases[C]
    ct = np.random.default_rng(C).standard_normal((u.shape[0], 8)).astype(
        np.float32)
    jdu, jdt, tdu, tdt = _vjps(lay, u, jp, jp.seg_planes, ct)
    for c in range(8):
        np.testing.assert_allclose(tdu[:, c], jdu[:, c], rtol=0,
                                   atol=2e-6 * np.abs(jdu[:, c]).max(),
                                   err_msg=f"column {c}")
    assert _rel_l2(tdt, jdt) <= 2e-6
    assert np.abs(jdt).max() > 0


@pytest.mark.parametrize("C", [3, 4, 8])
def test_march_cotangents_match_jax_bf16(march_cases, C):
    """bf16 table: the port sums the table's cotangent in float32 and
    rounds once, JAX sums it in bf16 (its transposed astype)."""
    lay, u, jp = march_cases[C]
    ct = np.random.default_rng(C).standard_normal((u.shape[0], 8)).astype(
        np.float32)
    bf = jp.seg_planes.astype(jnp.bfloat16)
    jdu, jdt, tdu, tdt = _vjps(lay, u, jp, bf, ct)
    # the same values in a float32 table: JAX's float32 sums
    _, jdt32, _, _ = _vjps(lay, u, jp, bf.astype(jnp.float32), ct)
    for c in range(8):
        np.testing.assert_allclose(tdu[:, c], jdu[:, c], rtol=0,
                                   atol=2e-6 * np.abs(jdu[:, c]).max(),
                                   err_msg=f"column {c}")
    # rounded once: within one bf16 step of JAX's float32 sum
    np.testing.assert_allclose(tdt, jdt32, rtol=2.0 ** -8,
                               atol=1e-6 * np.abs(jdt32).max())
    # against JAX's bf16 sums: twice JAX's own bf16-vs-float32 spread
    spread = _rel_l2(jdt, jdt32)
    assert 0 < _rel_l2(tdt, jdt) <= 2 * spread


def test_remat_flag_does_not_change_the_cotangents(march_cases):
    lay, u, jp = march_cases[4]
    ct = np.ones((u.shape[0], 8), np.float32)
    a = _vjps(lay, u, jp, jp.seg_planes, ct, remat=True)
    b = _vjps(lay, u, jp, jp.seg_planes, ct, remat=False)
    assert np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])


def test_segment_function_runs_the_plain_adjoint_per_segment(march_cases):
    """The Function's backward on CPU tensors: march_vjp_plain segment by
    segment from the saved start states equals autograd straight through
    march_plain of all segments (the bookkeeping of segments and starts);
    the forward is K1's plain march, bit for bit."""
    from synthpy_tpu_torch.kernels import march as kmarch
    lay, u, jp = march_cases[8]
    tp = convert.segment_pack(jp, "cpu")
    kw = dict(shape_ab=tp.shape_ab, origin_ab=tp.origin_ab.tolist(),
              inv_ab=tp.inv_spacing_ab.tolist(), dp=tp.dp, layout=lay,
              K=tp.K)
    ct = torch.randn((u.shape[0], 8), generator=torch.Generator(
    ).manual_seed(9))
    leaves = [convert.tensor(u, "cpu").requires_grad_(),
              tp.seg_planes.clone().requires_grad_()]
    out = tz.trace_zscan_segments(
        leaves[0], leaves[1], tp.origin_ab, tp.inv_spacing_ab, tp.dp,
        shape_ab=tp.shape_ab, layout=lay, K=tp.K, n_seg=3)
    got = torch.autograd.grad(out, leaves, ct)
    plain = [t.detach().clone().requires_grad_() for t in leaves]
    ref = kmarch.march_plain(plain[0], plain[1], None, **kw)
    assert torch.equal(out, ref)
    want = torch.autograd.grad(ref, plain, ct)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(
            b.abs().max()))


def test_gradient_outside_the_covered_march_raises(march_cases):
    """Under autograd, what K11 does not cover raises naming ROADMAP B8;
    without a gradient the same calls march."""
    lay, u, jp = march_cases[3]
    tp = convert.segment_pack(jp, "cpu")
    uu = convert.tensor(u, "cpu")
    kw = dict(shape_ab=tp.shape_ab, layout=lay, K=tp.K, n_seg=3)
    args = (tp.origin_ab, tp.inv_spacing_ab, tp.dp)
    q8 = tz.quantize_segment_pack(tp, bits=8)
    bad = [dict(integrator="rk2"), dict(integrator="rk2s2"),
           dict(integrator="rk2s4"), dict(weights="slab")]
    for opts in bad:
        with pytest.raises(NotImplementedError, match="ROADMAP B8"):
            tz.trace_zscan_segments(uu.clone().requires_grad_(),
                                    tp.seg_planes, *args, **kw, **opts)
        assert tz.trace_zscan_segments(uu, tp.seg_planes, *args, **kw,
                                       **opts).shape == uu.shape
    with pytest.raises(NotImplementedError, match="ROADMAP B8"):
        tz.trace_zscan_segments(uu.clone().requires_grad_(), q8.seg_planes,
                                *args, **kw, seg_scales=q8.scales)
    with torch.no_grad():
        tz.trace_zscan_segments(uu.clone().requires_grad_(), tp.seg_planes,
                                *args, **kw, integrator="rk2")


# ---------------------------------------------------------------------------
# the cases of tests/test_inverse.py, on the port (named test_port_*: the
# suite's conftest marks some of the JAX names slow)
# ---------------------------------------------------------------------------

def test_port_cic_image_matches_histogram_totals():
    x = torch.tensor([0.0, 1.0, -2.0, 100.0])   # last ray off-detector
    y = torch.tensor([0.0, -1.0, 2.0, 0.0])
    H = cic_image(x, y, torch.ones(4), (16, 12), 18.0, 13.5)
    np.testing.assert_allclose(float(H.sum()), 3.0, rtol=1e-6)


def test_port_render_gradient_matches_finite_difference():
    d, profile = _lens_profile(21)
    render = make_renderer(d, _beam(5, 800), bins=(24, 18), K=4)
    target = render(5e24 * profile)

    def loss(amp):
        return torch.mean((render(amp * profile) - target) ** 2)

    amp0 = torch.tensor(4e24, requires_grad=True)
    g, = torch.autograd.grad(loss(amp0), amp0)
    eps = 1e20
    with torch.no_grad():
        fd = (loss(torch.tensor(4e24 + eps))
              - loss(torch.tensor(4e24 - eps))) / (2 * eps)
    assert np.isfinite(float(g))
    np.testing.assert_allclose(float(g), float(fd), rtol=2e-2)


def test_port_inverse_recovers_lens_amplitude():
    """Gradient descent on the rendered shadowgram recovers the density
    amplitude from a 25% mis-initialisation."""
    d, profile = _lens_profile(21)
    render = make_renderer(d, _beam(6, 1500), bins=(24, 18), K=4)
    true_amp = 5e24
    target = render(true_amp * profile)
    theta = torch.log(torch.tensor(0.75 * true_amp)).requires_grad_()
    lr, l0 = 0.5, None
    for _ in range(40):
        loss = torch.mean((render(torch.exp(theta) * profile) - target)
                          ** 2)
        g, = torch.autograd.grad(loss, theta)
        loss = float(loss.detach())
        l0 = loss if l0 is None else l0
        with torch.no_grad():
            theta -= lr * g / (g.abs() + 1e-30) * torch.clamp_max(
                g.abs() * 1e3, 0.05)
    rec = float(torch.exp(theta.detach()))
    assert loss < 0.25 * l0
    assert abs(rec - true_amp) / true_amp < 0.08


def test_port_weighted_stages_match_nan_filtered_histogram():
    """The weighted optics path gives the production NaN-filter +
    histogram pipeline's shadowgram totals."""
    d, profile = _lens_profile(25)
    s0 = _beam(8, 3000)
    render = make_renderer(d, s0, bins=(54, 40), K=8)
    H_diff = render(d.ne).numpy()
    H_ref = pipeline.run(d, s0, solver="zscan_seg", seg_K=8,
                         bins=(54, 40)).numpy()
    np.testing.assert_allclose(H_diff.sum(), H_ref.sum(), rtol=1e-6)
    iy, ix = np.indices(H_ref.shape)
    for w in (iy, ix):
        ca = (H_diff * w).sum() / H_diff.sum()
        cb = (H_ref * w).sum() / H_ref.sum()
        assert abs(ca - cb) < 0.5


def test_port_weighted_filters_match_rtm_kill_semantics():
    """Weighted aperture/stop/rect/knife keep exactly the rays the rtm
    filters keep (rect with its corner clip, knife with its (offset, axis,
    direction))."""
    r = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(9), (4, 256)) * 20.0))
    cases = [[("aperture", 10.0)], [("stop", 5.0)], [("rect", 8.0, 12.0)],
             [("knife", 1.0, "x", 1)], [("knife", -2.0, "y", -1)]]
    kills = [lambda rr: rtm.circular_aperture(rr, 10.0),
             lambda rr: rtm.circular_stop(rr, 5.0),
             lambda rr: rtm.rect_aperture(rr, 8.0, 12.0),
             lambda rr: rtm.knife_edge(rr, 1.0, "x", 1),
             lambda rr: rtm.knife_edge(rr, -2.0, "y", -1)]
    for stages, kill in zip(cases, kills):
        _, w = apply_stages_weighted(r, stages)
        _, jw = jinv.apply_stages_weighted(jnp.asarray(r.numpy()), stages)
        survived = torch.isfinite(kill(r)[0])
        assert torch.equal(w > 0, survived), stages
        assert np.array_equal(w.numpy(), np.asarray(jw)), stages


def test_port_cic_edge_deposits_partial_weight():
    """A ray whose cloud half-overlaps the detector edge deposits half its
    weight, and moving it off the edge has a nonzero gradient."""
    Lx, Ly, bins = 16.0, 16.0, (16, 16)
    y_mid = torch.tensor([0.0])
    H = cic_image(torch.tensor([-Lx / 2]), y_mid, torch.ones(1), bins, Lx,
                  Ly)
    np.testing.assert_allclose(float(H.sum()), 0.5, rtol=1e-6)
    x = torch.tensor([-Lx / 2 + 0.01], requires_grad=True)
    g, = torch.autograd.grad(cic_image(x, y_mid, torch.ones(1), bins, Lx,
                                       Ly).sum(), x)
    assert np.isfinite(float(g)) and float(g) != 0.0


def _gauss_domain(dims=21):
    d = ScalarDomain(2 * EXT, dims, phaseshift=True, device="cpu")
    X, Y = d.x[:, None, None], d.y[None, :, None]
    shape = torch.exp(-(X ** 2 + Y ** 2) / (1.5e-3) ** 2) * torch.ones(
        d.dims)
    return d, shape


def test_port_coherent_renderer_produces_fringes_and_gradients():
    """Interferometry through the differentiable path: carrier fringes,
    and a finite, nonzero gradient matching finite differences."""
    d, shape = _gauss_domain()
    d.ne = 5e24 * shape
    render = make_renderer(d, _beam(13, 6000), diagnostic="interferometry",
                           bins=(48, 36), K=4)
    img0 = render(0.0 * shape).numpy()
    assert np.isfinite(img0).all() and img0.sum() > 0
    prof = img0.sum(axis=0)
    assert prof.max() > 2.0 * max(prof.mean(), 1e-12)
    target = render(5e24 * shape)

    def loss(amp):
        return torch.mean((render(amp * shape) - target) ** 2)

    amp0 = torch.tensor(4e24, requires_grad=True)
    g, = torch.autograd.grad(loss(amp0), amp0)
    eps = 1e20
    with torch.no_grad():
        fd = (loss(torch.tensor(4e24 + eps))
              - loss(torch.tensor(4e24 - eps))) / (2 * eps)
    assert np.isfinite(float(g)) and float(g) != 0.0
    np.testing.assert_allclose(float(g), float(fd), rtol=0.3)


def test_port_remat_gradients_match_plain_gradients():
    d, profile = _lens_profile(21)
    s0 = _beam(23, 400)
    r_remat = make_renderer(d, s0, bins=(24, 18), K=4, remat=True)
    r_plain = make_renderer(d, s0, bins=(24, 18), K=4, remat=False)
    target = r_plain(5e24 * profile)

    def grad(render):
        amp = torch.tensor(4e24, requires_grad=True)
        loss = torch.mean((render(amp * profile) - target) ** 2)
        return torch.autograd.grad(loss, amp)[0]

    np.testing.assert_allclose(float(grad(r_remat)), float(grad(r_plain)),
                               rtol=1e-6)


def test_port_phase_map_bench_linear_zeroed_and_differentiable():
    """phase_map is ~linear in ne, zero on unsampled pixels, and its
    masked-MSE gradient is finite, sliver-weight pixels included."""
    d, prof = _lens_profile(33)
    d.phaseshift = True
    ne0 = 5e23 * prof
    render = make_renderer(d, _beam(3, 4000), diagnostic="phase_map",
                           bins=(48, 36), K=8)
    P1 = render(ne0).numpy()
    P2 = render(2.0 * ne0).numpy()
    assert P1.min() < -0.05
    m = np.abs(P1) > 0.05 * np.abs(P1).max()
    ratio = P2[m] / P1[m]
    assert abs(np.median(ratio) - 2.0) < 0.02
    assert np.mean(np.abs(ratio - 2.0) < 0.2) > 0.95
    assert P1[0, 0] == 0.0 and P1[-1, -1] == 0.0
    ne = (1.5 * ne0).requires_grad_()
    loss = torch.sum(torch.from_numpy(m) * (render(ne) - torch.from_numpy(
        P1)) ** 2)
    g, = torch.autograd.grad(loss, ne)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0


def test_port_phase_map_requires_phaseshift_and_bench_kwargs_reach_stages():
    d, prof = _lens_profile(33)
    s0 = _beam(3, 4000)
    with pytest.raises(ValueError, match="phase"):
        make_renderer(d, s0, diagnostic="phase_map", bins=(32, 24))
    ne0 = 2e23 * prof
    blocked = make_renderer(d, s0, diagnostic="schlieren_df", bins=(32, 24),
                            K=8)
    open_ = make_renderer(d, s0, diagnostic="schlieren_df", bins=(32, 24),
                          K=8, bench_kwargs={"schlieren_df": {"stop_R":
                                                              0.05}})
    assert float(blocked(ne0).abs().max()) == 0.0
    assert float(open_(ne0).abs().max()) > 0.0


def test_port_multiview_sees_probing_axis_structure():
    """A parallel view is blind to a blob's offset along its probing axis;
    the orthogonal view separates it (make_multiview_renderers' per-view
    geometry, beams and shared ne)."""
    from synthpy_tpu_torch.inverse import make_multiview_renderers

    d = ScalarDomain(2 * EXT, 17, phaseshift=True, device="cpu")
    x, y, z = (c.numpy() for c in (d.x, d.y, d.z))
    x, y, z = x[:, None, None], y[None, :, None], z[None, None, :]

    def blob(z0):
        return torch.from_numpy((5e23 * np.exp(
            -(x ** 2 + y ** 2 + (z - z0) ** 2) / (1.5e-3) ** 2)).astype(
                np.float32))

    g_hi, g_lo = blob(+1.2e-3), blob(-1.2e-3)
    key = jax.random.PRNGKey(0)
    beams = {v: init_beam(convert.key(jax.random.fold_in(key, i)), 8000,
                          3.2e-3, 0.0, EXT, "circular", probing_direction=v,
                          device="cpu")
             for i, v in enumerate(("z", "x"))}
    renders = make_multiview_renderers(d, beams, diagnostic="phase_map",
                                       bins=(24, 24), K=4, Lx=8.0, Ly=8.0)
    dz = {v: float((renders[v](g_hi) - renders[v](g_lo)).abs().max())
          for v in renders}
    scale = float(renders["z"](g_hi).abs().max())
    assert scale > 1.0
    assert dz["z"] < 0.01 * scale
    assert dz["x"] > 0.5 * scale
