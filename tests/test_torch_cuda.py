"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These need a CUDA device and nvcc, so they skip elsewhere. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX, which the GPU host
need not have.) They cover what ``chip_smoke.py`` does not: every channel
layout (C = 3 to 8), x- and y-probing, all the incoherent benches, the
decimator, the march in any ray order, on scattered warps and over many
segments, the fused quantised and strided builds against the two-step
and post-hoc routes (bit-equal), the detector in the caller's and the
march's ray order and with per-ray exit coordinates, the plain z-scan,
time-domain and adaptive kernels (K4, K5, K6) on every layout and probing
axis, and the pipeline against its CPU run on all three solvers. Float
tables and the marches are held to the plain version's last place or
better (observed: bit equal); detector counts and K6's step counts
exactly.
"""

import numpy as np
import pytest
import torch

from synthpy_tpu_torch import pipeline
from synthpy_tpu_torch.fields import ScalarDomain, layout_of
from synthpy_tpu_torch.fields.domain import build_pack
from synthpy_tpu_torch.kernels import (adaptive, detector, march, pack,
                                       slab_march, time_march)
from synthpy_tpu_torch.optics.compose import BENCHES, shadowgraphy_two_lens
from synthpy_tpu_torch.tracer import init_beam
from synthpy_tpu_torch.tracer import zscan
from synthpy_tpu_torch.tracer.propagator import (default_n_steps, dt_of,
                                                 t_end_of)

pytestmark = pytest.mark.cuda

EXT = 5e-3


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _domain(device, dims=17, probe="z", physics=False):
    d = ScalarDomain(2 * EXT, dims, probing_direction=probe, device=device)
    d.test_lens(ne_0=1e25 if physics else 5e24, LR=2e-3)
    if physics:
        shape = d.dims
        d.external_Te(50.0 + 10.0 * torch.rand(shape, generator=torch.
                                               Generator().manual_seed(1)))
        d.external_Z(2.0 * torch.ones(shape))
        d.inv_brems = d.phaseshift = True
        d.test_B(Bmax=10.0)
    return d


def _pair(dev, **kw):
    """The same scene on the card and on the CPU."""
    g = _domain(dev, **kw)
    c = _domain("cpu", **kw)
    for name in ("ne", "Te", "Z", "B"):
        v = getattr(g, name)
        setattr(c, name, None if v is None else v.cpu())
    return g, c


SCENES = {
    "lens_z": dict(),
    "lens_y": dict(dims=(17, 21, 19), probe="y"),
    "lens_x": dict(dims=(19, 17, 21), probe="x"),
    "physics_z": dict(physics=True),
}
TIERS = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
         "int4": "int4"}


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_pack_kernel_matches_plain(dev, scene, tier):
    g, c = _pair(dev, **SCENES[scene])
    a = zscan.build_segment_pack_device(g, K=8, dtype=TIERS[tier])
    b = zscan.build_segment_pack_device(c, K=8, dtype=TIERS[tier])
    x, y = a.seg_planes.cpu(), b.seg_planes
    assert x.shape == y.shape and x.dtype == y.dtype
    if x.dtype == torch.int8:
        if tier == "int4":
            x = torch.stack([pack.nibble_lo(x), pack.nibble_hi(x)])
            y = torch.stack([pack.nibble_lo(y), pack.nibble_hi(y)])
        assert int((x.to(torch.int16) - y.to(torch.int16)).abs().max()) <= 1
        torch.testing.assert_close(a.scales.cpu(), b.scales, rtol=1e-6,
                                   atol=0)
    else:
        C = layout_of(c).n_channels
        x = x.float().reshape(-1, C)
        y = y.float().reshape(-1, C)
        scale = y.abs().amax(0).clamp_min(1e-30)
        assert float(((x - y).abs().amax(0) / scale).max()) <= 1e-6


@pytest.mark.parametrize("tier", ["int8", "int4", "bf16"])
def test_decimate_kernel_matches_plain(dev, tier):
    g, _ = _pair(dev)
    sp = zscan.build_segment_pack_device(g, K=8, dtype=TIERS[tier])
    a = zscan.decimate_segment_pack(sp, 2)
    cpu = sp._replace(seg_planes=sp.seg_planes.cpu(),
                      scales=None if sp.scales is None else sp.scales.cpu())
    b = zscan.decimate_segment_pack(cpu, 2)
    assert torch.equal(a.seg_planes.cpu(), b.seg_planes)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_fused_quantised_build_is_two_step_route(dev, scene, bits, stride):
    """Codes and scales straight from the volumes == quantize_tables of the
    f32 kernel build (decimated), bit for bit."""
    g, _ = _pair(dev, **SCENES[scene])
    sp = zscan.build_segment_pack_device(
        g, K=8, dtype=torch.int8 if bits == 8 else "int4",
        plane_stride=stride)
    full = zscan.build_segment_pack_device(g, K=8, dtype=torch.float32)
    C = layout_of(g).n_channels
    table = pack.decimate_tables(full.seg_planes, 8, C, stride)
    codes, scales = pack.quantize_tables(table, 8 // stride, C, bits)
    assert torch.equal(sp.seg_planes, codes)
    assert torch.equal(sp.scales, scales)


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_strided_build_is_decimated_full_build(dev, scene, tier):
    g, _ = _pair(dev, **SCENES[scene])
    for stride in (2, 4):
        sp = zscan.build_segment_pack_device(g, K=8, dtype=TIERS[tier],
                                             plane_stride=stride)
        full = zscan.build_segment_pack_device(g, K=8, dtype=TIERS[tier])
        dec = zscan.decimate_segment_pack(full, stride)
        assert torch.equal(sp.seg_planes, dec.seg_planes)
        assert (sp.K, sp.n_slabs, sp.dp) == (dec.K, dec.n_slabs, dec.dp)
        if dec.scales is not None:
            assert torch.equal(sp.scales, dec.scales)


# int4 packs run on the even-stride integrators only
MARCHES = [(t, i) for t in ("f32", "int8", "int4")
           for i in ("rk4", "rk2", "rk2s2", "rk2s4")
           if t != "int4" or i in ("rk2s2", "rk2s4")]


@pytest.mark.parametrize("weights", ["stage", "slab"])
@pytest.mark.parametrize("tier,integrator", MARCHES)
@pytest.mark.parametrize("scene", ["physics_z", "lens_y"])
def test_march_kernel_matches_plain(dev, scene, tier, integrator, weights):
    g, c = _pair(dev, **SCENES[scene])
    K = 8 if tier == "int4" else 9
    sp = zscan.build_segment_pack_device(g, K=K, dtype=TIERS[tier])
    s0 = init_beam(0, 4096, 2.2e-3, 2e-3, g.extent, "circular",
                   probing_direction=g.probing_direction, device=dev)
    u = zscan.permute_state(s0, g.probing_direction).contiguous()
    kw = dict(shape_ab=sp.shape_ab, origin_ab=sp.origin_ab.tolist(),
              inv_ab=sp.inv_spacing_ab.tolist(), dp=sp.dp,
              layout=layout_of(c), K=sp.K, integrator=integrator,
              weights=weights, qbits=sp.qbits)
    a = march.march(u, sp.seg_planes, sp.scales, **kw).cpu()
    b = march.march_plain(u.cpu(), sp.seg_planes.cpu(),
                          None if sp.scales is None else sp.scales.cpu(),
                          **kw)
    assert torch.equal(a.isnan(), b.isnan())
    scale = b.abs().nan_to_num(0).amax(0).clamp_min(1e-30)
    assert float(((a - b).abs().nan_to_num(0).amax(0) / scale).max()) \
        <= 2e-6


ORDER_CASES = ["shuffled", "sorted", "square_beam", "sparse_square",
               "multi_segment"]


@pytest.mark.parametrize("case", ORDER_CASES)
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_march_kernel_any_ray_order_matches_plain(dev, scene, case):
    """The kernel marches rays in entry-cell order; in sparse_square a
    warp's rays still lie scattered over the grid. Output row i is ray i
    in every case, bit for bit whatever the order, and matches the plain
    version."""
    g, c = _pair(dev, **SCENES[scene])
    K = 4 if case == "multi_segment" else 24
    square = case in ("square_beam", "sparse_square")
    s0 = init_beam(1, 300 if case == "sparse_square" else 4096,
                   g.extent if square else 2.2e-3, 2e-3, g.extent,
                   "square" if square else "circular",
                   probing_direction=g.probing_direction, device=dev)
    u = zscan.permute_state(s0, g.probing_direction).contiguous()
    for tier, integrator, weights in (("f32", "rk4", "stage"),
                                      ("bf16", "rk2", "slab"),
                                      ("int4", "rk2s4", "slab")):
        sp = zscan.build_segment_pack_device(g, K=K, dtype=TIERS[tier])
        assert (sp.seg_planes.shape[0] > 1) == (case == "multi_segment")
        kw = dict(shape_ab=sp.shape_ab, origin_ab=sp.origin_ab.tolist(),
                  inv_ab=sp.inv_spacing_ab.tolist(), dp=sp.dp,
                  layout=layout_of(c), K=sp.K, integrator=integrator,
                  weights=weights, qbits=sp.qbits)
        geo = (sp.shape_ab, kw["origin_ab"], kw["inv_ab"])
        perm = (torch.randperm(u.shape[0], generator=torch.Generator(
            device=dev).manual_seed(5), device=dev) if case == "shuffled"
            else march.ray_order(u, *geo) if case == "sorted"
            else torch.arange(u.shape[0], device=dev))
        up = u[perm].contiguous()
        a = march.march(up, sp.seg_planes, sp.scales, **kw)
        assert torch.equal(a, march.march(u, sp.seg_planes, sp.scales,
                                          **kw)[perm])
        b = march.march_plain(up.cpu(), sp.seg_planes.cpu(),
                              None if sp.scales is None else sp.scales.cpu(),
                              **kw)
        a = a.cpu()
        assert torch.equal(a.isnan(), b.isnan())
        scale = b.abs().nan_to_num(0).amax(0).clamp_min(1e-30)
        assert float(((a - b).abs().nan_to_num(0).amax(0)
                      / scale).max()) <= 2e-6


@pytest.mark.parametrize("probe", ["x", "y", "z"])
@pytest.mark.parametrize("bench", sorted(n for n, (_, coh) in BENCHES.items()
                                         if not coh))
def test_detector_kernel_matches_plain(dev, bench, probe):
    s0 = init_beam(3, 20000, 4e-3, 8e-3, EXT, "circular",
                   probing_direction=probe, device=dev)
    uf = zscan.permute_state(s0, probe).contiguous()
    st = BENCHES[bench][0]()
    w = torch.rand(uf.shape[0], generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    args = (EXT * 1.01, EXT, probe, st, (54, 40), ((-9.0, 9.0),
                                                  (-6.75, 6.75)))
    Hp = detector.detect_plain(uf.cpu(), *args)
    Hwp = detector.detect_plain(uf.cpu(), *args, weights=w.cpu())
    # the caller's order, and the march's entry-cell order on a grid of
    # the beam's size
    na = 33
    order = march.ray_order(uf, (na, na), (-EXT, -EXT),
                            ((na - 1) / (2 * EXT),) * 2)
    for o in (None, order):
        u, wo = (uf, w) if o is None else (uf[o].contiguous(), w[o])
        H = detector.detect(u, *args).cpu()
        assert torch.equal(H, Hp) and float(H.sum()) > 0
        Hw = detector.detect(u, *args, weights=wo).cpu()
        torch.testing.assert_close(Hw, Hwp, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("tier,integrator", [("bf16", "rk2"),
                                             ("int8", "rk2s2"),
                                             ("int4", "rk2s4")])
def test_pipeline_on_card_matches_cpu(dev, tier, integrator):
    g, c = _pair(dev, dims=33, physics=True)
    names = ("shadowgraphy", "polarimetry", "schlieren_lf")
    kw = dict(solver="zscan_seg", pack_dtype=tier, seg_K=32,
              integrator=integrator, seg_weights="slab", bins=(54, 40),
              diagnostic=names)
    s0 = init_beam(0, 8192, 2e-3, 0.0, g.extent, "circular", device=dev)
    Hg = pipeline.run(g, s0, **kw)
    Hc = pipeline.run(c, s0.cpu(), **kw)
    for n in names:
        a, b = Hg[n].cpu(), Hc[n]
        np.testing.assert_allclose(a.sum(), b.sum(), rtol=1e-5)
        assert float((a - b).abs().sum()) <= 2e-3 * float(b.sum()) + 1e-3


# channel layouts (inv_brems, phaseshift, B_on): C = 3, 4, 5, 6, 8
LAYOUTS = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 1)]


def _layout_pair(dev, layout, probe="z", dims=(17, 19, 21)):
    """The lens along ``probe`` with the channels of ``layout`` switched
    on, on the card and on the CPU."""
    ib, ps, bon = layout
    out = []
    for device in (dev, "cpu"):
        d = ScalarDomain(2 * EXT, dims, probing_direction=probe,
                         inv_brems=bool(ib), phaseshift=bool(ps),
                         device=device)
        d.test_liner(ne_0=8e24, LR=1.8e-3) if probe == "y" else \
            d.test_lens(ne_0=8e24, LR=1.8e-3)
        g = torch.Generator().manual_seed(1)
        if ib:
            d.external_Te(50.0 + 10.0 * torch.rand(d.dims, generator=g))
            d.external_Z(2.0 * torch.ones(d.dims))
        if bon:
            d.test_B(Bmax=10.0)
        out.append(d)
    return out


def _rays(dev, probe, n=4096):
    """A bundle a fifth of which enters outside the box, one NaN ray."""
    s0 = init_beam(2, n, 2.5e-3, 1e-3, EXT, "circular",
                   probing_direction=probe, device=dev)
    a = [i for i in range(3) if i != "xyz".index(probe)][0]
    s0[a, ::5] += 4e-3
    s0[3 + "xyz".index(probe), 7] = float("nan")
    return s0


def _same(a, b):
    """Bit-equal, NaN rows included."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def _close(a, b, tol=2e-6):
    a, b = a.cpu(), b.cpu()
    assert torch.equal(a.isnan(), b.isnan())
    scale = b.abs().nan_to_num(0).amax(0).clamp_min(1e-30)
    assert float(((a - b).abs().nan_to_num(0).amax(0) / scale).max()) <= tol


CASES = [(lay, "z") for lay in LAYOUTS] + [((1, 1, 1), "x"),
                                           ((1, 1, 1), "y")]


@pytest.mark.parametrize("layout,probe", CASES)
def test_time_march_kernel_matches_plain(dev, layout, probe):
    g, c = _layout_pair(dev, layout, probe)
    pk = build_pack(g)
    rows = _rays(dev, probe).T.contiguous()
    n = default_n_steps(c, c.extent)
    kw = dict(layout=layout_of(c), n_steps=n)
    a = time_march.march(rows, pk.channels, pk.origin, pk.inv_spacing,
                         dt_of(n, c.extent), **kw)
    # ray order moves no result
    b = time_march.launch(time_march.KERNEL, rows, pk.channels, pk.origin,
                          pk.inv_spacing, dt_of(n, c.extent),
                          torch.arange(rows.shape[0], device=dev), **kw)
    assert _same(a, b)
    p = time_march.march_plain(rows.cpu(), pk.channels.cpu(), pk.origin,
                               pk.inv_spacing, dt_of(n, c.extent), **kw)
    _close(a, p)


@pytest.mark.parametrize("substeps", [1, 4])
@pytest.mark.parametrize("tier", ["f32", "bf16"])
@pytest.mark.parametrize("layout,probe", CASES)
def test_slab_march_kernel_matches_plain(dev, layout, probe, tier,
                                         substeps):
    g, c = _layout_pair(dev, layout, probe)
    zp = zscan.make_zscan_pack(build_pack(g), layout_of(c), probe,
                               dtype=TIERS[tier])
    u = zscan.permute_state(_rays(dev, probe), probe).contiguous()
    args = (zp.planes, zp.origin_ab.tolist(), zp.inv_spacing_ab.tolist(),
            zp.dp)
    kw = dict(layout=layout_of(c), n_slabs=zp.planes.shape[0] - 1,
              substeps=substeps)
    a = slab_march.march(u, *args, **kw)
    b = slab_march.launch(slab_march.KERNEL, u, *args,
                          torch.arange(u.shape[0], device=dev), **kw)
    assert _same(a, b)
    p = slab_march.march_plain(u.cpu(), zp.planes.cpu(), *args[1:], **kw)
    _close(a, p)


@pytest.mark.parametrize("local_cap", [True, False])
@pytest.mark.parametrize("layout,probe", CASES)
def test_adaptive_kernel_matches_plain(dev, layout, probe, local_cap):
    g, c = _layout_pair(dev, layout, probe)
    pk = build_pack(g)
    ax = "xyz".index(probe)
    rows = _rays(dev, probe, 2048)[:, 8:].T.contiguous()   # no NaN ray
    kw = dict(layout=layout_of(c), p_axis=ax if local_cap else None,
              plane_amax=(adaptive.plane_amax_of(pk.channels, ax)
                          if local_cap else None))
    s, n_acc, n_rej = adaptive.trace_rk45(
        rows, pk.channels, pk.origin, pk.inv_spacing, t_end_of(c.extent),
        **kw)
    kw["plane_amax"] = None if not local_cap else kw["plane_amax"].cpu()
    sp, acc_p, rej_p = adaptive.trace_rk45_plain(
        rows.cpu(), pk.channels.cpu(), pk.origin, pk.inv_spacing,
        t_end_of(c.extent), **kw)
    assert (n_acc, n_rej) == (acc_p, rej_p) and n_acc > 0
    _close(s, sp)


def test_adaptive_kernel_rejects_and_stops_like_plain(dev):
    """A tight tolerance makes the controller reject steps; a step budget
    stops both in the middle of a batch of launches."""
    g, c = _layout_pair(dev, (0, 0, 0), dims=21)
    pk = build_pack(g)
    rows = init_beam(8, 2048, 1.5e-3, 0.0, EXT, "circular",
                     device=dev).T.contiguous()
    for kw in (dict(rtol=1e-9, atol=1e-8, max_steps=54),
               dict(max_steps=adaptive.CHECK_EVERY + 3)):
        a = adaptive.trace_rk45(rows, pk.channels, pk.origin, pk.inv_spacing,
                                t_end_of(c.extent), layout=layout_of(c),
                                **kw)
        b = adaptive.trace_rk45_plain(rows.cpu(), pk.channels.cpu(),
                                      pk.origin, pk.inv_spacing,
                                      t_end_of(c.extent),
                                      layout=layout_of(c), **kw)
        assert a[1:] == b[1:]
        _close(a[0], b[0])
    assert b[1] + b[2] == adaptive.CHECK_EVERY + 3


def test_adaptive_kernel_empty_bundle_like_plain(dev):
    """No rays: every step rejected up to the budget, nothing launched."""
    g, c = _layout_pair(dev, (0, 0, 0), dims=21)
    pk = build_pack(g)
    adaptive.KERNEL.launches = 0
    kw = dict(layout=layout_of(c), max_steps=37)
    s, n_acc, n_rej = adaptive.trace_rk45(
        torch.empty((0, 9), device=dev), pk.channels, pk.origin,
        pk.inv_spacing, t_end_of(c.extent), **kw)
    sp, acc_p, rej_p = adaptive.trace_rk45_plain(
        torch.empty((0, 9)), pk.channels.cpu(), pk.origin, pk.inv_spacing,
        t_end_of(c.extent), **kw)
    assert (n_acc, n_rej) == (acc_p, rej_p) == (0, 37)
    assert s.shape == sp.shape == (0, 9) and s.is_cuda
    assert adaptive.KERNEL.launches == 0


@pytest.mark.parametrize("probe", ["x", "y", "z"])
def test_detector_per_ray_exit_coordinate_matches_plain(dev, probe):
    s0 = init_beam(3, 20000, 4e-3, 8e-3, EXT, "circular",
                   probing_direction=probe, device=dev)
    uf = zscan.permute_state(s0, probe).contiguous()
    p = (EXT + 1e-3 * torch.rand(uf.shape[0], generator=torch.Generator(
        device=dev).manual_seed(4), device=dev)).contiguous()
    args = (EXT, probe, shadowgraphy_two_lens(), (54, 40),
            ((-9.0, 9.0), (-6.75, 6.75)))
    H = detector.detect(uf, p, *args).cpu()
    assert torch.equal(H, detector.detect_plain(uf.cpu(), p.cpu(), *args))
    assert float(H.sum()) > 0


@pytest.mark.parametrize("solver", ["time", "zscan"])
def test_solvers_on_card_match_cpu(dev, solver):
    g, c = _pair(dev, dims=33, physics=True)
    names = ("shadowgraphy", "polarimetry", "schlieren_lf")
    kw = dict(solver=solver, bins=(54, 40), diagnostic=names)
    s0 = init_beam(0, 8192, 2e-3, 0.0, g.extent, "circular", device=dev)
    Hg = pipeline.run(g, s0, **kw)
    Hc = pipeline.run(c, s0.cpu(), **kw)
    for n in names:
        a, b = Hg[n].cpu(), Hc[n]
        np.testing.assert_allclose(a.sum(), b.sum(), rtol=1e-5)
        assert float((a - b).abs().sum()) <= 2e-3 * float(b.sum()) + 1e-3
