"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These need a CUDA device and nvcc, so they skip elsewhere. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX, which the GPU host
need not have.) They cover what ``chip_smoke.py`` does not: every channel
layout (C = 3 to 8), x- and y-probing, all the incoherent benches, the
decimator, the march in any ray order, on scattered warps and over many
segments, the fused quantised and strided builds against the two-step
and post-hoc routes (bit-equal), the detector in the caller's and the
march's ray order, and the pipeline against its CPU run. Float tables and
the march are held to the plain version's last place or better (observed:
bit equal); detector counts exactly.
"""

import numpy as np
import pytest
import torch

from synthpy_tpu_torch import pipeline
from synthpy_tpu_torch.fields import ScalarDomain, layout_of
from synthpy_tpu_torch.kernels import detector, march, pack
from synthpy_tpu_torch.optics.compose import BENCHES
from synthpy_tpu_torch.tracer import init_beam
from synthpy_tpu_torch.tracer import zscan

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
    kw = dict(pack_dtype=tier, seg_K=32, integrator=integrator,
              seg_weights="slab", bins=(54, 40), diagnostic=names)
    s0 = init_beam(0, 8192, 2e-3, 0.0, g.extent, "circular", device=dev)
    Hg = pipeline.run(g, s0, **kw)
    Hc = pipeline.run(c, s0.cpu(), **kw)
    for n in names:
        a, b = Hg[n].cpu(), Hc[n]
        np.testing.assert_allclose(a.sum(), b.sum(), rtol=1e-5)
        assert float((a - b).abs().sum()) <= 2e-3 * float(b.sum()) + 1e-3
