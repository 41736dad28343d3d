"""The sharded field path of the port: ``grf_domain_fft(mesh=)`` ->
``ScalarDomain.external_ne(Sharded)`` -> ``build_segment_pack_device(mesh=)``
(each shard K2 on its row window) -> the grid-sharded march and
``pipeline.run(mesh=, grid_axis=)``, against the port's single-device route
and the JAX package's sharded route (``tests/test_parallel.py:578-636``) on
the conftest's 8 fake CPU devices; the port on meshes of ``["cpu"] * G``.

Tolerances:
* the sharded port pack, gathered, is bit-equal to the port's
  single-device pack (codes, bytes and scales), as JAX's is to its own;
* against JAX's sharded pack, as ``tests/test_torch_pack.py`` holds the
  single-device pack to JAX's: the dithered int8 / int4 codes bit-equal,
  the scales and f32 channels within 1e-6 of the channel's largest value
  (XLA folds the builder's divisions by constants into reciprocal
  multiplications, a last-place difference), the phase channel
  omega (sqrt(1 - ne/nc) - 1) within 2e-5 (at ne/nc ~ 1e-2 one step of
  the root is ~1e-5 of the difference; the single-device port pack
  differs from JAX's by 8.2e-6 on this field), bf16 within one bf16
  step more;
* the windowed plain K2 of one shard equals the same rows of the whole
  plain build, bit for bit;
* the sharded GRF within 1e-5 of max |f| of the single-device field (JAX's
  bound, ``tests/test_parallel.py:573``);
* images: the chain's image equals the port's single-device run on the
  gathered pack exactly, and JAX's chain image to equal sums with
  |H - H_jax|.sum() <= 0.002 H_jax.sum() (the fields differ by the FFTs'
  summation order, the packs in the last place: C.8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from synthpy_tpu import pipeline as jpipe
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields import layout_of as jlayout_of
from synthpy_tpu.fields.grf import grf_domain_fft as jgrf
from synthpy_tpu.fields.grf import kolmogorov as jkolmogorov
from synthpy_tpu.parallel.mesh import make_gridsharded_segment_tracer as jgst
from synthpy_tpu.tracer import init_beam
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu_torch import pipeline as tpipe
from synthpy_tpu_torch import random as trandom
from synthpy_tpu_torch.fields import ScalarDomain, layout_of
from synthpy_tpu_torch.fields.domain import build_pack, peak_ne_over_nc
from synthpy_tpu_torch.fields.grf import grf_domain_fft, kolmogorov
from synthpy_tpu_torch.kernels import pack
from synthpy_tpu_torch.parallel import (Mesh, all_to_all,
                                        make_gridsharded_segment_tracer,
                                        pmax)
from synthpy_tpu_torch.parallel.mesh import Sharded, shard
from synthpy_tpu_torch.tracer import zscan as tz

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
BINS = (48, 36)
TIERS = {"f32": (jnp.float32, torch.float32, None),
         "bf16": (jnp.bfloat16, torch.bfloat16, None),
         "int8": (jnp.int8, torch.int8, 5),
         "int4": ("int4", "int4", 5)}


def _jmesh(G):
    return jax.make_mesh((G,), ("grid",), devices=jax.devices()[:G],
                         axis_types=(AxisType.Auto,))


def _mesh(G):
    return Mesh((G,), ("grid",), devices=["cpu"] * G)


@pytest.fixture(scope="module")
def field():
    """ne = 1e25 (1 + 0.5 f) of JAX's sharded 32^3 GRF, as numpy."""
    _, f = jgrf(jax.random.PRNGKey(3), jkolmogorov, 2e-3, 4e-4, EXT, 16,
                mesh=_jmesh(8))
    return np.asarray(1e25 * (1.0 + 0.5 * f))


def _physics(seed=2):
    rng = np.random.default_rng(seed)
    Te = 50.0 + 20.0 * rng.random((32, 32, 32))
    Z = 1.0 + 2.0 * rng.random((32, 32, 32))
    B = rng.standard_normal((32, 32, 32, 3))
    return Te, Z, B


def _domains(ne, probe, G, physics=False):
    """The JAX domain, the port's with ne split in axis-0 row blocks (as
    grf_domain_fft(mesh=) gives it) and the port's with the whole ne."""
    jd = JDomain(2 * EXT, 32, probing_direction=probe).external_ne(ne)
    ts = ScalarDomain(2 * EXT, 32, probing_direction=probe,
                      device="cpu").external_ne(
        shard(torch.tensor(ne), _mesh(G), ("grid",)))
    t1 = ScalarDomain(2 * EXT, 32, probing_direction=probe,
                      device="cpu").external_ne(torch.tensor(ne))
    for d in (jd, ts, t1):
        d.phaseshift = True
        if physics:
            Te, Z, B = _physics()
            d.external_Te(Te)
            d.external_Z(Z)
            d.external_B(B)
            d.inv_brems = True
    return jd, ts, t1


def _per_channel_close(a, b, lay, step=0.0):
    """a, b (..., k*C + c) values; within 1e-6 of each channel's largest
    value (the phase channel 2e-5), and ``step`` of each value (bf16: one
    step of the type)."""
    C = lay.n_channels
    a = a.reshape(-1, C).astype(np.float64)
    b = b.reshape(-1, C).astype(np.float64)
    for c in range(C):
        scale = max(np.abs(b[:, c]).max(), 1e-30)
        rtol = 2e-5 if lay.phaseshift and c == lay.phase_index else 1e-6
        tol = rtol * scale + step * np.abs(b[:, c])
        assert (np.abs(a[:, c] - b[:, c]) <= tol).all(), f"channel {c}"


def _check_against_jax(ts, js, tier, lay):
    a = ts.seg_planes.gather()
    b = np.asarray(js.seg_planes)
    assert tuple(a.shape) == b.shape
    if tier in ("int8", "int4"):
        np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_allclose(ts.scales.numpy(), np.asarray(js.scales),
                                   rtol=1e-6, atol=0)
    else:
        # one bf16 step: at most 2^-7 of the value
        step = 2.0**-7 if tier == "bf16" else 0.0
        _per_channel_close(a.float().numpy(), b.astype(np.float32), lay,
                           step=step)


def _sharded_like_single(ts, t1, G):
    """The sharded pack: G row blocks, gathered bit-equal to the single
    build, the rest of the pack equal."""
    assert isinstance(ts.seg_planes, Sharded)
    assert ts.seg_planes.spec[:2] == (None, "grid")
    na, nb = t1.shape_ab
    for blk in ts.seg_planes.shards:
        assert blk.shape[1] == na * nb // G
    assert torch.equal(ts.seg_planes.gather(), t1.seg_planes)
    if t1.scales is None:
        assert ts.scales is None
    else:
        assert torch.equal(ts.scales, t1.scales)
    assert (ts.shape_ab, ts.K, ts.n_slabs, ts.p0, ts.dp, ts.omega,
            ts.qbits) == (t1.shape_ab, t1.K, t1.n_slabs, t1.p0, t1.dp,
                          t1.omega, t1.qbits)
    assert torch.equal(ts.origin_ab, t1.origin_ab)


# ---------------------------------------------------------------------------
# The sharded pack build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("probe", ["x", "y", "z"])
@pytest.mark.parametrize("G", [4, 8])
def test_port_sharded_pack_equals_single_device_and_jax(field, G, probe,
                                                        tier):
    jdt, tdt, dither = TIERS[tier]
    jd, ts_dom, t1_dom = _domains(field, probe, G)
    js = jz.build_segment_pack_device(jd, K=8, dtype=jdt, dither=dither,
                                      mesh=_jmesh(G))
    ts = tz.build_segment_pack_device(ts_dom, K=8, dtype=tdt, dither=dither,
                                      mesh=ts_dom.ne_stored.mesh)
    t1 = tz.build_segment_pack_device(t1_dom, K=8, dtype=tdt, dither=dither)
    _sharded_like_single(ts, t1, G)
    _check_against_jax(ts, js, tier, layout_of(t1_dom))
    # the domain's ne stayed sharded
    assert isinstance(ts_dom.ne_stored, Sharded)


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("probe", ["x", "z"])
def test_port_sharded_pack_strided_and_full_physics(field, probe, tier):
    """plane_stride=2 on the C = 8 layout (inv_brems, phaseshift, B_on),
    G = 4: Te, Z and B split from the domain's device, ne from its row
    blocks."""
    jdt, tdt, dither = TIERS[tier]
    jd, ts_dom, t1_dom = _domains(field, probe, 4, physics=True)
    assert layout_of(t1_dom).n_channels == 8
    js = jz.build_segment_pack_device(jd, K=8, dtype=jdt, dither=dither,
                                      plane_stride=2, mesh=_jmesh(4))
    ts = tz.build_segment_pack_device(ts_dom, K=8, dtype=tdt, dither=dither,
                                      plane_stride=2,
                                      mesh=ts_dom.ne_stored.mesh)
    t1 = tz.build_segment_pack_device(t1_dom, K=8, dtype=tdt, dither=dither,
                                      plane_stride=2)
    _sharded_like_single(ts, t1, 4)
    assert ts.K == 4
    _check_against_jax(ts, js, tier, layout_of(t1_dom))


def _k2_kw(d, K=8):
    from synthpy_tpu_torch import constants as c

    p_ax = "xyz".index(d.probing_direction)
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    coords = (d.x, d.y, d.z)
    omega = float(c.omega_from_lwl(1064e-9))
    lay = layout_of(d)
    return p_ax, a_ax, dict(
        p_ax=p_ax, layout=lay, K=K, n_seg=-(-(d.dims[p_ax] - 1) // K),
        pref=-0.5 * c.C**2 / float(c.critical_density(omega)),
        da=float(coords[a_ax][1] - coords[a_ax][0]),
        db=float(coords[b_ax][1] - coords[b_ax][0]),
        dp=float(coords[p_ax][1] - coords[p_ax][0]), omega=omega,
        verdet=c.verdet_constant(1064e-9) if lay.B_on else 0.0)


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("probe", ["x", "y", "z"])
def test_port_windowed_plain_k2_is_rows_of_whole_build(field, probe, tier):
    """K2's windowed plain version on each of 4 windows (the halo rows cut
    by hand) gives the same rows as the whole plain build, for every tier
    and probing axis; the windows' amaxes max-reduce to the whole build's;
    a window without its halo is refused."""
    _, _, t1_dom = _domains(field, probe, 4, physics=probe == "z")
    p_ax, a_ax, kw = _k2_kw(t1_dom)
    vols = {"ne": t1_dom.ne, "Te": t1_dom.Te, "Z": t1_dom.Z,
            "B": t1_dom.B}
    _, tdt, dither = TIERS[tier]
    key = None if dither is None else trandom.key_of(dither)
    C = kw["layout"].n_channels
    G, na = 4, t1_dom.dims[a_ax]
    n = na // G
    nb = t1_dom.dims[[a for a in range(3) if a != p_ax][1]]
    if tier in ("int8", "int4"):
        bits = 8 if tier == "int8" else 4
        whole, wscale = pack.build_quantized_tables_plain(
            vols, bits=bits, dither=key, **kw)
    else:
        whole = pack.build_tables_plain(vols, dtype=tdt, **kw)
    wins, parts = [], []
    for g in range(G):
        part = {k: None if v is None else v.narrow(a_ax, g * n, n)
                for k, v in vols.items()}
        lo = vols["ne"].narrow(a_ax, g * n - 1, 1) if g > 0 else None
        hi = vols["ne"].narrow(a_ax, (g + 1) * n, 1) if g < G - 1 else None
        wins.append(pack.Window(g * n, na, lo, hi))
        parts.append(part)
    if tier in ("int8", "int4"):
        amax = [pack.build_amax(p, window=w, **kw)
                for p, w in zip(parts, wins)]
        whole_amax = pack.build_amax(vols, **kw)
        red = amax[0]
        for a in amax[1:]:
            red = torch.maximum(red, a)
        assert torch.equal(red, whole_amax)
        assert not torch.equal(amax[0], whole_amax)
    for g, (part, win) in enumerate(zip(parts, wins)):
        rows = whole[:, g * n * nb:(g + 1) * n * nb]
        if tier in ("int8", "int4"):
            got, sc = pack.build_quantized_tables(part, bits=bits,
                                                  dither=key, window=win,
                                                  amax=red, **kw)
            assert torch.equal(sc, wscale)
        else:
            got = pack.build_tables(part, dtype=tdt, window=win, **kw)
        assert got.shape == rows.shape
        assert torch.equal(got, rows), f"window {g}"
    assert C == kw["layout"].n_channels
    with pytest.raises(ValueError, match="halo"):
        pack.build_tables(parts[1], dtype=torch.float32,
                          window=pack.Window(n, na, None, wins[1].hi), **kw)


def test_port_sharded_build_and_run_never_gather_ne(field, monkeypatch):
    """With ``Sharded.gather`` raising for the ne, the sharded build (every
    tier) and ``pipeline.run(mesh=, grid_axis=)`` run on the sharded ne; a
    single-device reader of ``domain.ne`` gathers it (the one place)."""
    jd, ts_dom, t1_dom = _domains(field, "z", 4)
    m = ts_dom.ne_stored.mesh
    s0 = torch.tensor(np.asarray(init_beam(jax.random.PRNGKey(4), 2000,
                                           7e-3, 1e-3, EXT, "circular")))
    kw = dict(solver="zscan_seg", seg_K=8, integrator="rk2s2",
              seg_weights="slab", bins=BINS)
    ref = tpipe.run(t1_dom, s0, **kw)
    frac = peak_ne_over_nc(t1_dom)

    gather = Sharded.gather

    def refuse(self, device=None):
        # the ne, or a value of its shape made from it
        if self.shape == tuple(ts_dom.dims):
            raise AssertionError("the sharded route gathered the ne")
        return gather(self, device)

    monkeypatch.setattr(Sharded, "gather", refuse)
    for tier in TIERS.values():
        sp = tz.build_segment_pack_device(ts_dom, K=8, dtype=tier[1],
                                          dither=tier[2], mesh=m)
        assert isinstance(sp.seg_planes, Sharded)
    assert peak_ne_over_nc(ts_dom) == frac
    H = tpipe.run(ts_dom, s0, mesh=m, grid_axis="grid", **kw)
    with pytest.raises(AssertionError, match="gathered"):
        ts_dom.ne
    monkeypatch.undo()
    assert torch.equal(H, ref) and float(H.sum()) > 0
    # a single-device build of the sharded domain reads the gathered ne
    assert torch.equal(ts_dom.ne, t1_dom.ne)
    sp1 = tz.build_segment_pack_device(ts_dom, K=8, dtype=torch.float32)
    assert torch.equal(sp1.seg_planes, tz.build_segment_pack_device(
        t1_dom, K=8, dtype=torch.float32).seg_planes)
    assert torch.equal(build_pack(ts_dom).channels,
                       build_pack(t1_dom).channels)


def test_port_sharded_build_refusals(field):
    jd, ts_dom, t1_dom = _domains(field, "z", 4)
    with pytest.raises(ValueError, match="must divide"):
        tz.build_segment_pack_device(t1_dom, K=8, mesh=Mesh(
            (3,), ("grid",), devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="not split over"):
        tz.build_segment_pack_device(ts_dom, K=8, mesh=_mesh(4))
    with pytest.raises(ValueError, match="sharded ne"):
        ScalarDomain(2 * EXT, 32, device="cpu").external_ne(
            ts_dom.ne_stored, host=True)
    with pytest.raises(ValueError, match="grid dims"):
        ScalarDomain(2 * EXT, 16, device="cpu").external_ne(
            ts_dom.ne_stored)
    pm = Mesh((2,), ("rays",), devices=["cpu"] * 2, process_axis="rays")
    with pytest.raises(NotImplementedError, match="A.17"):
        tz.build_segment_pack_device(t1_dom, K=8, mesh=pm,
                                     mesh_axis="rays")


# ---------------------------------------------------------------------------
# The mesh's shard-wise values and collectives
# ---------------------------------------------------------------------------

def test_port_sharded_map_all_to_all_and_pmax():
    m = Mesh((4, 2), ("grid", "rays"), devices=["cpu"] * 8)
    x = torch.arange(8 * 12 * 3, dtype=torch.float32).reshape(8, 12, 3)
    sh = shard(x, m, ("grid",))
    y = 1e25 * (1.0 + 0.5 * sh)
    assert isinstance(y, Sharded) and y.spec == sh.spec
    assert torch.equal(y.gather(), 1e25 * (1.0 + 0.5 * x))
    assert torch.equal((sh * 2 + 1).gather(), x * 2 + 1)
    # blocks shared by positions stay shared
    assert y.shards[0] is y.shards[1]
    with pytest.raises(TypeError):
        sh + sh
    with pytest.raises(ValueError, match="shape"):
        sh.map(lambda s: s[:1])
    # axis-0 blocks -> axis-1 blocks, and back
    cols = all_to_all(sh.shards, m, "grid", split_dim=1, concat_dim=0)
    for p in range(8):
        g = m.index(p, "grid")
        assert torch.equal(cols[p], x[:, 3 * g:3 * (g + 1)])
    back = all_to_all(cols, m, "grid", split_dim=0, concat_dim=1)
    assert all(torch.equal(b, s) for b, s in zip(back, sh.shards))
    with pytest.raises(ValueError, match="divide"):
        all_to_all(sh.shards, m, "grid", split_dim=2, concat_dim=0)
    mx = pmax([s.amax(dim=0) for s in sh.shards], m, "grid")
    assert all(torch.equal(v, x.amax(dim=0)) for v in mx)


# ---------------------------------------------------------------------------
# The chain: sharded GRF -> external_ne(Sharded) -> sharded pack -> march
# ---------------------------------------------------------------------------

def test_port_sharded_field_chain_matches_jax():
    """The JAX test's chain (tests/test_parallel.py:578-636) on both sides,
    each from its own sharded GRF of the same key: the port's sharded
    field within 1e-5 of its single-device field, the pack split over 8
    shards bit-equal to the single-device pack of the same field (f32 and
    dithered int8), the grid-sharded march bit-equal to the single-device
    march and within 2e-6 of a column of JAX's (C.6), and
    ``pipeline.run(mesh=, grid_axis=)`` on the sharded domain equal to the
    single-device run and close to JAX's run."""
    jm, tm = _jmesh(8), _mesh(8)
    _, jf = jgrf(jax.random.PRNGKey(3), jkolmogorov, 2e-3, 4e-4, EXT, 16,
                 mesh=jm)
    jne = 1e25 * (1.0 + 0.5 * jf)
    jd = JDomain(2 * EXT, 32).external_ne(jne)
    jd.phaseshift = True
    jsp = jz.build_segment_pack_device(jd, K=8, dtype=jnp.float32, mesh=jm)

    _, f1 = grf_domain_fft(trandom.PRNGKey(3), kolmogorov, 2e-3, 4e-4, EXT,
                           16, device="cpu")
    _, fs = grf_domain_fft(trandom.PRNGKey(3), kolmogorov, 2e-3, 4e-4, EXT,
                           16, mesh=tm, device="cpu")
    assert float((fs.gather() - f1).abs().max()) <= 1e-5
    ne = 1e25 * (1.0 + 0.5 * fs)
    ds = ScalarDomain(2 * EXT, 32, device="cpu").external_ne(ne)
    ds.phaseshift = True
    d1 = ScalarDomain(2 * EXT, 32, device="cpu").external_ne(ne.gather())
    d1.phaseshift = True
    sps = tz.build_segment_pack_device(ds, K=8, dtype=torch.float32,
                                       mesh=tm)
    sp1 = tz.build_segment_pack_device(d1, K=8, dtype=torch.float32)
    assert len({s.data_ptr() for s in sps.seg_planes.shards}) == 8
    assert torch.equal(sps.seg_planes.gather(), sp1.seg_planes)
    spq = tz.build_segment_pack_device(ds, K=8, dtype=torch.int8, dither=5,
                                       mesh=tm)
    spq1 = tz.build_segment_pack_device(d1, K=8, dtype=torch.int8, dither=5)
    assert torch.equal(spq.seg_planes.gather(), spq1.seg_planes)
    assert torch.equal(spq.scales, spq1.scales)

    s0 = init_beam(jax.random.PRNGKey(4), 128, 7e-3, 1e-3, EXT, "circular")
    s = np.asarray(s0)
    u = np.stack([s[0], s[1], s[3], s[4], s[5], s[6], s[7], s[8]], axis=1)
    n_seg = sps.seg_planes.shape[0]
    jtr = jgst(jm, jlayout_of(jd), jsp, integrator="rk2s2")
    jout = np.asarray(jtr(jnp.asarray(u), jsp.seg_planes.reshape(
        n_seg, 32, 32, -1), jsp.origin_ab, jsp.inv_spacing_ab,
        jnp.float32(jsp.dp)))
    tr = make_gridsharded_segment_tracer(tm, layout_of(ds), sps,
                                         integrator="rk2s2")
    out = tr(torch.tensor(u), sps.seg_planes, sps.origin_ab,
             sps.inv_spacing_ab, sps.dp)
    ref = tz.trace_zscan_segments(
        torch.tensor(u), sp1.seg_planes, sp1.origin_ab, sp1.inv_spacing_ab,
        sp1.dp, shape_ab=sp1.shape_ab, layout=layout_of(d1), K=sp1.K,
        n_seg=n_seg, integrator="rk2s2")
    assert torch.equal(out, ref)
    scale = np.maximum(np.abs(jout).max(0), 1e-30)
    assert (np.abs(out.numpy() - jout).max(0) / scale).max() <= 2e-6

    s0 = init_beam(jax.random.PRNGKey(4), 4000, 7e-3, 1e-3, EXT, "circular")
    kw = dict(solver="zscan_seg", seg_K=8, integrator="rk2s2",
              seg_weights="slab", bins=BINS)
    Hj = np.asarray(jpipe.run(jd, s0, mesh=jm, grid_axis="grid", **kw))
    H = tpipe.run(ds, torch.tensor(np.asarray(s0)), mesh=tm,
                  grid_axis="grid", **kw)
    H1 = tpipe.run(d1, torch.tensor(np.asarray(s0)), **kw)
    assert torch.equal(H, H1)
    assert H.sum().item() == Hj.sum() > 0
    assert np.abs(H.numpy() - Hj).sum() <= 0.002 * Hj.sum()
