"""The port's mesh modes (``synthpy_tpu_torch.parallel``) against the JAX
package's on the same inputs: JAX on the conftest's 8 fake CPU devices,
the port on a mesh of ``["cpu"] * G`` (the single-controller mesh repeats
a device, as one card runs every mode).

Tolerances, from the JAX tests (``tests/test_parallel.py``) and ROADMAP C:
* the grid-sharded and depth-pipelined marches are bit-equal to the port's
  single-device march (JAX's are to its own), and within C.6's 2e-6 of a
  column of JAX's at these 8-slab segments;
* the grid-sharded time tracer is bit-equal to JAX's on the lens (the same
  contracted multiply-adds, found by emulation), and within JAX's own
  bound, 1e-4 of each column's scale, of the unsharded tracer and of JAX
  on a field with every channel;
* images: counts exact against the port's single-device run, and against
  JAX equal sums with |H - H_jax|.sum() <= 0.002 H_jax.sum() (the packs
  differ in the last place, C.8); coherent images within 1e-4 of their
  peak of the single-device run (C.7: summation order) and 3% relative L1
  of JAX's (tests/test_torch_coherent.py);
* the sharded pack build and ``sharded_histogram``'s counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

from synthpy_tpu import pipeline as jpipe
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields import build_pack as jbuild_pack
from synthpy_tpu.fields import layout_of as jlayout_of
from synthpy_tpu.parallel import mesh as jmesh
from synthpy_tpu.parallel.pipeline_pp import (
    make_pipelined_segment_tracer as jmake_pp)
from synthpy_tpu.tracer import init_beam, trace_rk4 as jtrace_rk4
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu_torch import convert
from synthpy_tpu_torch import pipeline as tpipe
from synthpy_tpu_torch.fields import layout_of
from synthpy_tpu_torch.fields.domain import build_pack
from synthpy_tpu_torch.kernels import march, march_sharded, sharded_rhs
from synthpy_tpu_torch.parallel import (Mesh, grid_ray_mesh,
                                        make_gridsharded_segment_tracer,
                                        make_gridsharded_tracer,
                                        make_pipelined_segment_tracer,
                                        mesh_from_spec, ppermute, psum,
                                        ray_mesh, replicate, shard_rays,
                                        sharded_histogram)
from synthpy_tpu_torch.parallel.mesh import Sharded, shard
from synthpy_tpu_torch.tracer import zscan as tz
from synthpy_tpu_torch.tracer.propagator import trace_rk4

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
CPU8 = ["cpu"] * 8
BINS = (48, 36)


def _jmesh(shape, names):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, devices=jax.devices()[:n],
                         axis_types=(AxisType.Auto,) * len(shape))


def _u(s0):
    s = np.asarray(s0)
    return np.stack([s[0], s[1], s[3], s[4], s[5], s[6], s[7], s[8]],
                    axis=1)


def _col_close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = np.maximum(np.abs(want).max(0), 1e-30)
    assert (np.abs(got - want).max(0) / scale).max() <= tol


def _close_images(Ht, Hj, frac=0.002):
    Ht = Ht.numpy() if isinstance(Ht, torch.Tensor) else Ht
    Hj = np.asarray(Hj)
    assert Ht.shape == Hj.shape
    assert Ht.sum() == Hj.sum() > 0
    assert np.abs(Ht - Hj).sum() <= frac * Hj.sum()


def _close_coherent(Hm, Hs, Hj):
    """A coherent image against the single-device run (C.7) and JAX's."""
    Hm, Hs, Hj = Hm.numpy(), Hs.numpy(), np.asarray(Hj)
    np.testing.assert_allclose(Hm, Hs, rtol=0, atol=1e-4 * np.abs(Hs).max())
    assert np.abs(Hm - Hj).sum() <= 0.03 * np.abs(Hj).sum()


# ---------------------------------------------------------------------------
# The mesh, its values and collectives
# ---------------------------------------------------------------------------

def test_mesh_repeats_devices_and_splits_values():
    m = Mesh((4, 2), ("grid", "rays"), devices=CPU8)
    assert m.shape == {"grid": 4, "rays": 2} and m.size == 8
    assert m.placement() == ["cpu"] * 8
    assert m.groups("grid") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert m.groups("rays") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert [m.index(p, "rays") for p in range(8)] == [0, 1] * 4
    x = torch.arange(7 * 3, dtype=torch.float32).reshape(7, 3)
    sh = shard_rays(x, m)          # truncated to 6 rows, 3 a shard
    assert isinstance(sh, Sharded) and sh.shape == (6, 3)
    assert torch.equal(sh.shards[1], x[3:6]) and torch.equal(
        sh.shards[6], x[0:3])
    assert torch.equal(sh.gather(), x[:6])
    # blocks on the shard's own device are views, not copies
    assert sh.shards[0].data_ptr() == x.data_ptr()
    rep = replicate(x, m)
    assert all(torch.equal(s, x) for s in rep.shards)
    assert torch.equal(rep.gather(), x)
    with pytest.raises(ValueError, match="divide"):
        shard(x, m, ("grid",))
    with pytest.raises(ValueError, match="wants 8 devices"):
        Mesh((8,), ("rays",), devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        # the constructors take the visible cards unless given devices
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ray_mesh()
    assert ray_mesh(devices=CPU8, n_devices=4).shape == {"rays": 4}
    assert grid_ray_mesh(2, devices=CPU8).shape == {"grid": 2, "rays": 4}


def test_psum_in_shard_order_and_ppermute():
    m = Mesh((4, 2), ("grid", "rays"), devices=CPU8)
    xs = [torch.tensor([float(p)]) for p in range(8)]
    out = psum(xs, m, "grid")
    assert [float(o) for o in out] == [12.0, 16.0] * 4
    # one device: the line's shards share one sum
    assert out[0] is out[2]
    # float32 adds in shard order 0..G-1, as JAX's fake devices add them
    vals = [torch.tensor([1e8], dtype=torch.float32),
            torch.tensor([1.0], dtype=torch.float32),
            torch.tensor([-1e8], dtype=torch.float32),
            torch.tensor([1.0], dtype=torch.float32)]
    m4 = Mesh((4,), ("grid",), devices=CPU8[:4])
    assert float(psum(vals, m4, "grid")[0]) == 1.0
    got = ppermute(xs[:4], m4, "grid", [(0, 1), (1, 2)])
    assert [float(g) for g in got] == [0.0, 0.0, 1.0, 0.0]


def test_mesh_from_spec_parses_and_refuses():
    m, g = mesh_from_spec("grid=4,rays=2", devices=CPU8)
    assert m.shape == {"grid": 4, "rays": 2} and g == "grid"
    m, g = mesh_from_spec("seg=8", pp_axis="seg", devices=CPU8)
    assert m.shape == {"seg": 8} and g is None
    for spec, kw, msg in (("rays8", {}, "bad mesh spec"),
                          ("rays=x", {}, "bad mesh spec"),
                          ("rays=2", {"grid_axis": "grid"}, "grid axis"),
                          ("rays=2", {"pp_axis": "seg"}, "pp axis"),
                          ("seg=2", {}, "needs a 'rays' axis"),
                          ("rays=16", {}, "wants 16 devices")):
        with pytest.raises(ValueError, match=msg):
            mesh_from_spec(spec, devices=CPU8, **kw)
        # the JAX package refuses the same specs
        with pytest.raises(ValueError, match=msg.replace("16 devices",
                                                         "16")):
            jmesh.mesh_from_spec(spec, **kw)


# ---------------------------------------------------------------------------
# Ray-sharded traces and the sharded histogram
# ---------------------------------------------------------------------------

def test_ray_sharded_time_and_segment_traces_match_single_device():
    jd = JDomain(2 * EXT, 33).test_lens(ne_0=5e24, LR=1.5e-3)
    td = convert.domain(jd, "cpu")
    s0 = np.asarray(init_beam(jax.random.PRNGKey(0), 256, 1.5e-3, 0.0,
                              EXT, "circular"))
    m = ray_mesh(devices=CPU8)
    # the time tracer, a shard at a time on the replicated grid
    jp, tp = jbuild_pack(jd), build_pack(td)
    n_steps = 64
    dt = float(np.float32(np.sqrt(8.0) * EXT / 2.99792458e8 / n_steps))
    rows = torch.tensor(s0.T.copy())
    ref = trace_rk4(rows, tp.channels, tp.origin, tp.inv_spacing, dt,
                    layout=layout_of(td), n_steps=n_steps)
    sh, ch = shard_rays(rows, m), replicate(tp.channels, m)
    out = Sharded(m, sh.spec, [trace_rk4(
        s, c, tp.origin, tp.inv_spacing, dt, layout=layout_of(td),
        n_steps=n_steps) for s, c in zip(sh.shards, ch.shards)],
        sh.shape).gather()
    assert torch.equal(out, ref)
    jref = np.asarray(jtrace_rk4(
        jnp.asarray(s0.T), jp.channels, jp.origin, jp.inv_spacing,
        jnp.float32(dt), layout=jlayout_of(jd), n_steps=n_steps))
    _col_close(out, jref, 1e-6)
    # the segmented march
    jsp = jz.make_segment_pack(jz.make_zscan_pack(jp, jlayout_of(jd)), K=8)
    sp = convert.segment_pack(jsp, "cpu")
    u = torch.tensor(_u(s0))
    kw = dict(shape_ab=sp.shape_ab, layout=layout_of(td), K=sp.K,
              n_seg=sp.seg_planes.shape[0])
    ref = tz.trace_zscan_segments(u, sp.seg_planes, sp.origin_ab,
                                  sp.inv_spacing_ab, sp.dp, **kw)
    sh = shard_rays(u, m)
    out = Sharded(m, sh.spec, [tz.trace_zscan_segments(
        x, sp.seg_planes, sp.origin_ab, sp.inv_spacing_ab, sp.dp, **kw)
        for x in sh.shards], sh.shape).gather()
    assert torch.equal(out, ref)
    jref = np.asarray(jz.trace_zscan_segments(
        jnp.asarray(_u(s0)), jsp.seg_planes, jsp.origin_ab,
        jsp.inv_spacing_ab, jnp.float32(jsp.dp), **dict(
            kw, layout=jlayout_of(jd))))
    _col_close(out, jref, 2e-6)


def test_sharded_histogram_counts_exact():
    rng = np.random.default_rng(0)
    N = 8000
    x = rng.uniform(-9, 9, N).astype(np.float32)
    y = rng.uniform(-6.75, 6.75, N).astype(np.float32)
    w = np.ones(N, np.float32)
    rng_ = ((-9.0, 9.0), (-6.75, 6.75))
    Href, _, _ = np.histogram2d(x, y, bins=[64, 48],
                                range=[[-9, 9], [-6.75, 6.75]])
    for m in (ray_mesh(devices=CPU8),
              Mesh((2, 4), ("grid", "rays"), devices=CPU8)):
        hist = sharded_histogram(m, (64, 48), rng_)
        H = hist(torch.tensor(x), torch.tensor(y), torch.tensor(w))
        np.testing.assert_array_equal(H.numpy(), Href.T)
    Hj = jmesh.sharded_histogram(jmesh.ray_mesh(), (64, 48), rng_)(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    np.testing.assert_array_equal(H.numpy(), np.asarray(Hj))


# ---------------------------------------------------------------------------
# The grid-sharded time tracer (K18)
# ---------------------------------------------------------------------------

def test_gridsharded_time_tracer_matches_jax_and_unsharded():
    jd = JDomain(2 * EXT, 32).test_lens(ne_0=5e24, LR=1.5e-3)
    jd.phaseshift = True
    td = convert.domain(jd, "cpu")
    jp, tp = jbuild_pack(jd), build_pack(td)
    s0 = np.asarray(init_beam(jax.random.PRNGKey(1), 64, 2.0e-3, 1e-3, EXT,
                              "circular"))
    n_steps = 48
    dt = np.float32(np.sqrt(8.0) * EXT / 2.99792458e8 / n_steps)
    jtr = jmesh.make_gridsharded_tracer(
        jmesh.grid_ray_mesh(n_grid=4, n_rays=2), jlayout_of(jd), n_steps,
        nx_global=jd.dims[0])
    jout = np.asarray(jtr(jnp.asarray(s0.T), jp.channels, jp.origin,
                          jp.inv_spacing, jnp.float32(dt)))
    rows = torch.tensor(s0.T.copy())
    tr = make_gridsharded_tracer(grid_ray_mesh(4, 2, devices=CPU8),
                                 layout_of(td), n_steps,
                                 nx_global=td.dims[0])
    out = tr(rows, tp.channels, tp.origin, tp.inv_spacing, float(dt))
    np.testing.assert_array_equal(out.numpy(), jout)
    ref = trace_rk4(rows, tp.channels, tp.origin, tp.inv_spacing,
                    float(dt), layout=layout_of(td), n_steps=n_steps)
    _col_close(out, ref, 1e-4)
    # a sharded bundle comes back sharded, the same rows
    m = grid_ray_mesh(4, 2, devices=CPU8)
    tr = make_gridsharded_tracer(m, layout_of(td), n_steps,
                                 nx_global=td.dims[0])
    res = tr(shard_rays(rows, m), shard(tp.channels, m, ("grid",)),
             tp.origin, tp.inv_spacing, float(dt))
    assert isinstance(res, Sharded) and torch.equal(res.gather(), out)


def test_gridsharded_time_tracer_every_channel():
    """inv_brems, the phase and the Faraday channels (C = 8) on an 8-way
    grid: within JAX's bound of JAX's sharded tracer."""
    jd = JDomain(2 * EXT, 16).test_lens(ne_0=1e25, LR=2e-3)
    rng = np.random.default_rng(3)
    jd.external_Te(50.0 + 10.0 * rng.random(jd.dims))
    jd.external_Z(2.0 * np.ones(jd.dims))
    jd.inv_brems = jd.phaseshift = True
    jd.test_B(Bmax=10.0)
    td = convert.domain(jd, "cpu")
    jp, tp = jbuild_pack(jd), build_pack(td)
    assert layout_of(td).n_channels == 8
    s0 = np.asarray(init_beam(jax.random.PRNGKey(2), 64, 3e-3, 1e-3, EXT,
                              "circular"))
    n_steps = 24
    dt = np.float32(np.sqrt(8.0) * EXT / 2.99792458e8 / n_steps)
    jtr = jmesh.make_gridsharded_tracer(
        jmesh.grid_ray_mesh(n_grid=8, n_rays=1), jlayout_of(jd), n_steps,
        nx_global=jd.dims[0])
    jout = np.asarray(jtr(jnp.asarray(s0.T), jp.channels, jp.origin,
                          jp.inv_spacing, jnp.float32(dt)))
    tr = make_gridsharded_tracer(Mesh((8,), ("grid",), devices=CPU8),
                                 layout_of(td), n_steps,
                                 nx_global=td.dims[0])
    out = tr(torch.tensor(s0.T.copy()), tp.channels, tp.origin,
             tp.inv_spacing, float(dt))
    _col_close(out, jout, 1e-4)


def test_k18_plain_versions_gather_the_owned_queries():
    jd = JDomain(2 * EXT, 16).test_lens(ne_0=5e24, LR=1.5e-3)
    td = convert.domain(jd, "cpu")
    tp = build_pack(td)
    rng = np.random.default_rng(4)
    t = torch.tensor(rng.uniform(-1.2 * EXT, 1.2 * EXT, (512, 9)),
                     dtype=torch.float32)
    G, nloc = 4, 4
    total = torch.zeros((512, 3))
    for g in range(G):
        halo = tp.channels[((g + 1) % G) * nloc]
        v = sharded_rhs.gather_owned_plain(
            t, tp.channels[g * nloc:(g + 1) * nloc], halo,
            origin=tp.origin, inv_spacing=tp.inv_spacing, lo=g * nloc,
            nx_global=16, last=g == G - 1)
        assert torch.all((v == 0) | (total == 0))   # one owner a query
        total = total + v
    from synthpy_tpu_torch.ops.interp import trilinear
    full = trilinear(tp.channels, t[:, :3], tp.origin, tp.inv_spacing,
                     contract=True)
    # as in JAX, the last shard also owns 15 < tx < 16, outside the grid,
    # and reads the cyclic halo there (ROADMAP C.9); inside, the shards'
    # moved origins change the values by rounding only
    tx = (t[:, 0] - float(tp.origin[0])) * float(tp.inv_spacing[0])
    inside = tx <= 15
    assert (~inside).any() and total[~inside].abs().max() > 0
    _col_close(total[inside], full[inside], 1e-5)


def _x_at(origin, inv_spacing, tx):
    """A float32 x whose global x-index (x - origin_x) * inv_x is exactly
    ``tx`` (a value float32 holds)."""
    o, iv = np.float32(origin[0]), np.float32(inv_spacing[0])
    x = np.float32(o + np.float32(tx) / iv)
    for _ in range(64):
        got = np.float32(np.float32(x - o) * iv)
        if got == np.float32(tx):
            return x
        x = np.nextafter(x, np.float32(np.inf if got < tx else -np.inf),
                         dtype=np.float32)
    raise AssertionError(f"no float32 x has x-index {tx}")


# x-indices on a 16-row grid: the last shard's closed edge (15), the cyclic
# halo beyond it (C.9), no owner on either side, shard boundaries
EDGE_TX = (15.0, 15.5, 15.75, -0.5, 16.5, 4.0, 8.0, 12.0)


def _edge_rows(origin, inv_spacing):
    """Rays at the x-indices of ``EDGE_TX``, moving along z with small
    transverse velocities."""
    rows = np.zeros((len(EDGE_TX), 9), np.float32)
    rows[:, 1], rows[:, 2] = 0.3e-3, -2e-3
    rows[:, 3], rows[:, 4], rows[:, 5] = 1.3e5, -2.1e5, 2.99792458e8
    rows[:, 6] = 1.0
    for r, tx in enumerate(EDGE_TX):
        rows[r, 0] = _x_at(origin, inv_spacing, tx)
    return rows


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return np.ascontiguousarray(x).view(np.int32)


def _lens16():
    jd = JDomain(2 * EXT, 16).test_lens(ne_0=5e24, LR=1.5e-3)
    td = convert.domain(jd, "cpu")
    return jd, td, jbuild_pack(jd), build_pack(td)


def _traces(G, jd, td, jch, tch, rows, n_steps, dt):
    """JAX's grid-sharded tracer on a G x 1 grid x rays mesh and the port's
    on ``["cpu"] * G`` (one device holds the line: each launch sums its G
    shards itself), on the same rows."""
    jp, tp = jbuild_pack(jd), build_pack(td)
    jtr = jmesh.make_gridsharded_tracer(
        jmesh.grid_ray_mesh(n_grid=G, n_rays=1), jlayout_of(jd), n_steps,
        nx_global=16)
    jout = np.asarray(jtr(jnp.asarray(rows), jch, jp.origin,
                          jp.inv_spacing, jnp.float32(dt)))
    tr = make_gridsharded_tracer(Mesh((G,), ("grid",), devices=["cpu"] * G),
                                 layout_of(td), n_steps, nx_global=16)
    out = tr(torch.tensor(rows), tch, tp.origin, tp.inv_spacing, float(dt))
    return out, jout


@pytest.mark.parametrize("G", [1, 2, 4])
def test_fused_stage_tracer_bit_equal_to_jax_by_shards(G):
    """The port's grid-sharded tracer (one fused launch a stage: the
    update, then the gather of every shard the device holds, added in shard
    order) bit for bit equal to JAX's on 1, 2 and 4 shards, with rays at
    the last shard's closed edge, in the cyclic halo beyond it, owned by no
    shard and on shard boundaries."""
    jd, td, jp, tp = _lens16()
    s0 = np.asarray(init_beam(jax.random.PRNGKey(1), 64, 2.0e-3, 1e-3, EXT,
                              "circular")).T
    rows = np.concatenate([s0, _edge_rows(tp.origin, tp.inv_spacing)])
    tx = (rows[:, 0] - np.float32(tp.origin[0])) * np.float32(
        tp.inv_spacing[0])
    assert {15.0, 15.5, -0.5, 16.5} <= set(tx.tolist())
    n_steps = 24
    dt = np.float32(np.sqrt(8.0) * EXT / 2.99792458e8 / 48)
    out, jout = _traces(G, jd, td, jp.channels, tp.channels, rows, n_steps,
                        dt)
    np.testing.assert_array_equal(_bits(out), _bits(jout))
    assert not torch.equal(out, torch.tensor(rows))


@pytest.mark.parametrize("G", [1, 4])
def test_fused_stage_tracer_bit_equal_to_jax_where_dt_over_6_rounds(G):
    """At a dt whose dt / 6 and dt * f32(1/6) differ in float32 (XLA folds
    the step's division into the multiply), the grid-sharded tracer equals
    JAX's bit for bit, on beam rays and on rays whose transverse velocity
    starts at 0."""
    jd, td, jp, tp = _lens16()
    s0 = np.asarray(init_beam(jax.random.PRNGKey(1), 64, 2.0e-3, 1e-3, EXT,
                              "circular")).T
    z = s0.copy()
    z[:, 3:5] = 0.0
    rows = np.concatenate([s0, z])
    dt = np.float32(jnp.asarray(jnp.sqrt(8.0) * EXT / 2.99792458e8 / 40,
                                jnp.float32))
    assert dt / np.float32(6.0) != dt * np.float32(1.0 / 6.0)
    out, jout = _traces(G, jd, td, jp.channels, tp.channels, rows, 24, dt)
    np.testing.assert_array_equal(_bits(out), _bits(jout))
    assert np.abs(jout[64:, 3:5]).min() > 0


@pytest.mark.parametrize("G", [1, 2, 4])
def test_fused_stage_tracer_with_inv_brems_against_jax(G):
    """With inverse bremsstrahlung on, the stage's slope sum fuses k4's
    amplitude product into its last add, as XLA's compiled tracer does
    (``time_march.rk4_last_add``): on 1, 2 and 4 shards every column is
    bit for bit JAX's. Both tracers read one channel table (JAX's): the
    two packs' kappa channels part by a few ulp at some nodes (ROADMAP
    C.8), which the tracers would carry into the amplitude column."""
    jd = JDomain(2 * EXT, 16, inv_brems=True).test_lens(ne_0=8e24,
                                                        LR=1.8e-3)
    rng = np.random.default_rng(1)
    jd.external_Te(50.0 + 10.0 * rng.random(jd.dims))
    jd.external_Z(2.0 * np.ones(jd.dims))
    td = convert.domain(jd, "cpu")
    jp = jbuild_pack(jd)
    tch = torch.tensor(np.asarray(jp.channels))
    assert not torch.equal(tch, build_pack(td).channels)
    rows = np.asarray(init_beam(jax.random.PRNGKey(1), 256, 2.0e-3, 1e-3,
                                EXT, "circular")).T.copy()
    dt = np.float32(jnp.asarray(jnp.sqrt(8.0) * EXT / 2.99792458e8 / 40,
                                jnp.float32))
    out, jout = _traces(G, jd, td, jp.channels, tch, rows, 24, dt)
    assert np.abs(jout[:, 6] - rows[:, 6]).max() > 0
    np.testing.assert_array_equal(_bits(out), _bits(jout))


@pytest.mark.parametrize("G", [1, 2, 4])
def test_fused_stage_tracer_with_inv_brems_on_the_ports_pack(G):
    """End to end with inverse bremsstrahlung on: the port's pack
    (``build_pack``) into the port's tracer against JAX's pack into JAX's.
    On 2 and 4 shards every column is bit for bit JAX's; on one shard the
    packs' kappa channels, a few ulp apart at some nodes (ROADMAP C.8),
    may move the amplitude column by one ulp, every other column
    bit-equal."""
    jd = JDomain(2 * EXT, 16, inv_brems=True).test_lens(ne_0=8e24,
                                                        LR=1.8e-3)
    rng = np.random.default_rng(1)
    jd.external_Te(50.0 + 10.0 * rng.random(jd.dims))
    jd.external_Z(2.0 * np.ones(jd.dims))
    td = convert.domain(jd, "cpu")
    jp, tp = jbuild_pack(jd), build_pack(td)
    rows = np.asarray(init_beam(jax.random.PRNGKey(1), 256, 2.0e-3, 1e-3,
                                EXT, "circular")).T.copy()
    dt = np.float32(jnp.asarray(jnp.sqrt(8.0) * EXT / 2.99792458e8 / 40,
                                jnp.float32))
    out, jout = _traces(G, jd, td, jp.channels, tp.channels, rows, 24, dt)
    ulps = (_bits(out).astype(np.int64) - _bits(jout)).reshape(
        jout.shape)
    assert np.abs(jout[:, 6] - rows[:, 6]).max() > 0
    np.testing.assert_array_equal(np.delete(ulps, 6, axis=1), 0)
    assert np.abs(ulps[:, 6]).max() <= (1 if G == 1 else 0)


@pytest.mark.parametrize("G", [1, 2, 4])
def test_fused_stage_carries_the_psums_signed_zero(G):
    """An owner's value of -0.0 (every channel -0.0): the psum over G > 1
    shards adds +0.0 and turns it into +0.0, one shard leaves it; rays
    with -0.0 velocities keep the sign in their result where no zero was
    added. Bit for bit equal to JAX's tracer."""
    jd, td, jp, tp = _lens16()
    rows = _edge_rows(tp.origin, tp.inv_spacing)
    rows[:, 3] = rows[:, 4] = rows[:, 5] = rows[:, 7] = -0.0
    jch = jnp.full(jp.channels.shape, -0.0, jnp.float32)
    tch = torch.full(tuple(tp.channels.shape), -0.0)
    out, jout = _traces(G, jd, td, jch, tch, rows, 2, np.float32(1e-14))
    np.testing.assert_array_equal(_bits(out), _bits(jout))
    owned = np.array([0 <= tx <= 15.75 for tx in EDGE_TX])
    neg = np.signbit(out[:, 3].numpy())
    assert (neg == (owned & (G == 1))).all()


@pytest.mark.parametrize("devices", [["cpu"], ["cpu"] * 2, ["cpu"] * 4,
                                     ["cpu", "cpu", "cpu:0", "cpu:0"],
                                     ["cpu", "cpu:0", "cpu:1", "cpu:2"]])
@pytest.mark.parametrize("neg_zero", [False, True])
def test_stage_gather_plain_is_the_parents_route(devices, neg_zero):
    """One stage through ``sharded_rhs.Trace`` (each device sums its shards
    in shard order, the tracer's ``line_sum`` adds the devices' partials)
    equals the parent's route bit for bit: each shard's
    ``gather_owned_plain``, ``psum`` over the grid axis in shard order,
    ``rk4_stage_plain``. A line on several devices ("cpu", "cpu:0", ...
    are distinct torch devices) and owner values of -0.0 included."""
    from synthpy_tpu_torch.kernels.time_march import Steps
    from synthpy_tpu_torch.parallel.mesh import line_sum

    jd, td, jp, tp = _lens16()
    G = len(devices)
    nloc = 16 // G
    m = Mesh((G,), ("grid",), devices=devices)
    lay = layout_of(td)
    ch = (torch.full(tuple(tp.channels.shape), -0.0) if neg_zero
          else tp.channels)
    rng = np.random.default_rng(7)
    rows = np.concatenate([rng.uniform(-1.2 * EXT, 1.2 * EXT, (256, 9)),
                           _edge_rows(tp.origin, tp.inv_spacing)]).astype(
        np.float32)
    rows[:, 3:6] *= 1e8
    t = torch.tensor(rows)
    kw = dict(origin=tp.origin, inv_spacing=tp.inv_spacing, nx_global=16)
    shards = [sharded_rhs.Shard(ch[g * nloc:(g + 1) * nloc],
                                ch[((g + 1) % G) * nloc], g * nloc,
                                g == G - 1) for g in range(G)]
    # the parent's route: G gathers, the psum, the update
    vals = psum([sharded_rhs.gather_owned_plain(t, sh.values, sh.halo,
                                                lo=sh.lo, last=sh.last, **kw)
                 for sh in shards], m, "grid")[0]
    steps = Steps.of(1e-13)
    want = [t.clone(), t.clone(), torch.full_like(t, 0.5)]
    sharded_rhs.rk4_stage_plain(*want, vals, 1, steps, lay, -1.0)
    # the fused route: one Trace a device, its partials added by line_sum
    by_dev = {}
    for g, d in enumerate(m.flat_devices):
        by_dev.setdefault(d, []).append(shards[g])
    traces = {d: sharded_rhs.Trace(t.T.contiguous(), sh, steps=steps,
                                   layout=lay, **kw)
              for d, sh in by_dev.items()}
    for tr in traces.values():
        tr.acc.fill_(0.5)
        tr.stage(None, None, True)
    devs = list(traces)
    summed = (traces[devs[0]].vals if len(devs) == 1 else
              line_sum([traces[d].vals for d in devs], devs, False)[devs[0]])
    np.testing.assert_array_equal(_bits(summed.T), _bits(vals))
    for tr in traces.values():
        tr.stage(summed, 1, True)
        for got, w in zip((tr.s, tr.t, tr.acc), want):
            np.testing.assert_array_equal(_bits(got.T), _bits(w))
    if neg_zero:
        owned = np.array([0 <= tx <= 15.75 for tx in EDGE_TX])
        neg = np.signbit(vals[-len(EDGE_TX):].numpy()).all(1)
        assert (neg == (owned & (G == 1))).all()


# ---------------------------------------------------------------------------
# The grid-sharded segmented march (K17)
# ---------------------------------------------------------------------------

TIERS = {"f32": ("rk4", "stage"), "bf16": ("rk2", "slab"),
         "int8": ("rk2s2", "slab"), "int4": ("rk2s2", "stage")}


@pytest.fixture(scope="module")
def grid_scene():
    jd = JDomain(2 * EXT, 24).test_lens(ne_0=5e24, LR=1.5e-3)
    jd.phaseshift = True
    # a beam wider than the grid: off-grid rays need an owner too
    s0 = np.asarray(init_beam(jax.random.PRNGKey(21), 256, 7e-3, 1e-3, EXT,
                              "circular"))
    return jd, convert.domain(jd, "cpu"), s0


@pytest.mark.parametrize("tier", list(TIERS))
def test_gridsharded_segment_march_every_tier(grid_scene, tier):
    jd, td, s0 = grid_scene
    integrator, weights = TIERS[tier]
    dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8,
             "int4": "int4"}[tier]
    jsp = jz.build_segment_pack_device(jd, K=8, dtype=dtype)
    sp = convert.segment_pack(jsp, "cpu")
    lay = layout_of(td)
    n_seg = sp.seg_planes.shape[0]
    na, nb = sp.shape_ab
    u = torch.tensor(_u(s0))
    ref = tz.trace_zscan_segments(
        u, sp.seg_planes, sp.origin_ab, sp.inv_spacing_ab, sp.dp,
        shape_ab=sp.shape_ab, layout=lay, K=sp.K, n_seg=n_seg,
        integrator=integrator, weights=weights, seg_scales=sp.scales,
        qbits=sp.qbits)
    tables = sp.seg_planes.reshape(n_seg, na, nb, -1)
    for shape, names in (((4,), ("grid",)), ((4, 2), ("grid", "rays"))):
        m = Mesh(shape, names, devices=CPU8)
        r_ax = "rays" if "rays" in names else None
        tr = make_gridsharded_segment_tracer(
            m, lay, sp, ray_axis=r_ax, integrator=integrator,
            weights=weights)
        out = tr(u, tables, sp.origin_ab, sp.inv_spacing_ab, sp.dp)
        np.testing.assert_array_equal(out.numpy(), ref.numpy(),
                                      err_msg=f"{tier} {shape}")
    jm = _jmesh((4, 2), ("grid", "rays"))
    jtr = jmesh.make_gridsharded_segment_tracer(
        jm, jlayout_of(jd), jsp, ray_axis="rays", integrator=integrator,
        weights=weights)
    ju = jax.device_put(jnp.asarray(_u(s0)), NamedSharding(jm, P("rays",
                                                               None)))
    jout = np.asarray(jtr(ju, jsp.seg_planes.reshape(n_seg, na, nb, -1),
                          jsp.origin_ab, jsp.inv_spacing_ab,
                          jnp.float32(jsp.dp)))
    _col_close(out, jout, 2e-6)


def test_gridsharded_segment_march_padded_rows_and_refusals(grid_scene):
    """na = 33 padded with zero a-rows to 36 over a 4-way grid: no ray owns
    or reads a pad row, so the march equals the single-device one."""
    jd33 = JDomain(2 * EXT, 33).test_lens(ne_0=5e24, LR=1.5e-3)
    td = convert.domain(jd33, "cpu")
    sp = tz.build_segment_pack_device(td, K=8, dtype=torch.float32)
    lay = layout_of(td)
    n_seg = sp.seg_planes.shape[0]
    u = torch.tensor(_u(grid_scene[2]))
    ref = tz.trace_zscan_segments(
        u, sp.seg_planes, sp.origin_ab, sp.inv_spacing_ab, sp.dp,
        shape_ab=sp.shape_ab, layout=lay, K=sp.K, n_seg=n_seg)
    m = Mesh((4,), ("grid",), devices=CPU8[:4])
    tables = torch.nn.functional.pad(
        sp.seg_planes.reshape(n_seg, 33, 33, -1), (0, 0, 0, 0, 0, 3))
    tr = make_gridsharded_segment_tracer(m, lay, sp, table_na=36)
    out = tr(u, tables, sp.origin_ab, sp.inv_spacing_ab, sp.dp)
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="must divide"):
        make_gridsharded_segment_tracer(m, lay, sp)
    with pytest.raises(NotImplementedError, match="A.4"):
        make_gridsharded_segment_tracer(m, lay, sp, table_na=36,
                                        substeps=2)
    pm = Mesh((2,), ("rays",), devices=CPU8[:2], process_axis="rays")
    with pytest.raises(NotImplementedError, match="ROADMAP A.17"):
        make_gridsharded_segment_tracer(pm, lay, sp, grid_axis="rays",
                                        table_na=34)


def test_k17_plain_version_is_k1_on_the_owned_rays(grid_scene):
    """One shard a call of a 4-shard line (24 a-rows, 6 a shard): each
    ray is owned once, its value K1's on the whole table, the rest zeros."""
    jd, td, s0 = grid_scene
    sp = tz.build_segment_pack_device(td, K=8, dtype=torch.bfloat16)
    lay = layout_of(td)
    na, nb = sp.shape_ab
    u = torch.tensor(_u(s0))
    kw = dict(shape_ab=sp.shape_ab, origin_ab=sp.origin_ab.tolist(),
              inv_ab=sp.inv_spacing_ab.tolist(), dp=sp.dp, layout=lay,
              K=sp.K, integrator="rk2", weights="slab")
    full = march.march(u, sp.seg_planes[:1], None, **kw)
    table = sp.seg_planes[0].reshape(na, nb, -1)
    seen = torch.zeros(u.shape[0], dtype=torch.bool)
    for lo in range(0, na, 6):
        out = march_sharded.march_shards(
            u, [march_sharded.Shard(table[lo:lo + 6], table[(lo + 6) % na],
                                    lo)], None, naloc=6, line_shards=4,
            **kw)
        own = march_sharded.owned(u, lo, 6, na, kw["origin_ab"][0],
                                  kw["inv_ab"][0])
        assert torch.equal(out[own], full[own])
        assert not out[~own].any()
        assert not (seen & own).any()
        seen |= own
    assert seen.all()
    assert torch.equal(march_sharded.owner(u, 6, na, kw["origin_ab"][0],
                                           kw["inv_ab"][0]).bincount(),
                       torch.stack([march_sharded.owned(
                           u, lo, 6, na, kw["origin_ab"][0],
                           kw["inv_ab"][0]).sum() for lo in (0, 6, 12, 18)]))


def test_k17_one_call_holds_every_shard_of_the_device(grid_scene):
    """``march_shards`` given 1, 2 or 4 shards of a 4-shard line marches
    the rays any of them owns, as the shards' calls one at a time do."""
    jd, td, s0 = grid_scene
    sp = tz.build_segment_pack_device(td, K=8, dtype=torch.float32)
    lay = layout_of(td)
    na, nb = sp.shape_ab
    u = torch.tensor(_u(s0))
    kw = dict(shape_ab=sp.shape_ab, origin_ab=sp.origin_ab.tolist(),
              inv_ab=sp.inv_spacing_ab.tolist(), dp=sp.dp, layout=lay,
              K=sp.K, integrator="rk4", weights="stage", naloc=6,
              line_shards=4)
    table = sp.seg_planes[0].reshape(na, nb, -1)
    shards = [march_sharded.Shard(table[lo:lo + 6], table[(lo + 6) % na],
                                  lo) for lo in (0, 6, 12, 18)]
    ones = [march_sharded.march_shards(u, [sh], None, **kw)
            for sh in shards]
    for group in ([0], [1, 2], [0, 1, 2, 3]):
        got = march_sharded.march_shards(u, [shards[g] for g in group],
                                         None, **kw)
        want = sum((ones[g] for g in group), torch.zeros_like(u))
        np.testing.assert_array_equal(_bits(got), _bits(want))


K17_CASES = [(t, i) for t in ("f32", "bf16", "int8")
             for i in ("rk2", "rk2s2", "rk4")] + [("int4", "rk2s2"),
                                                  ("int4", "rk2s4")]
K17_MESHES = {"cpu4": ((4,), ("grid",), ["cpu"] * 4),
              "cpu4_distinct": ((4,), ("grid",),
                                ["cpu", "cpu", "cpu:0", "cpu:0"]),
              "grid2_rays2": ((2, 2), ("grid", "rays"),
                              ["cpu", "cpu:0", "cpu:1", "cpu:2"])}
_K17_PACKS = {}


def _k17_pack(grid_scene, tier):
    """JAX's pack of the grid scene at K = 8 and the port's copy of it
    (one build a tier and worker)."""
    if tier not in _K17_PACKS:
        jd = grid_scene[0]
        dtype = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8,
                 "int4": "int4"}[tier]
        jsp = jz.build_segment_pack_device(jd, K=8, dtype=dtype)
        _K17_PACKS[tier] = (jsp, convert.segment_pack(jsp, "cpu"))
    return _K17_PACKS[tier]


@pytest.mark.parametrize("mesh_name", list(K17_MESHES))
@pytest.mark.parametrize("tier,integrator", K17_CASES)
def test_k17_segment_tracer_on_repeated_and_distinct_devices(
        grid_scene, tier, integrator, mesh_name):
    """The segment tracer (one K17 call a device and segment, the owned
    rows exchanged where a line spans several devices) on 4 repeated CPU
    devices, on a line over two distinct ones ("cpu" and "cpu:0" are
    distinct torch devices) and on a 2 x 2 grid x rays mesh of distinct
    devices: bit for bit the single-device march but for the psum's + 0.0
    (so equal as values), every tier and integrator, and within C.6's 2e-6
    of a column of JAX's tracer on the same pack (on the distinct line)."""
    jd, td, s0 = grid_scene
    jsp, sp = _k17_pack(grid_scene, tier)
    weights = "slab" if integrator != "rk4" else "stage"
    lay = layout_of(td)
    n_seg = sp.seg_planes.shape[0]
    na, nb = sp.shape_ab
    u = torch.tensor(_u(s0))
    ref = tz.trace_zscan_segments(
        u, sp.seg_planes, sp.origin_ab, sp.inv_spacing_ab, sp.dp,
        shape_ab=sp.shape_ab, layout=lay, K=sp.K, n_seg=n_seg,
        integrator=integrator, weights=weights, seg_scales=sp.scales,
        qbits=sp.qbits)
    shape, names, devices = K17_MESHES[mesh_name]
    m = Mesh(shape, names, devices=devices)
    tr = make_gridsharded_segment_tracer(
        m, lay, sp, ray_axis="rays" if "rays" in names else None,
        integrator=integrator, weights=weights)
    tables = sp.seg_planes.reshape(n_seg, na, nb, -1)
    out = tr(u, tables, sp.origin_ab, sp.inv_spacing_ab, sp.dp)
    np.testing.assert_array_equal(_bits(out), _bits(ref + 0.0))
    assert torch.equal(out, ref)
    if mesh_name != "cpu4_distinct":
        return
    jtr = jmesh.make_gridsharded_segment_tracer(
        _jmesh((4,), ("grid",)), jlayout_of(jd), jsp,
        integrator=integrator, weights=weights)
    jout = np.asarray(jtr(jnp.asarray(_u(s0)),
                          jsp.seg_planes.reshape(n_seg, na, nb, -1),
                          jsp.origin_ab, jsp.inv_spacing_ab,
                          jnp.float32(jsp.dp)))
    _col_close(out, jout, 2e-6)


@pytest.mark.parametrize("devices", [["cpu"], ["cpu"] * 2, ["cpu"] * 4,
                                     ["cpu", "cpu:0", "cpu:1", "cpu:2"]])
def test_k17_segment_tracer_carries_the_psums_signed_zero(devices):
    """On a table of -0.0 (every channel), rays with -0.0 transverse
    velocities keep them through the march where they are inside the grid
    (stage weights: outside, the channels are +0.0);
    the psum over G > 1 shards turns the owner's -0.0 into +0.0, one shard
    leaves it. The march is exact here, so the result is bit for bit
    JAX's, on repeated and on distinct devices."""
    G = len(devices)
    jd = JDomain(2 * EXT, 16).test_lens(ne_0=5e24, LR=1.5e-3)
    td = convert.domain(jd, "cpu")
    jsp = jz.build_segment_pack_device(jd, K=4, dtype=jnp.float32)
    jsp = jsp._replace(seg_planes=jnp.full(jsp.seg_planes.shape, -0.0,
                                           jnp.float32))
    sp = convert.segment_pack(jsp, "cpu")
    lay = layout_of(td)
    n_seg = sp.seg_planes.shape[0]
    na, nb = sp.shape_ab
    s0 = np.asarray(init_beam(jax.random.PRNGKey(3), 64, 7e-3, 1e-3, EXT,
                              "circular"))
    u = _u(s0)
    u[:, 2:4] = -0.0
    u[:, 6] = -0.0
    tr = make_gridsharded_segment_tracer(
        Mesh((G,), ("grid",), devices=devices), lay, sp, integrator="rk2",
        weights="stage")
    out = tr(torch.tensor(u), sp.seg_planes.reshape(n_seg, na, nb, -1),
             sp.origin_ab, sp.inv_spacing_ab, sp.dp)
    jtr = jmesh.make_gridsharded_segment_tracer(
        _jmesh((G,), ("grid",)), jlayout_of(jd), jsp, integrator="rk2",
        weights="stage")
    jout = np.asarray(jtr(jnp.asarray(u),
                          jsp.seg_planes.reshape(n_seg, na, nb, -1),
                          jsp.origin_ab, jsp.inv_spacing_ab,
                          jnp.float32(jsp.dp)))
    np.testing.assert_array_equal(_bits(out), _bits(jout))
    t = (u[:, :2] - sp.origin_ab.numpy()) * sp.inv_spacing_ab.numpy()
    inside = ((t >= 0) & (t <= [na - 1, nb - 1])).all(1)
    assert 0 < inside.sum() < len(u)
    neg = np.signbit(out[:, 2].numpy())
    assert (neg == (inside & (G == 1))).all()
    assert not np.signbit(out[:, 6].numpy()).any()


@pytest.mark.parametrize("devices", [["cpu", "cpu:0"],
                                     ["cpu", "cpu:0", "cpu:1", "cpu:2"],
                                     ["cpu", "cpu", "cpu:0", "cpu:0"]])
@pytest.mark.parametrize("neg_zero", [False, True])
def test_k17_exchange_equals_the_dense_psum(grid_scene, devices, neg_zero):
    """The owned-rows exchange of a line over distinct devices equals the
    dense psum it replaces (each shard's masked result, summed over the
    line in shard order) bit for bit, on fast rays whose corner cells
    cross shard boundaries within the segment (ownership stays frozen at
    its start), with -0.0 owner values where ``neg_zero``."""
    jd, td, s0 = grid_scene
    sp = tz.build_segment_pack_device(td, K=8, dtype=torch.float32)
    lay = layout_of(td)
    na, nb = sp.shape_ab
    G = len(devices)
    naloc = na // G
    u = torch.tensor(_u(s0))
    # slopes of +-1.2: a ray crosses ~9 a-rows in the segment
    u[::2, 2] = 1.2 * u[::2, 4] * torch.sign(u[::2, 2])
    if neg_zero:
        u[1::2, 2:4] = -0.0
    table = sp.seg_planes[0].reshape(na, nb, -1)
    if neg_zero:
        table = torch.full_like(table, -0.0)
    o_ab, i_ab = sp.origin_ab.tolist(), sp.inv_spacing_ab.tolist()
    kw = dict(shape_ab=sp.shape_ab, origin_ab=o_ab, inv_ab=i_ab, dp=sp.dp,
              layout=lay, K=sp.K, integrator="rk2", weights="slab",
              naloc=naloc)
    shards = [march_sharded.Shard(table[g * naloc:(g + 1) * naloc],
                                  table[((g + 1) % G) * naloc], g * naloc)
              for g in range(G)]
    full = march.march(u, sp.seg_planes[:1] if not neg_zero
                       else table.reshape(1, na * nb, -1), None,
                       **{k: v for k, v in kw.items() if k != "naloc"})
    ia0 = march_sharded.owner(u, 1, na, o_ab[0], i_ab[0])
    ia1 = march_sharded.owner(full, 1, na, o_ab[0], i_ab[0])
    assert ((ia0 // naloc) != (ia1 // naloc)).sum() > 10
    # the parent's route: each shard's masked march, the psum in shard order
    m = Mesh((G,), ("grid",), devices=devices)
    parts = [march_sharded.march_shards(u.to(d), [sh], None, line_shards=1,
                                        **kw)
             for d, sh in zip(m.flat_devices, shards)]
    dense = psum(parts, m, "grid")
    # the tracer's route: one call a device, then the exchange
    devs = list(dict.fromkeys(m.flat_devices))
    held = {d: [g for g in range(G) if m.flat_devices[g] == d]
            for d in devs}
    outs = [march_sharded.march_shards(
        u.to(d), [shards[g] for g in held[d]], None, line_shards=G, **kw)
        for d in devs]
    march_sharded.exchange_rows(
        outs, [u.to(d) for d in devs],
        [devs.index(m.flat_devices[g]) for g in range(G)], naloc=naloc,
        na=na, origin_a=o_ab[0], inv_a=i_ab[0])
    for g, d in enumerate(m.flat_devices):
        np.testing.assert_array_equal(_bits(outs[devs.index(d)]),
                                      _bits(dense[g]))
    assert torch.equal(outs[0], full)
    if neg_zero:
        assert np.signbit(full[1::2, 2].numpy()).any()
        assert not np.signbit(outs[0][1::2, 2].numpy()).any()


# ---------------------------------------------------------------------------
# The depth-pipelined march
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pp_scene():
    jd = JDomain(2 * EXT, 33).test_lens(ne_0=5e24, LR=1.5e-3)
    jd.phaseshift = True
    td = convert.domain(jd, "cpu")
    s0 = np.asarray(init_beam(jax.random.PRNGKey(16), 512, 1.5e-3, 1e-3, EXT,
                              "circular"))
    return jd, td, s0


@pytest.mark.parametrize("integrator,n_chunks", [("rk4", 3), ("rk2", 2),
                                                 ("rk2s2", 8), ("rk4", 8)])
def test_pp_tracer_bit_identical_to_single_device(pp_scene, integrator,
                                                  n_chunks):
    jd, td, s0 = pp_scene
    lay = layout_of(td)
    sp = tz.make_segment_pack(tz.make_zscan_pack(build_pack(td), lay), K=8)
    n_seg = sp.seg_planes.shape[0]     # 4 segments
    N = 64 * n_chunks
    u = torch.tensor(_u(s0))[:N]
    ref = tz.trace_zscan_segments(
        u, sp.seg_planes, sp.origin_ab, sp.inv_spacing_ab, sp.dp,
        shape_ab=sp.shape_ab, layout=lay, K=sp.K, n_seg=n_seg,
        integrator=integrator)
    m = Mesh((4,), ("seg",), devices=CPU8[:4])
    tr = make_pipelined_segment_tracer(m, lay, sp, n_chunks,
                                       integrator=integrator)
    chunks = u.reshape(n_chunks, -1, 8)
    out = tr(chunks, sp.seg_planes, sp.origin_ab, sp.inv_spacing_ab,
             sp.dp)
    assert torch.equal(out.reshape(N, 8), ref)
    if n_chunks % 4 == 0:
        # sharded chunk storage in and out
        res = tr(shard(chunks, m, ("seg",)), sp.seg_planes, sp.origin_ab,
                 sp.inv_spacing_ab, sp.dp)
        assert isinstance(res, Sharded)
        assert torch.equal(res.gather().reshape(N, 8), ref)
    jsp = jz.make_segment_pack(jz.make_zscan_pack(jbuild_pack(jd),
                                                  jlayout_of(jd)), K=8)
    jtr = jmake_pp(_jmesh((4,), ("seg",)), jlayout_of(jd), jsp, n_chunks,
                   integrator=integrator)
    jout = np.asarray(jtr(jnp.asarray(chunks.numpy()), jsp.seg_planes,
                          jsp.origin_ab, jsp.inv_spacing_ab,
                          jnp.float32(jsp.dp))).reshape(N, 8)
    _col_close(out.reshape(N, 8), jout, 2e-6)


def test_pp_tracer_int8_and_skipped_pad_segments(pp_scene):
    jd, td, s0 = pp_scene
    lay = layout_of(td)
    sp = tz.build_segment_pack_device(td, K=6, dtype=torch.int8)
    n_seg = sp.seg_planes.shape[0]     # 6 segments, padded to 8
    u = torch.tensor(_u(s0))[:192]
    ref = tz.trace_zscan_segments(
        u, sp.seg_planes, sp.origin_ab, sp.inv_spacing_ab, sp.dp,
        shape_ab=sp.shape_ab, layout=lay, K=sp.K, n_seg=n_seg,
        integrator="rk2s2", seg_scales=sp.scales)
    F = torch.nn.functional
    planes = F.pad(sp.seg_planes, (0, 0, 0, 0, 0, 2))
    scales = F.pad(sp.scales, (0, 0, 0, 0, 0, 2), value=1.0)
    m = Mesh((4,), ("seg",), devices=CPU8[:4])
    tr = make_pipelined_segment_tracer(
        m, lay, sp._replace(seg_planes=planes, scales=scales), 3,
        integrator="rk2s2", n_seg_real=n_seg)
    out = tr(u.reshape(3, 64, 8), planes, scales, sp.origin_ab,
             sp.inv_spacing_ab, sp.dp)
    assert torch.equal(out.reshape(192, 8), ref)
    with pytest.raises(ValueError, match="must divide"):
        make_pipelined_segment_tracer(m, lay, sp, 3)
    with pytest.raises(ValueError, match="shard_chunks"):
        make_pipelined_segment_tracer(
            m, lay, sp._replace(seg_planes=planes, scales=scales), 3,
            shard_chunks=True)


# ---------------------------------------------------------------------------
# pipeline.run(mesh=): the three modes against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run_scene():
    jd = JDomain(2 * EXT, 32).test_lens(ne_0=5e24, LR=1.5e-3)
    jd.phaseshift = True
    s0 = np.asarray(init_beam(jax.random.PRNGKey(7), 1000, 7e-3, 1e-3, EXT,
                              "circular"))
    return jd, convert.domain(jd, "cpu"), s0, torch.tensor(s0)


def test_run_ray_parallel_matches_jax(run_scene):
    """1,000 rays (not a multiple of 8: padded with rays that land
    nowhere) on every solver, with the coherent bench beside."""
    jd, td, s0, ts0 = run_scene
    m = ray_mesh(devices=CPU8)
    jm = jmesh.ray_mesh()
    names = ("shadowgraphy", "interferometry")
    for solver in ("zscan_seg", "zscan", "time", "analytic"):
        kw = dict(solver=solver, bins=BINS, diagnostic=names, seg_K=8)
        if solver == "analytic":
            kw.pop("seg_K")
        Hm = tpipe.run(td, ts0, mesh=m, **kw)
        Hs = tpipe.run(td, ts0, **kw)
        assert torch.equal(Hm["shadowgraphy"], Hs["shadowgraphy"]), solver
        if solver in ("analytic",):
            continue
        Hj = jpipe.run(jd, jnp.asarray(s0), mesh=jm, **kw)
        _close_images(Hm["shadowgraphy"], Hj["shadowgraphy"])
        _close_coherent(Hm["interferometry"], Hs["interferometry"],
                        Hj["interferometry"])
    # a bundle already split over the rays axis is taken as it is
    kw = dict(solver="zscan_seg", seg_K=8, bins=BINS)
    assert torch.equal(tpipe.run(td, shard(ts0, m, (None, "rays")),
                                 mesh=m, **kw), tpipe.run(td, ts0, **kw))
    with pytest.raises(ValueError, match="no 'rays' axis"):
        tpipe.run(td, ts0, solver="zscan_seg",
                  mesh=Mesh((2,), ("grid",), devices=CPU8[:2]))


def test_run_grid_axis_matches_jax(run_scene):
    jd, td, s0, ts0 = run_scene
    kw = dict(diagnostic="shadowgraphy", solver="zscan_seg", seg_K=8,
              bins=BINS)
    Hs = tpipe.run(td, ts0, **kw)
    for shape, names in (((8,), ("grid",)), ((4, 2), ("grid", "rays"))):
        Hm = tpipe.run(td, ts0, mesh=Mesh(shape, names, devices=CPU8),
                       grid_axis="grid", **kw)
        assert torch.equal(Hm, Hs), shape
    Hj = jpipe.run(jd, jnp.asarray(s0), mesh=_jmesh((4, 2),
                                                    ("grid", "rays")),
                   grid_axis="grid", **kw)
    _close_images(Hm, Hj)
    # int8 with slab weights through the sharded build, and the coherent
    # bench
    m = Mesh((4, 2), ("grid", "rays"), devices=CPU8)
    jm = _jmesh((4, 2), ("grid", "rays"))
    kq = dict(kw, integrator="rk2s2", seg_weights="slab")
    Hm = tpipe.run(td, ts0, mesh=m, grid_axis="grid", pack_dtype="int8",
                   **kq)
    Hs = tpipe.run(td, ts0, pack_dtype="int8", **kq)
    assert torch.equal(Hm, Hs)
    _close_images(Hm, jpipe.run(jd, jnp.asarray(s0), mesh=jm,
                                grid_axis="grid", pack_dtype=jnp.int8,
                                **kq))
    kc = dict(kq, diagnostic="interferometry")
    _close_coherent(tpipe.run(td, ts0, mesh=m, grid_axis="grid", **kc),
                    tpipe.run(td, ts0, pack_dtype="f32", **kc),
                    jpipe.run(jd, jnp.asarray(s0), mesh=jm,
                              grid_axis="grid", **kc))


def test_run_grid_axis_nondivisible_na_matches_jax():
    """33^3: na = 33 padded to 36 over the 4-way grid axis, exactly."""
    jd = JDomain(2 * EXT, 33).test_lens(ne_0=5e24, LR=1.5e-3)
    td = convert.domain(jd, "cpu")
    s0 = np.asarray(init_beam(jax.random.PRNGKey(5), 1000, 7e-3, 1e-3, EXT,
                              "circular"))
    kw = dict(diagnostic="shadowgraphy", solver="zscan_seg", seg_K=8,
              bins=BINS)
    Hs = tpipe.run(td, torch.tensor(s0), **kw)
    Hm = tpipe.run(td, torch.tensor(s0), grid_axis="grid",
                   mesh=Mesh((4, 2), ("grid", "rays"), devices=CPU8), **kw)
    assert torch.equal(Hm, Hs)
    _close_images(Hm, jpipe.run(jd, jnp.asarray(s0), grid_axis="grid",
                                mesh=_jmesh((4, 2), ("grid", "rays")),
                                **kw))


def test_run_pp_axis_matches_jax(run_scene):
    """K = 6 gives 6 segments, padded to 8 with zero segments the tracer
    skips; the shadowgram and the interferogram, f32 and int8."""
    jd, td, s0, ts0 = run_scene
    m = Mesh((8,), ("seg",), devices=CPU8)
    jm = _jmesh((8,), ("seg",))
    sp = tz.build_segment_pack_device(td, K=6, dtype=torch.float32)
    for diag in ("shadowgraphy", "interferometry"):
        kw = dict(diagnostic=diag, solver="zscan_seg", bins=BINS,
                  integrator="rk2s2")
        Hs = tpipe.run(td, ts0, spack=sp, **kw)
        Hm = tpipe.run(td, ts0, spack=sp, mesh=m, pp_axis="seg", **kw)
        assert torch.equal(Hm, Hs), diag
        Hj = jpipe.run(jd, jnp.asarray(s0), seg_K=6, mesh=jm,
                       pp_axis="seg", **kw)
        if diag == "shadowgraphy":
            _close_images(Hm, Hj)
        else:
            assert np.abs(Hm.numpy() - np.asarray(Hj)).sum() <= 0.03 * \
                np.abs(np.asarray(Hj)).sum()
    kq = dict(diagnostic="shadowgraphy", solver="zscan_seg", bins=BINS,
              integrator="rk2s2", seg_K=6, pack_dtype="int8")
    Hm = tpipe.run(td, ts0, mesh=m, pp_axis="seg", pp_chunks=16, **kq)
    assert torch.equal(Hm, tpipe.run(td, ts0, **kq))
    _close_images(Hm, jpipe.run(jd, jnp.asarray(s0), mesh=jm, pp_axis="seg",
                                **dict(kq, pack_dtype=jnp.int8)))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tpipe.run(td, ts0, solver="zscan_seg", mesh=m, pp_axis="seg",
                  grid_axis="seg")
    with pytest.raises(ValueError, match="pp_axis requires"):
        tpipe.run(td, ts0, solver="time", mesh=m, pp_axis="seg")
    with pytest.raises(ValueError, match="multiple of"):
        tpipe.run(td, ts0, mesh=m, pp_axis="seg", pp_chunks=12, **kq)


def test_sharded_pack_build_bit_equal(run_scene):
    jd, td, s0, ts0 = run_scene
    m = Mesh((8,), ("grid",), devices=CPU8)
    for dtype, dither in ((torch.float32, None), (torch.int8, 5),
                          ("int4", 5)):
        one = tz.build_segment_pack_device(td, K=8, dtype=dtype,
                                           dither=dither)
        sh = tz.build_segment_pack_device(td, K=8, dtype=dtype,
                                          dither=dither, mesh=m)
        assert isinstance(sh.seg_planes, Sharded)
        assert sh.seg_planes.shards[1].shape[1] == 32 * 32 // 8
        assert torch.equal(sh.seg_planes.gather(), one.seg_planes)
        assert (sh.scales is None) == (one.scales is None)
        if one.scales is not None:
            assert torch.equal(sh.scales, one.scales)
    # the sharded pack runs every mode and a single-device run
    H = tpipe.run(td, ts0, solver="zscan_seg", spack=sh,
                  integrator="rk2s2", bins=BINS)
    assert torch.equal(H, tpipe.run(td, ts0, solver="zscan_seg",
                                    spack=one, integrator="rk2s2",
                                    bins=BINS))
    assert torch.equal(tpipe.run(td, ts0, solver="zscan_seg", spack=sh,
                                 integrator="rk2s2", bins=BINS, mesh=m,
                                 grid_axis="grid"), H)
    with pytest.raises(ValueError, match="must divide"):
        tz.build_segment_pack_device(td, K=8, mesh=Mesh(
            (3,), ("grid",), devices=CPU8[:3]))
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tz.build_segment_pack_device(td, K=8, mesh=object())
