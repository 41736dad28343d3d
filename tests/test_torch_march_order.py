"""Ray order of kernel K1 and the port's ``sort_rays=``, against JAX.

K1 marches the rays in entry-cell order (``march.ray_order``): a stable
argsort of each ray's frozen corner cell ia0 * nb + ib0 of the first
segment, ia0 = clip(floor(ta), 0, na-2) (JAX zscan.py:850-853). Checked
here: that key equals the JAX frozen cell (exactly), the order is a stable
and complete permutation, and the plain march run in that order and put
back is bit-equal to the plain march (every ray's arithmetic is its own).

``sort_rays=True`` in ``synth_image_zscan`` and ``run`` reorders by the
JAX package's key (pipeline.py:240-246); images are held to the JAX ones
with the tolerance of tests/test_torch_pipeline.py (equal sums,
|H_port - H_jax|.sum() <= 0.002 * H_jax.sum()) and to the port's own
unsorted image exactly (a count image does not depend on the order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import pipeline as jpipe
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields import layout_of
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu.tracer.beam import init_beam
from synthpy_tpu_torch import convert
from synthpy_tpu_torch import pipeline as tpipe
from synthpy_tpu_torch.kernels import march
from synthpy_tpu_torch.tracer import zscan as tz

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
BINS = (54, 40)
SCENES = {"lens_z": dict(dims=17), "lens_x": dict(dims=(19, 17, 21),
                                                 probe="x")}


def _jpack(scene, K=8):
    kw = SCENES[scene]
    jd = JDomain(2 * EXT, kw["dims"],
                 probing_direction=kw.get("probe", "z"))
    jd.test_lens(ne_0=5e24, LR=1.5e-3)
    return jd, jz.build_segment_pack_device(jd, K=K, dtype=jnp.float32)


def _rays(jp, case, n=3000, seed=0):
    """(N, 8) permuted states whose (a, b) are random inside the grid,
    on its grid lines, or up to two cells past its edges."""
    rng = np.random.default_rng(seed)
    na, nb = jp.shape_ab
    o = np.asarray(jp.origin_ab, np.float64)
    d = 1.0 / np.asarray(jp.inv_spacing_ab, np.float64)
    n_ab = np.array([na, nb])
    if case == "inside":
        t = rng.uniform(0, 1, (n, 2)) * (n_ab - 1)
    elif case == "grid_lines":
        t = rng.integers(0, n_ab, (n, 2)).astype(np.float64)
    else:  # past the edges
        t = rng.uniform(-2.0, n_ab + 1.0, (n, 2))
    u = rng.normal(size=(n, 8)).astype(np.float32)
    u[:, :2] = (o + t * d).astype(np.float32)
    return u


def _jax_frozen_cell(jp, u):
    """zscan.py:850-853 as written there, on the same f32 inputs."""
    na, nb = jp.shape_ab
    uc = jnp.asarray(u)
    ta = (uc[:, 0] - jp.origin_ab[0]) * jp.inv_spacing_ab[0]
    tb = (uc[:, 1] - jp.origin_ab[1]) * jp.inv_spacing_ab[1]
    ia0 = jnp.clip(jnp.floor(ta).astype(jnp.int32), 0, na - 2)
    ib0 = jnp.clip(jnp.floor(tb).astype(jnp.int32), 0, nb - 2)
    return np.asarray(ia0 * nb + ib0)


def _geo(jp):
    return (tuple(jp.shape_ab), np.asarray(jp.origin_ab).tolist(),
            np.asarray(jp.inv_spacing_ab).tolist())


@pytest.mark.parametrize("case", ["inside", "grid_lines", "past_edges"])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_entry_cell_is_jax_frozen_cell(scene, case):
    _, jp = _jpack(scene)
    u = _rays(jp, case)
    got = march.entry_cells(torch.from_numpy(u), *_geo(jp))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_frozen_cell(jp, u))
    if case == "past_edges":
        na, nb = jp.shape_ab
        cells = got.numpy()
        assert (cells // nb == 0).any() and (cells // nb == na - 2).any()


def test_entry_cell_of_nan_ray_is_zero():
    _, jp = _jpack("lens_z")
    u = _rays(jp, "inside", n=4)
    u[1, 0] = np.nan
    u[2, 1] = np.nan
    got = march.entry_cells(torch.from_numpy(u), *_geo(jp)).numpy()
    nb = jp.shape_ab[1]
    assert got[1] // nb == 0 and got[2] % nb == 0


@pytest.mark.parametrize("case", ["inside", "grid_lines", "past_edges"])
def test_ray_order_is_stable_complete_permutation(case):
    _, jp = _jpack("lens_z")
    u = torch.from_numpy(_rays(jp, case, n=5000, seed=1))
    key = march.entry_cells(u, *_geo(jp)).numpy()
    order = march.ray_order(u, *_geo(jp))
    assert order.dtype == torch.int64
    order = order.numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(len(key)))
    np.testing.assert_array_equal(order, np.argsort(key, kind="stable"))
    assert (np.diff(key[order]) >= 0).all()
    assert len(np.unique(key)) < len(key)  # ties exist and kept in order


@pytest.mark.parametrize("weights", ["stage", "slab"])
@pytest.mark.parametrize("integrator", ["rk4", "rk2", "rk2s2", "rk2s4"])
def test_plain_march_in_ray_order_put_back_is_bit_equal(integrator,
                                                        weights):
    jd, jp = _jpack("lens_z", K=9)
    tp = convert.segment_pack(jp, "cpu")
    s0 = init_beam(jax.random.PRNGKey(3), 2048, 2.2e-3, 2e-3, EXT,
                   "circular")
    u = tz.permute_state(convert.tensor(s0, "cpu"), "z").contiguous()
    kw = dict(shape_ab=tp.shape_ab, origin_ab=tp.origin_ab.tolist(),
              inv_ab=tp.inv_spacing_ab.tolist(), dp=tp.dp,
              layout=layout_of(jd), K=tp.K, integrator=integrator,
              weights=weights)
    want = march.march_plain(u, tp.seg_planes, None, **kw)
    order = march.ray_order(u, tp.shape_ab, kw["origin_ab"], kw["inv_ab"])
    assert not torch.equal(order, torch.arange(len(order)))
    got = torch.empty_like(want)
    got[order] = march.march_plain(u[order], tp.seg_planes, None, **kw)
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def bench():
    jd = JDomain(2 * EXT, 33).test_lens(ne_0=5e24, LR=1.5e-3)
    s0 = init_beam(jax.random.PRNGKey(0), 8192, 2e-3, 0.0, EXT, "circular")
    return jd, convert.domain(jd, "cpu"), s0, convert.tensor(s0, "cpu")


def _close_images(Ht, Hj, frac=0.002):
    Ht = Ht.numpy()
    Hj = np.asarray(Hj)
    assert Ht.shape == Hj.shape == (BINS[1], BINS[0])
    assert Ht.sum() == Hj.sum() > 0
    assert np.abs(Ht - Hj).sum() <= frac * Hj.sum()


@pytest.mark.parametrize("tier,integrator", [("bf16", "rk2"),
                                             ("int4", "rk2s4")])
def test_synth_image_zscan_sort_rays_matches_jax(bench, tier, integrator):
    jd, td, s0, ts0 = bench
    jp = jz.build_segment_pack_device(
        jd, K=32, dtype="int4" if tier == "int4" else jnp.bfloat16)
    tp = convert.segment_pack(jp, "cpu")
    common = dict(seg_K=jp.K, shape_ab=jp.shape_ab, integrator=integrator,
                  seg_weights="slab", bins=BINS)
    Hj = jpipe.synth_image_zscan(
        s0, jp.seg_planes, jp.origin_ab, jp.inv_spacing_ab, EXT,
        layout=layout_of(jd), n_slabs=jp.n_slabs, p0=jp.p0,
        dp_static=jp.dp, sort_rays=True, segmented=True,
        seg_scales=jp.scales, seg_qbits=jp.qbits, **common)
    kw = dict(layout=layout_of(jd), p0=tp.p0, dp_static=tp.dp,
              seg_scales=tp.scales, seg_qbits=tp.qbits, **common)
    args = (ts0, tp.seg_planes, tp.origin_ab, tp.inv_spacing_ab, EXT)
    Ht = tpipe.synth_image_zscan(*args, n_slabs=tp.n_slabs, sort_rays=True,
                                 segmented=True, **kw)
    _close_images(Ht, Hj)
    assert torch.equal(Ht, tpipe.synth_image_zscan(
        *args, n_slabs=tp.n_slabs, segmented=True, **kw))


def test_run_sort_rays_matches_jax(bench):
    jd, td, s0, ts0 = bench
    kw = dict(pack_dtype="int8", seg_K=32, integrator="rk2s2",
              seg_weights="slab", bins=BINS, sort_rays=True)
    Hj = jpipe.run(jd, s0, solver="zscan_seg", **kw)
    Ht = tpipe.run(td, ts0, solver="zscan_seg", **kw)
    _close_images(Ht, Hj)
    kw.pop("sort_rays")
    assert torch.equal(Ht, tpipe.run(td, ts0, solver="zscan_seg", **kw))
