"""The host-pack route and the A.12 branches of ``pipeline.run``.

* ``solve_zscan_segments_streamed`` (one K1 launch per segment, the
  segments copied up one at a time) is bit-equal to the port's in-memory
  march of the same pack, with and without a partial ``DeviceSegmentCache``
  (JAX's own contract, tests/test_zscan.py:752), and holds to JAX's
  streamed march at the march tolerance of ROADMAP C.6 (2e-6 of a column
  at 8-9 slabs).
* ``run`` on a host pack gives the device pack's image.
* ``run`` with ``batch_pack_bytes`` below the pack traces per-call ray
  batches: incoherent counts exactly the one-call image, coherent field
  sums within C.7's bound (1e-4 of the most rays a pixel: float adds in
  another order), pad rays on no bin.
* ``pack_dtype="auto"`` chooses JAX's tier (int4 falls back to int8 for
  integrators that are not even-stride) and warns ``PackTierAdvice``;
  ``pack_dither=`` builds the dithered pack.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu import pipeline as jpipe
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.tracer import init_beam as jinit
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu_torch import convert
from synthpy_tpu_torch import pipeline as tpipe
from synthpy_tpu_torch.tracer import zscan as tz

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
BINS = (54, 40)


def _full_physics(dims=25):
    d = JDomain(2 * EXT, dims).test_lens(ne_0=1e25, LR=2e-3)
    d.external_Te(50.0 * np.ones(d.dims))
    d.external_Z(2.0 * np.ones(d.dims))
    d.inv_brems = True
    d.phaseshift = True
    d.test_B(Bmax=10.0)
    return d


@pytest.fixture(scope="module")
def physics():
    jd = _full_physics()
    s0 = jinit(jax.random.PRNGKey(41), 512, 1.5e-3, 1e-3, EXT, "circular")
    return jd, convert.domain(jd, "cpu"), s0, convert.tensor(s0, "cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
@pytest.mark.parametrize("integrator", ["rk4", "rk2s2"])
def test_streamed_march_bit_equal_to_in_memory(physics, integrator, dtype):
    _, td, _, ts0 = physics
    host = tz.build_segment_pack_streaming(td, K=8, dtype=dtype,
                                           device=False)
    dev = tz.build_segment_pack_streaming(td, K=8, dtype=dtype)
    assert host.host and not dev.host and host.seg_planes.shape[0] == 3
    ref = tz.solve_zscan_segments(ts0, td, spack=dev, integrator=integrator)
    out = tz.solve_zscan_segments_streamed(ts0, td, hpack=host,
                                           integrator=integrator)
    assert torch.equal(out.sf, ref.sf) and torch.equal(out.rf, ref.rf)
    seg_bytes = host.seg_planes[0].numel() * host.seg_planes.element_size()
    for budget in (seg_bytes * 1, seg_bytes * 3):
        cache = tz.make_device_segment_cache(host, budget_bytes=budget,
                                             device="cpu")
        assert len(cache.resident) == budget // seg_bytes
        res = tz.solve_zscan_segments_streamed(ts0, td, hpack=host,
                                               integrator=integrator,
                                               cache=cache)
        assert torch.equal(res.sf, ref.sf)


def test_stale_cache_is_refused(physics):
    _, td, _, ts0 = physics
    host = tz.build_segment_pack_streaming(td, K=8, dtype=torch.float32,
                                           device=False)
    other = tz.build_segment_pack_streaming(td, K=8, dtype=torch.float32,
                                            device=False)
    stale = tz.make_device_segment_cache(other, budget_bytes=1 << 30,
                                         device="cpu")
    with pytest.raises(ValueError, match="different pack"):
        tz.solve_zscan_segments_streamed(ts0, td, hpack=host, cache=stale)


@pytest.mark.parametrize("integrator", ["rk4", "rk2s2"])
def test_streamed_march_matches_jax(physics, integrator):
    jd, td, s0, ts0 = physics
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jhost = jz.build_segment_pack_streaming(jd, K=8, dtype=jnp.float32,
                                                device=False)
        ref = jz.solve_zscan_segments_streamed(s0, jd, hpack=jhost,
                                               integrator=integrator)
    # JAX's host pack carried across: the same table, marched by the port
    out = tz.solve_zscan_segments_streamed(
        ts0, td, hpack=convert.segment_pack(jhost, "cpu"),
        integrator=integrator)
    want = np.asarray(ref.sf)
    got = out.sf.numpy()
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 2e-6 * scale + 1e-30).all()


@pytest.fixture(scope="module")
def lens():
    jd = JDomain(2 * EXT, 25).test_lens(ne_0=5e24, LR=1.5e-3)
    s0 = jinit(jax.random.PRNGKey(43), 3000, 2e-3, 1e-3, EXT, "circular")
    return jd, convert.domain(jd, "cpu"), s0, convert.tensor(s0, "cpu")


def test_run_on_a_host_pack(lens):
    _, td, _, ts0 = lens
    host = tz.build_segment_pack_streaming(td, K=8, dtype=torch.float32,
                                           device=False)
    ref = tpipe.run(td, ts0, solver="zscan_seg", seg_K=8, bins=BINS)
    out = tpipe.run(td, ts0, solver="zscan_seg", spack=host, bins=BINS)
    assert torch.equal(out, ref) and float(out.sum()) > 0
    cache = tz.make_device_segment_cache(host, 1 << 30, device="cpu")
    both = tpipe.run(td, ts0, solver="zscan_seg", spack=host, bins=BINS,
                     seg_cache=cache, diagnostic=("shadowgraphy",
                                                  "interferometry"))
    assert torch.equal(both["shadowgraphy"], ref)


def test_run_batches_packs_above_batch_pack_bytes(lens):
    jd, td, _, ts0 = lens
    sp = tz.build_segment_pack_device(td, K=8, dtype=torch.float32)
    per_ray = 4 * sp.seg_planes.shape[-1] * 4
    names = ("shadowgraphy", "schlieren_df", "interferometry")
    kw = dict(solver="zscan_seg", spack=sp, bins=BINS, diagnostic=names,
              coherent_raw=True)
    one = tpipe.run(td, ts0, **kw)
    # 1100-ray batches: three of them, the last padded with 300 rays
    bat = tpipe.run(td, ts0, batch_pack_bytes=1000,
                    batch_corner_bytes=per_ray * 1100, **kw)
    for n in ("shadowgraphy", "schlieren_df"):
        assert torch.equal(bat[n], one[n]) and float(one[n].sum()) > 0
    rays_a_pixel = float(one["shadowgraphy"].max())
    assert float((bat["interferometry"] - one["interferometry"]).abs().max()
                 ) <= 1e-4 * rays_a_pixel
    # coherent_raw off: the raw sums are finalized once, after the batches
    fin = tpipe.run(td, ts0, batch_pack_bytes=1000,
                    batch_corner_bytes=per_ray * 1100,
                    **{**kw, "coherent_raw": False})
    ref = tpipe.finalize_coherent(one["interferometry"], "interferometry")
    assert float((fin["interferometry"] - ref).abs().sum()
                 / ref.abs().sum()) <= 1e-5
    # the pack is below the default batch_pack_bytes: one call
    assert torch.equal(tpipe.run(td, ts0, **{**kw, "diagnostic":
                                             "shadowgraphy"}),
                       one["shadowgraphy"])


def test_pad_rays_land_nowhere(lens):
    _, td, _, ts0 = lens
    padded = tpipe._pad_ray_cols(ts0, 1024, 0, 1)
    assert padded.shape[1] == 3072
    assert torch.equal(padded[:, :3000], ts0)
    assert bool((padded[:2, 3000:] == 1e9).all())
    sp = tz.build_segment_pack_device(td, K=8, dtype=torch.float32)
    pads = tpipe.run(td, padded[:, 3000:], solver="zscan_seg", spack=sp,
                     bins=BINS)
    assert float(pads.sum()) == 0.0


def test_pack_dtype_auto_and_dither_match_jax(lens):
    jd, td, s0, ts0 = lens
    kw = dict(solver="zscan_seg", bins=(41, 31), critical_guard=None,
              seg_K=16)
    with pytest.warns(tz.PackTierAdvice, match="chose int8"):
        img = tpipe.run(td, ts0, integrator="rk2s2", pack_dtype="auto", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jimg = np.asarray(jpipe.run(jd, s0, integrator="rk2s2",
                                    pack_dtype="auto", **kw))
    assert img.sum() == jimg.sum() > 0
    assert np.abs(img.numpy() - jimg).sum() <= 0.002 * jimg.sum()
    # the advice for a turbulent field is int4, which needs rk2s2 / rk2s4
    from synthpy_tpu.fields.grf import grf_domain_fft, power_law

    _, f = grf_domain_fft(jax.random.PRNGKey(0), power_law(-11.0 / 3.0),
                          l_max=2e-3, l_min=4e-4, extent=5e-3, res=12)
    jt = JDomain(1e-2, 24)
    jt.external_ne(1e23 * (1.0 + 0.5 * jnp.asarray(f)))
    tt = convert.domain(jt, "cpu")
    st = ts0[:, :500]
    with pytest.warns(tz.PackTierAdvice, match="int4 needs"):
        tpipe.run(tt, st, pack_dtype="auto", **kw)
    with pytest.warns(tz.PackTierAdvice, match="chose int4"):
        a = tpipe.run(tt, st, pack_dtype="auto", integrator="rk2s4", **kw)
    # "auto" is the dithered int4 pack of the advised seed
    b = tpipe.run(tt, st, pack_dtype="int4", pack_dither=7,
                  integrator="rk2s4", **kw)
    assert torch.equal(a, b)
