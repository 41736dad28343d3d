"""The slice as a whole: port ``pipeline.run`` vs JAX ``pipeline.run`` on
the bench lens (33^3, one K = 32 segment) with the same JAX-drawn rays.

Images: equal sums (every ray lands on the detector on both sides) and
|H_port - H_jax|.sum() <= 0.002 * H_jax.sum() (the packs differ in the
last place, which can move a ray near a bin edge into the next bin).
"""

import jax
import numpy as np
import pytest
import torch

from synthpy_tpu import pipeline as jpipe
from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu.tracer.beam import init_beam
from synthpy_tpu_torch import convert
from synthpy_tpu_torch import pipeline as tpipe
from synthpy_tpu_torch.tracer import zscan as tz

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
BINS = (54, 40)


@pytest.fixture(scope="module")
def bench():
    jd = JDomain(2 * EXT, 33).test_lens(ne_0=5e24, LR=1.5e-3)
    s0 = init_beam(jax.random.PRNGKey(0), 8192, 2e-3, 0.0, EXT, "circular")
    return jd, convert.domain(jd, "cpu"), s0, convert.tensor(s0, "cpu")


def _close_images(Ht, Hj, frac=0.002):
    Ht = Ht.numpy() if isinstance(Ht, torch.Tensor) else Ht
    Hj = np.asarray(Hj)
    assert Ht.shape == Hj.shape == (BINS[1], BINS[0])
    assert Ht.sum() == Hj.sum() > 0
    assert np.abs(Ht - Hj).sum() <= frac * Hj.sum()


@pytest.mark.parametrize("tier,integrator", [("bf16", "rk2"),
                                             ("int8", "rk2s2"),
                                             ("int4", "rk2s4")])
def test_run_matches_jax(bench, tier, integrator):
    jd, td, s0, ts0 = bench
    kw = dict(pack_dtype=tier, seg_K=32, integrator=integrator,
              seg_weights="slab", bins=BINS)
    Hj = jpipe.run(jd, s0, solver="zscan_seg", **kw)
    Ht = tpipe.run(td, ts0, solver="zscan_seg", **kw)
    _close_images(Ht, Hj)


def test_run_on_carried_pack_and_multi_diagnostic(bench):
    jd, td, s0, ts0 = bench
    jpack = jz.build_segment_pack_device(jd, K=16, dtype="int4")
    names = ("shadowgraphy", "schlieren_df", "refractometry", "polarimetry")
    kw = dict(diagnostic=names, integrator="rk2s4", seg_weights="stage",
              bins=BINS)
    Hj = jpipe.run(jd, s0, solver="zscan_seg", spack=jpack, **kw)
    Ht = tpipe.run(td, ts0, solver="zscan_seg",
                   spack=convert.segment_pack(jpack, "cpu"), **kw)
    assert set(Ht) == set(names)
    for n in names[:3]:
        _close_images(Ht[n], Hj[n])
    np.testing.assert_allclose(Ht["polarimetry"].sum(),
                               np.asarray(Hj["polarimetry"]).sum(),
                               rtol=1e-5)


def test_default_f32_pack_and_solve(bench):
    jd, td, s0, ts0 = bench
    Hj = jpipe.run(jd, s0, solver="zscan_seg", seg_K=8, bins=BINS)
    Ht = tpipe.run(td, ts0, solver="zscan_seg", seg_K=8, bins=BINS)
    _close_images(Ht, Hj)
    rj = jz.solve_zscan_segments(s0, jd, K=8, return_E=True)
    rt = tz.solve_zscan_segments(ts0, td, K=8, return_E=True)
    assert rt.duration >= 0
    np.testing.assert_allclose(rt.sf.numpy(), np.asarray(rj.sf), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(rj.sf)).max())
    for row in range(4):
        want = np.asarray(rj.rf)[row]
        np.testing.assert_allclose(rt.rf.numpy()[row], want, rtol=0,
                                   atol=2e-6 * np.abs(want).max())
    np.testing.assert_allclose(rt.Jf.numpy(), np.asarray(rj.Jf), atol=1e-6)


def test_unported_paths_raise(bench):
    jd, td, s0, ts0 = bench
    # the mesh modes are ported (tests/test_torch_parallel.py): a mesh that
    # is not a parallel.Mesh is refused
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tpipe.run(td, ts0, solver="zscan_seg", seg_K=8, bins=BINS,
                  mesh=object())
    # pack_dtype="auto" and pack_dither= are ported: JAX's tier and pack
    with pytest.warns(tz.PackTierAdvice, match="chose"):
        Ha = tpipe.run(td, ts0, solver="zscan_seg", seg_K=8, bins=BINS,
                       pack_dtype="auto")
    Hd = tpipe.run(td, ts0, solver="zscan_seg", seg_K=8, bins=BINS,
                   pack_dtype="int8", pack_dither=3)
    Hj = jpipe.run(jd, s0, solver="zscan_seg", seg_K=8, bins=BINS,
                   pack_dtype="int8", pack_dither=3)
    _close_images(Hd, Hj)
    assert float(Ha.sum()) == float(Hd.sum())
    # an overcritical field falls back to the time tracer, as in JAX
    hot = convert.domain(JDomain(2 * EXT, 17).test_lens(ne_0=1e28), "cpu")
    with pytest.warns(UserWarning, match="critical density"):
        H = tpipe.run(hot, ts0, solver="zscan_seg", seg_K=8, bins=BINS)
    assert torch.equal(H, tpipe.run(hot, ts0, solver="time", bins=BINS))
