"""Port segment packs (kernel K2's plain version) vs the JAX package.

Float builds are held per channel to rtol 1e-6 of the channel's largest
value (channels span ~15 orders of magnitude; XLA folds the builder's
divisions by constants into reciprocal multiplications, a last-place
difference). Quantisation and decimation of one pack are data movement
and IEEE division: bit-identical. Quantised builds compare codes within
+-1 on at most 1e-4 of the values (a last-place channel difference can
move a value across a rounding boundary). Quantised and strided builds are
made straight from the volumes (``plane_stride`` output plane k is
absolute plane s*K + k*S), and are held to the JAX builds the same way and
to the decimation of the port's own full build exactly.

Dither draws JAX's threefry stream (``synthpy_tpu_torch.random``): the
quantiser of a carried JAX pack is bit-equal to JAX's for the same key;
dithered builds give JAX's codes bit for bit on every case here, and its
scales bit for bit where the f32 channels are (z-probing lenses), else to
their last place (x/y-probing and the full-physics channels differ from
XLA's there; a scale is amax * f32(1/qmax)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu_torch import convert
from synthpy_tpu_torch.tracer import zscan as tz

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3


def _lens(dims, probing_direction="z"):
    return JDomain(2 * EXT, dims, probing_direction=probing_direction
                   ).test_lens(ne_0=5e24, LR=1.5e-3)


def _full_physics(dims=25):
    d = JDomain(2 * EXT, dims).test_lens(ne_0=1e25, LR=2e-3)
    d.external_Te(50.0 * np.ones(d.dims))
    d.external_Z(2.0 * np.ones(d.dims))
    d.inv_brems = True
    d.phaseshift = True
    d.test_B(Bmax=10.0)
    return d


CASES = {
    "lens17_K8": (lambda: _lens(17), 8),
    "lens33_K32": (lambda: _lens(33), 32),
    "nondivisible": (lambda: _lens((17, 19, 23)), 8),
    "probe_y": (lambda: _lens((17, 21, 19), "y"), 8),
    "probe_x": (lambda: _lens((19, 17, 21), "x"), 8),
    "full_physics": (_full_physics, 8),
}


@pytest.fixture(scope="module")
def f32_packs():
    """{case: (jax domain, jax f32 pack, port f32 pack)}, built once."""
    out = {}
    for name, (make, K) in CASES.items():
        jd = make()
        jpack = jz.build_segment_pack_device(jd, K=K, dtype=jnp.float32)
        tpack = tz.build_segment_pack_device(convert.domain(jd, "cpu"), K=K,
                                             dtype=torch.float32)
        out[name] = (jd, jpack, tpack)
    return out


def _per_channel_close(a, b, K, rtol=1e-6):
    assert a.shape == b.shape
    C = a.shape[-1] // (K + 1)
    a = a.reshape(*a.shape[:-1], K + 1, C)
    b = b.reshape(*b.shape[:-1], K + 1, C)
    for c in range(C):
        scale = np.abs(b[..., c]).max()
        np.testing.assert_allclose(a[..., c], b[..., c],
                                   atol=max(scale, 1e-30) * rtol, rtol=0,
                                   err_msg=f"channel {c}")


def _codes(spack):
    return np.asarray(spack.seg_planes).astype(np.int16)


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_build_matches_jax(f32_packs, case):
    _, jpack, tpack = f32_packs[case]
    _per_channel_close(tpack.seg_planes.numpy(),
                       np.asarray(jpack.seg_planes), jpack.K)
    np.testing.assert_array_equal(tpack.origin_ab.numpy(),
                                  np.asarray(jpack.origin_ab))
    np.testing.assert_array_equal(tpack.inv_spacing_ab.numpy(),
                                  np.asarray(jpack.inv_spacing_ab))
    assert (tpack.shape_ab, tpack.K, tpack.n_slabs) == (
        tuple(jpack.shape_ab), jpack.K, jpack.n_slabs)
    assert (tpack.p0, tpack.dp, tpack.omega) == (jpack.p0, jpack.dp,
                                                  jpack.omega)
    assert tpack.scales is None and tpack.qbits is None


@pytest.mark.parametrize("case", ["lens33_K32", "full_physics"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_carried_pack_bit_identical(f32_packs, case, bits):
    _, jpack, _ = f32_packs[case]
    jq = jz.quantize_segment_pack(jpack, bits=bits)
    tq = tz.quantize_segment_pack(convert.segment_pack(jpack, "cpu"),
                                  bits=bits)
    assert tq.seg_planes.dtype == torch.int8
    np.testing.assert_array_equal(tq.seg_planes.numpy(),
                                  np.asarray(jq.seg_planes))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    assert tq.qbits == jq.qbits


@pytest.mark.parametrize("tier", ["f32", "int8", "int4"])
def test_decimate_bit_identical(f32_packs, tier):
    _, jpack, _ = f32_packs["lens33_K32"]
    if tier != "f32":
        jpack = jz.quantize_segment_pack(jpack,
                                         bits=8 if tier == "int8" else 4)
    for stride in (2, 4):
        jd = jz.decimate_segment_pack(jpack, stride)
        td = tz.decimate_segment_pack(convert.segment_pack(jpack, "cpu"),
                                      stride)
        np.testing.assert_array_equal(td.seg_planes.numpy(),
                                      np.asarray(jd.seg_planes))
        if tier != "f32":
            np.testing.assert_array_equal(td.scales.numpy(),
                                          np.asarray(jd.scales))
        assert (td.K, td.n_slabs, td.dp) == (jd.K, jd.n_slabs, jd.dp)


@pytest.mark.parametrize("case", ["lens33_K32", "full_physics"])
@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_quantised_build_codes_within_one(f32_packs, case, tier):
    jdom, jpack, _ = f32_packs[case]
    K = jpack.K
    jq = jz.build_segment_pack_device(jdom, K=K, dtype=jz.PACK_DTYPES[tier])
    tq = tz.build_segment_pack_device(convert.domain(jdom, "cpu"), K=K,
                                      dtype=tz.PACK_DTYPES[tier])
    assert tq.seg_planes.shape == jq.seg_planes.shape
    if tier == "int4":
        # compare per-plane codes, not bytes
        from synthpy_tpu_torch.kernels.pack import nibble_hi, nibble_lo
        a = torch.stack([nibble_lo(tq.seg_planes), nibble_hi(tq.seg_planes)])
        b = convert.tensor(jq.seg_planes, "cpu")
        b = torch.stack([nibble_lo(b), nibble_hi(b)])
        diff = (a - b).abs().numpy()
    else:
        diff = np.abs(tq.seg_planes.numpy().astype(np.int16) - _codes(jq))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4
    np.testing.assert_allclose(tq.scales.numpy(), np.asarray(jq.scales),
                               rtol=1e-6)


@pytest.mark.parametrize("tier", ["f32", "bf16", "int8", "int4"])
def test_plane_stride_build(f32_packs, tier):
    jdom, jpack, tpack = f32_packs["lens33_K32"]
    tdom = convert.domain(jdom, "cpu")
    ts = tz.build_segment_pack_device(tdom, K=32, dtype=tz.PACK_DTYPES[tier],
                                      plane_stride=2)
    js = jz.build_segment_pack_device(jdom, K=32, dtype=jz.PACK_DTYPES[tier],
                                      plane_stride=2)
    assert (ts.K, ts.n_slabs, ts.dp) == (js.K, js.n_slabs, js.dp)
    if tier in ("f32", "bf16"):
        _per_channel_close(ts.seg_planes.float().numpy(),
                           convert.tensor(js.seg_planes, "cpu").float()
                           .numpy(), 16, rtol=1e-6 if tier == "f32"
                           else 2 ** -8)
        ref = tz.decimate_segment_pack(tpack, 2).seg_planes
        if tier == "f32":
            assert torch.equal(ts.seg_planes, ref)
    else:
        full = tz.build_segment_pack_device(tdom, K=32,
                                            dtype=tz.PACK_DTYPES[tier])
        assert torch.equal(ts.seg_planes,
                           tz.decimate_segment_pack(full, 2).seg_planes)


def _assert_codes_within_one(tq, jq):
    """Per-plane codes within +-1 on at most 1e-4 of the values, scales to
    rtol 1e-6 (test_quantised_build_codes_within_one's contract)."""
    assert tq.seg_planes.shape == jq.seg_planes.shape
    assert (tq.K, tq.n_slabs, tq.dp, tq.qbits) == (jq.K, jq.n_slabs, jq.dp,
                                                   jq.qbits)
    from synthpy_tpu_torch.kernels.pack import nibble_hi, nibble_lo
    a = tq.seg_planes
    b = convert.tensor(jq.seg_planes, "cpu")
    if tq.qbits == 4:
        a = torch.stack([nibble_lo(a), nibble_hi(a)])
        b = torch.stack([nibble_lo(b), nibble_hi(b)])
    diff = (a.to(torch.int16) - b.to(torch.int16)).abs().numpy()
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4
    np.testing.assert_allclose(tq.scales.numpy(), np.asarray(jq.scales),
                               rtol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("tier", ["int8", "int4"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_quantised_strided_build_matches_jax(f32_packs, case, tier,
                                                   stride):
    jdom, jpack, _ = f32_packs[case]
    K = jpack.K
    jq = jz.build_segment_pack_device(jdom, K=K, dtype=jz.PACK_DTYPES[tier],
                                      plane_stride=stride)
    tq = tz.build_segment_pack_device(convert.domain(jdom, "cpu"), K=K,
                                      dtype=tz.PACK_DTYPES[tier],
                                      plane_stride=stride)
    _assert_codes_within_one(tq, jq)


@pytest.mark.parametrize("tier", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("case", ["lens33_K32", "probe_x", "probe_y",
                                  "full_physics"])
def test_strided_build_is_decimated_full_build(f32_packs, case, tier):
    jdom, jpack, _ = f32_packs[case]
    tdom = convert.domain(jdom, "cpu")
    dt = tz.PACK_DTYPES[tier]
    full = tz.build_segment_pack_device(tdom, K=jpack.K, dtype=dt)
    ts = tz.build_segment_pack_device(tdom, K=jpack.K, dtype=dt,
                                      plane_stride=2)
    td = tz.decimate_segment_pack(full, 2)
    assert ts.seg_planes.dtype == td.seg_planes.dtype
    assert torch.equal(ts.seg_planes, td.seg_planes)
    assert (ts.K, ts.n_slabs, ts.dp, ts.qbits) == (td.K, td.n_slabs, td.dp,
                                                   td.qbits)
    if tier in ("int8", "int4"):
        assert torch.equal(ts.scales, td.scales)
    else:
        assert ts.scales is None


def test_bf16_carries_across_bit_exact(f32_packs):
    _, jpack, _ = f32_packs["lens17_K8"]
    jb = jpack._replace(seg_planes=jpack.seg_planes.astype(jnp.bfloat16))
    tb = convert.segment_pack(jb, "cpu")
    assert tb.seg_planes.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tb.seg_planes.view(torch.int16).numpy(),
        np.asarray(jb.seg_planes).view(np.int16))


def test_metadata_and_unported_options(f32_packs):
    jdom, jpack, _ = f32_packs["nondivisible"]
    tdom = convert.domain(jdom, "cpu")
    tm = tz.segment_pack_metadata(tdom, K=8)
    jm = jz.segment_pack_metadata(jdom, K=8)
    assert tm.seg_planes is None
    assert (tm.shape_ab, tm.K, tm.n_slabs, tm.p0, tm.dp, tm.omega) == (
        tuple(jm.shape_ab), jm.K, jm.n_slabs, jm.p0, jm.dp, jm.omega)
    # mesh= is ported (tests/test_torch_parallel.py): a mesh that is not a
    # parallel.Mesh is refused
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tz.build_segment_pack_device(tdom, K=8, dtype=torch.int8,
                                     mesh=object())
    # dither is ported: the fused build equals the quantiser of the f32
    # build for the same key, and float tiers refuse it as JAX does
    dith = tz.build_segment_pack_device(tdom, K=8, dtype=torch.int8,
                                        dither=0)
    quant = tz.quantize_segment_pack(tz.build_segment_pack_device(
        tdom, K=8, dtype=torch.float32), 8, dither=0)
    assert torch.equal(dith.seg_planes, quant.seg_planes)
    with pytest.raises(ValueError, match="quantised"):
        tz.build_segment_pack_device(tdom, K=8, dtype=torch.float32,
                                     dither=1)
    with pytest.raises(ValueError):
        tz.build_segment_pack_device(tdom, K=8, dtype="int4",
                                     plane_stride=8)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ["lens33_K32", "full_physics"])
def test_dithered_quantiser_bit_equal(f32_packs, case, bits):
    """The JAX f32 pack carried across and quantised with dither: codes and
    scales bit-equal to JAX's for the same key (int seed, raw or typed
    JAX key)."""
    import jax

    _, jpack, _ = f32_packs[case]
    jq = jz.quantize_segment_pack(jpack, bits, dither=7)
    carried = convert.segment_pack(jpack, "cpu")
    for key in (7, jax.random.PRNGKey(7), convert.key(jax.random.key(7))):
        tq = tz.quantize_segment_pack(carried, bits, dither=key)
        np.testing.assert_array_equal(tq.seg_planes.numpy(),
                                      np.asarray(jq.seg_planes))
        np.testing.assert_array_equal(tq.scales.numpy(),
                                      np.asarray(jq.scales))
    # another key dithers otherwise; exact zeros stay exact
    other = tz.quantize_segment_pack(carried, bits, dither=8)
    assert not torch.equal(other.seg_planes, tq.seg_planes)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("tier", ["int8", "int4"])
@pytest.mark.parametrize("case", ["lens33_K32", "probe_x", "full_physics"])
def test_dithered_build_matches_jax(f32_packs, case, tier, stride):
    """Dithered fused builds, keyed by the absolute plane: codes bit-equal
    to JAX's; scales bit-equal on the z-probing lens, within 1e-6 (the
    channels' last place) elsewhere; and bit-equal to the port's own
    quantiser of its full f32 build, decimated."""
    jd, _, tpack = f32_packs[case]
    K = CASES[case][1]
    if tier == "int4" and (K // stride) % 2:
        pytest.skip("int4 needs an even K / plane_stride")
    jdt = {"int8": jnp.int8, "int4": "int4"}[tier]
    tdt = {"int8": torch.int8, "int4": "int4"}[tier]
    jb = jz.build_segment_pack_device(jd, K=K, dtype=jdt,
                                      plane_stride=stride, dither=7)
    tb = tz.build_segment_pack_device(convert.domain(jd, "cpu"), K=K,
                                      dtype=tdt, plane_stride=stride,
                                      dither=7)
    np.testing.assert_array_equal(tb.seg_planes.numpy(),
                                  np.asarray(jb.seg_planes))
    if case == "lens33_K32":
        np.testing.assert_array_equal(tb.scales.numpy(),
                                      np.asarray(jb.scales))
    else:
        np.testing.assert_allclose(tb.scales.numpy(), np.asarray(jb.scales),
                                   rtol=1e-6, atol=0)
    full = tz.quantize_segment_pack(tpack, 8 if tier == "int8" else 4,
                                    dither=7)
    dec = tz.decimate_segment_pack(full, stride)
    assert torch.equal(tb.seg_planes, dec.seg_planes)
    assert torch.equal(tb.scales, dec.scales)


def test_dither_keeps_vacuum_exact():
    from synthpy_tpu_torch.fields import ScalarDomain

    dv = ScalarDomain(2 * EXT, 17, device="cpu").test_null()
    spv = tz.build_segment_pack_device(dv, K=8, dtype=torch.int8, dither=7)
    assert not spv.seg_planes.any()
