"""The scale pack builders (kernel K9's plain version) against the JAX
package: ``build_segment_pack_upload``, ``build_segment_pack_synth``,
``build_segment_pack_streaming``, pack persistence and the tier advice.

The scene is full physics (C = 8: kappa, phase and Faraday channels) at
33^3 with K = 12, so the last of three segments carries four pad slabs.

* Upload: the port's pack equals its own ``build_segment_pack_device`` of
  the same volumes and dither key bit for bit (one channel and quantiser
  arithmetic, K2's). Against JAX's upload: bf16 tables and int8/int4 codes
  bit-equal (observed), scales and f32 tables to the channels' last place
  (1e-6 of each channel's largest value; the phase channel to omega times
  one float32 ulp of 1, its resolution): the port's channels divide where
  XLA multiplies by a folded reciprocal, and use CUDA's / PyTorch's log and
  pow where XLA has its own, so the float channels differ in the last
  place, as K2's do (``test_torch_pack.py``).
* Synth: closures evaluated batch by batch, held to the upload route of the
  same closures by JAX's envelope (< 1% of codes differ, never by more
  than one step) and to JAX's synth the same way.
* Streaming: device and host forms against JAX's (f32 channels to 1e-6,
  int8 codes bit-equal, scales to 1e-6) and against the port's upload.
* Save / load: round trip, and a JAX file loads in the port and the reverse.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.fields import ScalarDomain as JDomain
from synthpy_tpu.fields.grf import grf_domain_fft, power_law
from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu_torch import convert
from synthpy_tpu_torch.fields import ScalarDomain
from synthpy_tpu_torch.tracer import zscan as tz

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

N, EXT, K, PB = 33, 5e-3, 12, 4
TIERS = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                       torch.bfloat16),
         "int8": (jnp.int8, torch.int8), "int4": ("int4", "int4")}


def scene(xp):
    """A z-pinch-like scene as closures over broadcastable (x, y, z) of
    array module ``xp`` (jax.numpy or torch): the same formulas on both
    sides."""
    def ne_fn(x, y, z):
        return (8e23 * xp.exp(-(x**2 + y**2) / (2e-3) ** 2)
                * (1.0 + 0.3 * xp.cos(2 * xp.pi * z / 3e-3)))

    def te_fn(x, y, z):
        return 40.0 + 5.0 * xp.exp(-(x**2 + y**2 + z**2) / (3e-3) ** 2)

    def z_fn(x, y, z):
        return 3.0 + 0.0 * (x + y + z)

    def b_fn(x, y, z):
        r = xp.sqrt(x**2 + y**2) + 1e-12
        bmag = 5.0 * (r / 1.5e-3) / (1.0 + (r / 1.5e-3) ** 2)
        return (-y / r * bmag + 0.0 * z, x / r * bmag, 0.0 * x + 0.0 * z)

    return {"ne": ne_fn, "Te": te_fn, "Z": z_fn, "B": b_fn}


def _volumes():
    """The scene materialised on the grid (numpy float32)."""
    d = JDomain(2 * EXT, N)
    X, Y, Z_ = (np.asarray(c)[s] for c, s in (
        (d.x, np.s_[:, None, None]), (d.y, np.s_[None, :, None]),
        (d.z, np.s_[None, None, :])))
    f = scene(np)
    full = (N, N, N)
    ne = np.broadcast_to(f["ne"](X, Y, Z_), full).astype(np.float32)
    te = np.broadcast_to(f["Te"](X, Y, Z_), full).astype(np.float32)
    zz = np.broadcast_to(f["Z"](X, Y, Z_), full).astype(np.float32)
    B = np.stack([np.broadcast_to(c, full) for c in f["B"](X, Y, Z_)],
                 axis=-1).astype(np.float32)
    return ne, te, zz, B


@pytest.fixture(scope="module")
def domains():
    """(JAX domain with host volumes, port domain with host volumes)."""
    ne, te, zz, B = _volumes()
    jd = JDomain(2 * EXT, N)
    td = convert.domain(jd, "cpu")   # the same coordinates
    for d in (jd, td):
        d.external_ne(ne, host=True)
        d.external_Te(te, host=True)
        d.external_Z(zz, host=True)
        d.external_B(B, host=True)
        d.inv_brems = True
        d.phaseshift = True
    return jd, td


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# the phase channel omega (sqrt(1 - ne / nc) - 1) resolves omega * ulp(1)
# in float32 (~1.1e8 rad/s at 1064 nm): a last-place difference of the
# square root's argument moves it by that much whatever ne is
PHASE_ATOL = 1.7703492e15 * 2.0**-23
PHASE = 4   # the channel index of omega (n - 1) with inv_brems on


def _per_channel_close(a, b, K, rtol=1e-6):
    C = a.shape[-1] // (K + 1)
    a = a.reshape(*a.shape[:-1], K + 1, C)
    b = b.reshape(*b.shape[:-1], K + 1, C)
    for c in range(C):
        scale = max(float(np.abs(b[..., c]).max()), 1e-30)
        atol = max(scale * rtol, PHASE_ATOL if c == PHASE else 0.0)
        np.testing.assert_allclose(a[..., c], b[..., c], atol=atol,
                                   rtol=0, err_msg=f"channel {c}")


def _scales_close(a, b, rtol=1e-6):
    """Scales to ``rtol``, the phase channel's to its resolution over qmax
    (a scale is amax * f32(1/qmax); qmax >= 7)."""
    np.testing.assert_allclose(np.delete(a, PHASE, -1),
                               np.delete(b, PHASE, -1), rtol=rtol, atol=0)
    np.testing.assert_allclose(a[..., PHASE], b[..., PHASE], rtol=rtol,
                               atol=PHASE_ATOL / 7.0)


def _nibbles(a):
    """Sign-extended (low, high) nibble codes of int4 bytes."""
    raw = np.stack([a & 15, (a >> 4) & 15]).astype(np.int16)
    return (raw ^ 8) - 8


def _codes_close(a, b, int4, frac=1e-4):
    """Quantised codes: a channel value's last place can cross a rounding
    boundary (K2's contract, test_torch_pack.py): within one step, on at
    most ``frac`` of the codes."""
    if int4:
        a, b = _nibbles(a), _nibbles(b)
    d = a.astype(np.int16) - b.astype(np.int16)
    assert np.abs(d).max() <= 1
    assert (d != 0).mean() <= frac, (d != 0).mean()


def _meta_equal(tp, jp):
    assert (tp.shape_ab, tp.K, tp.n_slabs, tp.qbits) == (
        tuple(jp.shape_ab), jp.K, jp.n_slabs, getattr(jp, "qbits", None))
    assert (tp.p0, tp.dp, tp.omega) == (jp.p0, jp.dp, jp.omega)
    np.testing.assert_array_equal(tp.origin_ab.numpy(),
                                  np.asarray(jp.origin_ab))


@pytest.mark.parametrize("tier,dither", [
    ("f32", None), ("bf16", None), ("int8", None), ("int8", 11),
    ("int4", None), ("int4", 11)])
def test_upload_matches_device_builder_and_jax(domains, tier, dither):
    jd, td = domains
    jdt, tdt = TIERS[tier]
    tup = tz.build_segment_pack_upload(td, K=K, dtype=tdt, plane_batch=PB,
                                       dither=dither)
    assert tup.seg_planes.shape[0] == 3 and tup.n_slabs == N - 1
    # the port's device builder of the same volumes: bit for bit
    tdev_dom = convert.domain(jd, "cpu")
    tdev_dom.inv_brems = tdev_dom.phaseshift = True
    tdev = tz.build_segment_pack_device(tdev_dom, K=K, dtype=tdt,
                                        dither=dither)
    assert torch.equal(tup.seg_planes, tdev.seg_planes)
    assert (tup.scales is None) == (tdev.scales is None)
    if tup.scales is not None:
        assert torch.equal(tup.scales, tdev.scales)
    # JAX's upload builder
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jup = jz.build_segment_pack_upload(jd, K=K, dtype=jdt,
                                           plane_batch=PB, dither=dither)
    _meta_equal(tup, jup)
    if tier == "f32":
        _per_channel_close(_np(tup.seg_planes), _jnp(jup.seg_planes), K)
    elif tier == "bf16":
        np.testing.assert_array_equal(_np(tup.seg_planes),
                                      _jnp(jup.seg_planes))
    else:
        _codes_close(tup.seg_planes.numpy(), np.asarray(jup.seg_planes),
                     tier == "int4")
    if tup.scales is not None:
        _scales_close(tup.scales.numpy(), np.asarray(jup.scales))


@pytest.mark.parametrize("axis,tier", [("x", "int4"), ("y", "int8"),
                                       ("x", "bf16")])
def test_upload_cuts_batches_along_each_probing_axis(domains, axis, tier):
    """Volumes where the fill runs are cut batch by batch along the probing
    axis (no padded copy): the pack equals the device build's along x and
    y too, the first, last and past-the-grid planes included."""
    _, td = domains
    d = ScalarDomain(x=td.x.numpy(), y=td.y.numpy(), z=td.z.numpy(),
                     inv_brems=True, phaseshift=True, B_on=True,
                     probing_direction=axis, device="cpu")
    for name in ("ne", "Te", "Z", "B"):
        setattr(d, name, getattr(td, name))
    dither = None if tier == "bf16" else 5
    up = tz.build_segment_pack_upload(d, K=K, dtype=TIERS[tier][1],
                                      plane_batch=PB, dither=dither)
    ref = tz.build_segment_pack_device(d, K=K, dtype=TIERS[tier][1],
                                       dither=dither)
    assert torch.equal(up.seg_planes, ref.seg_planes)
    if ref.scales is not None:
        assert torch.equal(up.scales, ref.scales)


def test_upload_dither_keys_and_guards(domains):
    _, td = domains
    a = tz.build_segment_pack_upload(td, K=K, dtype="int4", plane_batch=PB,
                                     dither=11)
    b = tz.build_segment_pack_upload(td, K=K, dtype="int4", plane_batch=PB,
                                     dither=jax.random.PRNGKey(11))
    c = tz.build_segment_pack_upload(td, K=K, dtype="int4", plane_batch=PB,
                                     dither=12)
    assert torch.equal(a.seg_planes, b.seg_planes)
    assert not torch.equal(a.seg_planes, c.seg_planes)
    for kw, err in (({"plane_batch": 5}, "divide"),
                    ({"plane_batch": 3, "dtype": "int4"}, "even"),
                    ({"dtype": torch.float32, "dither": 1}, "quantised")):
        with pytest.raises(ValueError, match=err):
            tz.build_segment_pack_upload(td, **{"K": K, "dtype": "int4",
                                                **kw})


def test_host_volumes_are_refused_by_whole_volume_builders():
    """On a card, external_*(host=True) keeps a (pinned) CPU tensor, and
    the builders that read the whole volume on the card refuse it; on a
    CPU domain host and device are one."""
    from synthpy_tpu_torch.fields.domain import build_pack

    ne = np.ones((9, 9, 9), np.float32)
    d = ScalarDomain(1e-2, 9, device="cpu").external_ne(ne, host=True)
    assert d.ne.device.type == "cpu"
    build_pack(d)   # the same device: allowed
    d.device = torch.device("meta")   # a card's domain, ne on the host
    for fn in (lambda: build_pack(d),
               lambda: tz.build_segment_pack_device(d, K=8)):
        with pytest.raises(ValueError, match="host"):
            fn()


@pytest.mark.parametrize("tier,dither", [
    ("f32", None), ("int8", None), ("int8", 11), ("int4", None),
    ("int4", 11)])
def test_synth_within_envelope(domains, tier, dither):
    jd, td = domains
    jdt, tdt = TIERS[tier]
    dsyn = convert.domain(JDomain(2 * EXT, N), "cpu")
    dsyn.inv_brems = dsyn.phaseshift = dsyn.B_on = True
    syn = tz.build_segment_pack_synth(dsyn, scene(torch), K=K, dtype=tdt,
                                      plane_batch=PB, dither=dither)
    up = tz.build_segment_pack_upload(td, K=K, dtype=tdt, plane_batch=PB,
                                      dither=dither)
    jsyn_dom = JDomain(2 * EXT, N)
    jsyn_dom.inv_brems = jsyn_dom.phaseshift = jsyn_dom.B_on = True
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsyn = jz.build_segment_pack_synth(jsyn_dom, scene(jnp), K=K,
                                           dtype=jdt, plane_batch=PB,
                                           dither=dither)
    _meta_equal(syn, jsyn)
    for ref in (up, jsyn):
        a_ref = (_np(ref.seg_planes) if isinstance(ref.seg_planes,
                                                   torch.Tensor)
                 else _jnp(ref.seg_planes))
        a_syn = _np(syn.seg_planes)
        if tier == "f32":
            colmax = np.abs(a_ref).max(axis=(0, 1))
            phase = (np.arange(a_ref.shape[-1]) % 8 == PHASE) * PHASE_ATOL
            np.testing.assert_array_less(
                np.abs(a_ref - a_syn),
                2e-5 * np.abs(a_ref) + 1e-5 * colmax + phase + 1e-30)
            continue
        if tier == "int4":
            a_ref, a_syn = _nibbles(a_ref), _nibbles(a_syn)
        d16 = a_ref.astype(np.int16) - a_syn.astype(np.int16)
        assert (d16 != 0).mean() < 0.01, (d16 != 0).mean()
        assert np.abs(d16).max() <= 1
        _scales_close(syn.scales.numpy(), np.asarray(ref.scales), 1e-5)


def test_synth_errors_match_jax_and_default_closures():
    d = ScalarDomain(1e-2, 17, phaseshift=True, device="cpu")
    jd = JDomain(1e-2, 17, phaseshift=True)
    for port, jax_ in ((d, jd),):
        with pytest.raises(ValueError):
            jz.build_segment_pack_synth(jax_)
        with pytest.raises(ValueError, match="fields dict"):
            tz.build_segment_pack_synth(port)
        port.inv_brems = jax_.inv_brems = True
        f_j = {"ne": lambda x, y, z: 1e23 + 0.0 * (x + y + z)}
        with pytest.raises(RuntimeError):
            jz.build_segment_pack_synth(jax_, f_j)
        with pytest.raises(RuntimeError, match="Te"):
            tz.build_segment_pack_synth(port, {"ne": f_j["ne"]})
        port.inv_brems = False
        port.B_on = True
        with pytest.raises(RuntimeError, match="'B'"):
            tz.build_segment_pack_synth(port, {"ne": f_j["ne"]})
    # the closed forms of a test field are the default closures, and a
    # converted JAX test field's
    lens = ScalarDomain(1e-2, 17, device="cpu").test_lens()
    a = tz.build_segment_pack_synth(lens, K=8, dtype=torch.float32)
    b = tz.build_segment_pack_device(lens, K=8, dtype=torch.float32)
    conv = convert.domain(JDomain(1e-2, 17).test_lens(), "cpu")
    c = tz.build_segment_pack_synth(conv, K=8, dtype=torch.float32)
    e = tz.build_segment_pack_device(conv, K=8, dtype=torch.float32)
    for syn, dev in ((a, b), (c, e)):
        colmax = dev.seg_planes.abs().amax(dim=(0, 1))
        assert bool(((syn.seg_planes - dev.seg_planes).abs()
                     <= 2e-5 * dev.seg_planes.abs() + 1e-5 * colmax).all())


@pytest.mark.parametrize("device", [True, False])
@pytest.mark.parametrize("tier", ["f32", "int8"])
def test_streaming_matches_jax_and_upload(domains, tier, device):
    jd, td = domains
    jdt, tdt = TIERS[tier]
    ts = tz.build_segment_pack_streaming(td, K=K, dtype=tdt, plane_batch=5,
                                         device=device)
    assert ts.host == (not device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = jz.build_segment_pack_streaming(jd, K=K, dtype=jdt,
                                             plane_batch=5, device=device)
    assert isinstance(js.seg_planes, np.ndarray) == (not device)
    _meta_equal(ts, js)
    if tier == "f32":
        _per_channel_close(_np(ts.seg_planes), _jnp(js.seg_planes), K)
    else:
        np.testing.assert_array_equal(_np(ts.seg_planes),
                                      _jnp(js.seg_planes))
        _scales_close(ts.scales.numpy(), np.asarray(js.scales))
    up = tz.build_segment_pack_upload(td, K=K, dtype=tdt, plane_batch=PB)
    assert torch.equal(ts.seg_planes, up.seg_planes)
    # the JAX host form carries across as a port host pack
    if not device:
        carried = convert.segment_pack(js, "cpu")
        assert carried.host and carried.seg_planes.device.type == "cpu"
    with pytest.raises(ValueError, match="f32, bf16 or int8"):
        tz.build_segment_pack_streaming(td, K=K, dtype="int4")


@pytest.mark.parametrize("tier", ["bf16", "int8", "int4"])
def test_save_load_round_trip_and_cross_load(tmp_path, tier):
    jdt, tdt = TIERS[tier]
    jd = JDomain(1e-2, 17).test_lens(ne_0=1e25, LR=2e-3)
    td = convert.domain(jd, "cpu")
    tp = tz.build_segment_pack_device(td, K=8, dtype=tdt, dither=(
        None if tier == "bf16" else 3))
    path = str(tmp_path / "port.npz")
    tz.save_segment_pack(path, tp)
    back = tz.load_segment_pack(path, on="cpu")
    assert torch.equal(back.seg_planes, tp.seg_planes)
    assert back._replace(seg_planes=None, scales=None,
                         origin_ab=None, inv_spacing_ab=None) == \
        tp._replace(seg_planes=None, scales=None, origin_ab=None,
                    inv_spacing_ab=None)
    host = tz.load_segment_pack(path, device=False, on="cpu")
    assert host.host
    # the port's file in JAX, and JAX's file in the port
    jl = jz.load_segment_pack(path)
    np.testing.assert_array_equal(_jnp(jl.seg_planes), _np(tp.seg_planes))
    assert (jl.K, jl.n_slabs, jl.qbits, jl.dp) == (tp.K, tp.n_slabs,
                                                   tp.qbits, tp.dp)
    jp = jz.build_segment_pack_device(jd, K=8, dtype=jdt, dither=(
        None if tier == "bf16" else 3))
    jpath = str(tmp_path / "jax.npz")
    jz.save_segment_pack(jpath, jp)
    tl = tz.load_segment_pack(jpath, on="cpu")
    np.testing.assert_array_equal(_np(tl.seg_planes), _jnp(jp.seg_planes))
    if jp.scales is not None:
        np.testing.assert_array_equal(tl.scales.numpy(),
                                      np.asarray(jp.scales))
    assert (tl.shape_ab, tl.K, tl.n_slabs, tl.qbits) == (
        tuple(jp.shape_ab), jp.K, jp.n_slabs, jp.qbits)


def test_cached_build(tmp_path):
    cache = str(tmp_path / "cache")
    d1 = ScalarDomain(1e-2, 17, device="cpu").test_lens(ne_0=1e25, LR=2e-3)
    a = tz.cached_build_segment_pack(d1, cache, K=8, dtype=torch.int8)
    assert len(os.listdir(cache)) == 1
    d2 = ScalarDomain(1e-2, 17, device="cpu").test_lens(ne_0=1e25, LR=2e-3)
    b = tz.cached_build_segment_pack(d2, cache, K=8, dtype=torch.int8)
    assert len(os.listdir(cache)) == 1 and torch.equal(a.seg_planes,
                                                       b.seg_planes)
    tz.cached_build_segment_pack(d2, cache, K=8, dtype="int4")
    tz.cached_build_segment_pack(d2, cache, K=8, dtype="int4", dither=5)
    assert len(os.listdir(cache)) == 3
    h = tz.cached_build_segment_pack(d2, cache, K=8, dtype="int4",
                                     dither=5, device=False)
    assert h.host


def test_suggest_pack_dtype_matches_jax():
    d_lens = JDomain(1e-2, 65).test_lens(ne_0=5e24, LR=1.5e-3)
    _, f = grf_domain_fft(jax.random.PRNGKey(0), power_law(-11.0 / 3.0),
                          l_max=2e-3, l_min=4e-4, extent=5e-3, res=32)
    d_turb = JDomain(1e-2, 64)
    d_turb.external_ne(1e23 * (1.0 + 0.5 * jnp.asarray(f)))
    for jd in (d_lens, d_turb):
        ja = jz.suggest_pack_dtype(jd)
        ta = tz.suggest_pack_dtype(convert.domain(jd, "cpu"))
        assert (ta["name"], ta["dither"], ta["chi"], ta["est_rel_err"]) == (
            ja["name"], ja["dither"], ja["chi"], ja["est_rel_err"])
        assert ta["dtype"] == tz.PACK_DTYPES[ta["name"]]
    assert tz.suggest_pack_dtype(convert.domain(d_turb, "cpu"))[
        "name"] == "int4"
