"""X-ray radiography (``synthpy_tpu_torch.optics.xray``) against the JAX
package on the same inputs, on the CPU (kernels K15 and K16 run their
plain versions here), and the JAX package's own gates
(tests/test_xray.py) on the port as ``test_port_*``.

Port against JAX: within 2e-5 relative, the JAX package's own bound for a
streamed image against its dense one. The two sides round the same
operations except the library ``log`` / ``exp`` and the order of XLA's
plane sums (observed <= 5.2e-7 of the largest value). The fused
``OpacityLookup`` route and the PyTorch closure route agree to 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.io.eos import read_propaceos as jread_propaceos
from synthpy_tpu.optics import xray as jx
from synthpy_tpu_torch import convert
from synthpy_tpu_torch.io import read_propaceos
from synthpy_tpu_torch.kernels import xray as kx
from synthpy_tpu_torch.optics import xray as tx

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

REL = 2e-5


def _close(j, t, rel=REL):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.shape == t.shape
    err = np.abs(j - t).max() / np.abs(j).max()
    assert err <= rel, err


def _power_law_table(n_T=12, n_rho=15, aT=-1.5, ar=0.5, k0=3.0):
    T = np.logspace(0, 3, n_T)
    rho = np.logspace(-6, -1, n_rho)
    table = k0 * np.outer(T ** aT, rho ** ar)
    return T, rho, table, lambda t, r: k0 * t ** aT * r ** ar


def _lookups(**kw):
    T, rg, table, _ = _power_law_table(**kw)
    return (jx.make_opacity_lookup(T, rg, table),
            tx.make_opacity_lookup(T, rg, table, device="cpu"))


def _random_scene(n=25, seed=11):
    rng = np.random.default_rng(seed)
    rho = (1e-3 * (1.0 + 0.5 * rng.random((n, n, n)))).astype(np.float32)
    Te = (50.0 * (1.0 + rng.random((n, n, n)))).astype(np.float32)
    return rho, Te


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


PP = dict(source_distance=0.1, detector_distance=0.3, bins=(41, 31),
          Lx=6.0, Ly=4.5)


# -- the port against JAX ---------------------------------------------------

@pytest.mark.parametrize("log_space", [True, False])
def test_torch_opacity_lookup_matches_jax(log_space):
    T, rg, table, _ = _power_law_table()
    jk = jx.make_opacity_lookup(T, rg, table, log_space=log_space)
    tk = tx.make_opacity_lookup(T, rg, table, log_space=log_space,
                                device="cpu")
    rng = np.random.default_rng(0)
    # inside, below and above the table on both axes, and rho = 0
    qt = np.exp(rng.uniform(np.log(T[0]) - 1, np.log(T[-1]) + 1, 4096))
    qr = np.exp(rng.uniform(np.log(rg[0]) - 1, np.log(rg[-1]) + 1, 4096))
    qr[:16] = 0.0
    qt, qr = qt.astype(np.float32), qr.astype(np.float32)
    _close(jk(qt, qr), tk(_t(qt), _t(qr)), 1e-6)
    # the converted lookup carries JAX's own log tables (XLA's log, which
    # the port's make_opacity_lookup meets within an ulp)
    conv = convert.opacity_lookup(jk, device="cpu")
    free = dict(zip(jk.__code__.co_freevars,
                    (c.cell_contents for c in jk.__closure__)))
    for name in ("lt", "lr", "vals"):
        np.testing.assert_array_equal(getattr(conv, name).numpy(),
                                      np.asarray(free[name]))
    assert conv.log_space == log_space
    _close(jk(qt, qr), conv(_t(qt), _t(qr)), 1e-6)
    with pytest.raises(ValueError, match="make_opacity_lookup"):
        convert.opacity_lookup(lambda t, r: t, device="cpu")


@pytest.mark.parametrize("log_space", [True, False])
@pytest.mark.parametrize("te_special", ["nan", "inf", "-inf", "zero",
                                        "first", "last", "below"])
def test_torch_lookup_plain_special_queries_match_jax(te_special, log_space):
    """The contract the kernels' lookup is held to (C.13):
    ``kernels.xray.lookup_plain`` against JAX's ``make_opacity_lookup`` on
    NaN, +-inf, zero and edge Te, each beside every such rho: NaN exactly
    where JAX's is NaN (a NaN Te or rho), the rest within 1e-6 of JAX's
    largest finite value and infinite where JAX's is."""
    T, rg, table, _ = _power_law_table()
    jk = jx.make_opacity_lookup(T, rg, table, log_space=log_space)
    tab = tx.make_opacity_lookup(T, rg, table, log_space=log_space,
                                 device="cpu").table("cpu")
    f32 = np.float32
    special = {"nan": np.nan, "inf": np.inf, "-inf": -np.inf, "zero": 0.0,
               "first": f32(T[0]), "last": f32(T[-1]),
               "below": np.nextafter(f32(T[0]), f32(0))}
    r_vals = np.array([np.nan, np.inf, -np.inf, 0.0, rg[0], rg[-1],
                       np.nextafter(f32(rg[0]), f32(0)), 1e-3, 1e3],
                      dtype=f32)
    te = np.full(r_vals.shape, special[te_special], dtype=f32)
    want = np.asarray(jk(te, r_vals))
    got = kx.lookup_plain(tab, _t(te), _t(r_vals)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    # a NaN rho, and a NaN Te with any rho, give NaN
    assert np.isnan(got[0]) and np.isnan(got).all() == (te_special == "nan")
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    if fin.any():
        assert np.abs(got[fin] - want[fin]).max() <= 1e-6 * np.abs(
            want[fin]).max()


@pytest.mark.parametrize("probe", ["x", "y", "z"])
def test_torch_dense_images_match_jax(probe):
    jk, tk = _lookups()
    rho, Te = _random_scene()
    ax = np.linspace(-2e-3, 2e-3, 25, dtype=np.float32)
    sp = float(ax[1] - ax[0])
    jr, jT = jnp.asarray(rho), jnp.asarray(Te)
    _close(jx.attenuation_image(jr, jT, jk, sp, probe),
           tx.attenuation_image(_t(rho), _t(Te), tk, sp, probe))
    _close(jx.self_emission_image(jr, jT, jx.grey_emissivity(jk), sp,
                                  probe),
           tx.self_emission_image(_t(rho), _t(Te), tx.grey_emissivity(tk),
                                  sp, probe))
    for n_steps in (64, 160):
        _close(jx.point_projection_radiograph(
            jr, jT, jk, [jnp.asarray(ax)] * 3, n_steps=n_steps,
            probing_direction=probe, **PP),
            tx.point_projection_radiograph(_t(rho), _t(Te), tk, [ax] * 3,
                                           n_steps=n_steps,
                                           probing_direction=probe, **PP))


@pytest.mark.parametrize("probe", ["x", "y", "z"])
def test_torch_streamed_images_match_jax(probe):
    jk, tk = _lookups()
    rho, Te = _random_scene()
    ax = np.linspace(-2e-3, 2e-3, 25, dtype=np.float32)
    sp = float(ax[1] - ax[0])
    kw = dict(probing_direction=probe, plane_batch=7)
    js = jx.xray_survey_streamed(rho, Te, jk, (ax,) * 3,
                                 emiss_fn=jx.grey_emissivity(jk), **kw, **PP)
    ts = tx.xray_survey_streamed(rho, Te, tk, (ax,) * 3,
                                 emiss_fn=tx.grey_emissivity(tk),
                                 device="cpu", **kw, **PP)
    assert set(js) == set(ts)
    for k in js:
        _close(js[k], ts[k])
    jt, je = jx.radiography_streamed(rho, Te, jk, sp, probe,
                                     emiss_fn=jx.grey_emissivity(jk),
                                     plane_batch=7)
    tt, te = tx.radiography_streamed(rho, Te, tk, sp, probe,
                                     emiss_fn=tx.grey_emissivity(tk),
                                     plane_batch=7, device="cpu")
    _close(jt, tt)
    _close(je, te)
    _close(jx.point_projection_radiograph_streamed(rho, Te, jk, (ax,) * 3,
                                                   **kw, **PP),
           tx.point_projection_radiograph_streamed(rho, Te, tk, (ax,) * 3,
                                                   device="cpu", **kw,
                                                   **PP))


@pytest.mark.parametrize("probe", ["y", "z"])
def test_torch_closure_route_matches_lookup_route(probe):
    """A callable that is not an ``OpacityLookup`` (and an emissivity that
    is not the grey one of the same lookup) is evaluated in PyTorch; the
    kernels fold it. Both routes agree to 1e-6."""
    _, tk = _lookups()
    rho, Te = _random_scene(n=21, seed=3)
    ax = np.linspace(-2e-3, 2e-3, 21, dtype=np.float32)
    sp = float(ax[1] - ax[0])

    def closure(t, r):
        return tk(t, r)

    def emiss(t, r):
        t2 = t * t
        return tk(t, r) * r * (t2 * t2)

    R, T = _t(rho), _t(Te)
    _close(tx.attenuation_image(R, T, tk, sp, probe),
           tx.attenuation_image(R, T, closure, sp, probe), 1e-6)
    _close(tx.self_emission_image(R, T, tx.grey_emissivity(tk), sp, probe),
           tx.self_emission_image(R, T, emiss, sp, probe), 1e-6)
    _close(tx.self_emission_image(R, T, tx.grey_emissivity(tk), sp, probe),
           tx.self_emission_image(R, T, tx.grey_emissivity(closure), sp,
                                  probe), 1e-6)
    _close(tx.point_projection_radiograph(R, T, tk, [ax] * 3,
                                          probing_direction=probe, **PP),
           tx.point_projection_radiograph(R, T, closure, [ax] * 3,
                                          probing_direction=probe, **PP),
           1e-6)
    kw = dict(probing_direction=probe, plane_batch=6, device="cpu")
    a = tx.xray_survey_streamed(rho, Te, tk, (ax,) * 3,
                                emiss_fn=tx.grey_emissivity(tk), **kw, **PP)
    b = tx.xray_survey_streamed(rho, Te, closure, (ax,) * 3,
                                emiss_fn=emiss, **kw, **PP)
    for k in a:
        _close(a[k], b[k], 1e-6)
    _close(tx.point_projection_radiograph_streamed(rho, Te, tk, (ax,) * 3,
                                                   **kw, **PP),
           tx.point_projection_radiograph_streamed(rho, Te, closure,
                                                   (ax,) * 3, **kw, **PP),
           1e-6)


def test_torch_routes_are_chosen_by_type(monkeypatch):
    """Each function goes by its own type: an ``OpacityLookup`` kappa and a
    ``grey_emissivity`` of an ``OpacityLookup`` take K15's table mode, so
    no plain PyTorch lookup runs, also when the two differ (a second
    lookup, or a kappa or emissivity that is a closure); a closure runs in
    PyTorch. Each mixed pairing agrees with the all-closure route to 1e-6,
    the bound between the two routes."""
    _, tk = _lookups()
    _, other = _lookups(k0=4.0)
    *_, law = _power_law_table()
    assert tx._lookup_of(tx.grey_emissivity(tk)) is tk
    assert tx._lookup_of(tx.grey_emissivity(law)) is None
    assert tx._lookup_of(tk) is None and tx._lookup_of(None) is None

    def via_torch(fn):
        return lambda t, r: fn(t, r)

    def grey_law(t, r):
        calls.append(1)
        t2 = t * t
        return law(t, r) * r * (t2 * t2)

    calls = []
    rho, Te = _random_scene(n=17, seed=5)
    ax = np.linspace(-2e-3, 2e-3, 17, dtype=np.float32)
    kw = dict(probing_direction="y", plane_batch=6, device="cpu", **PP)
    pairs = [(tk, tx.grey_emissivity(other), via_torch(tk),
              tx.grey_emissivity(via_torch(other))),
             (tk, grey_law, via_torch(tk), grey_law),
             (law, tx.grey_emissivity(tk), law,
              tx.grey_emissivity(via_torch(tk)))]
    refs = [tx.xray_survey_streamed(rho, Te, k, (ax,) * 3, emiss_fn=e,
                                    **kw)
            for _, _, k, e in pairs]
    monkeypatch.setattr(tx.OpacityLookup, "__call__", None)
    for (k, e, _, _), ref in zip(pairs, refs):
        calls.clear()
        out = tx.xray_survey_streamed(rho, Te, k, (ax,) * 3, emiss_fn=e,
                                      **kw)
        assert len(calls) == (3 if e is grey_law else 0)   # 17 planes / 6
        for key in ref:
            _close(ref[key], out[key], 1e-6)


def test_torch_an_explicit_device_takes_the_volumes(monkeypatch):
    """``device`` given: the volumes go there and the kernels run there,
    tensors included; ``device=None``: tensors stay where they are. The
    "meta" device stands in for the card, and the kernels' launches are
    recorded instead of run."""
    from synthpy_tpu_torch.kernels import _build

    _, tk = _lookups()
    rho, Te = _random_scene(n=9)
    R, T = _t(rho), _t(Te)
    ax = np.linspace(-2e-3, 2e-3, 9, dtype=np.float32)
    sp = float(ax[1] - ax[0])
    seen = []
    monkeypatch.setattr(
        _build.Kernel, "launch",
        lambda self, name, device, *args: seen.append(
            (name, torch.device(device).type)))
    calls = [
        ("xray_fold", lambda d: tx.attenuation_image(R, T, tk, sp,
                                                     device=d)),
        ("xray_fold", lambda d: tx.self_emission_image(
            R, T, tx.grey_emissivity(tk), sp, device=d)),
        ("pp_chords", lambda d: tx.point_projection_radiograph(
            R, T, tk, [ax] * 3, n_steps=8, device=d, **PP)),
    ]
    for name, call in calls:
        seen.clear()
        assert call(None).device.type == "cpu" and seen == []
        assert call("meta").device.type == "meta"
        assert seen == [(name, "meta")]


def test_torch_fold_scratch_is_w():
    """K15's scratch holds each batch's w = kappa rho, which K16 folds."""
    _, tk = _lookups()
    rho, Te = _random_scene(n=9)
    R, T = _t(rho)[2:6], _t(Te)[2:6]
    w = torch.zeros(R.shape)
    tau = torch.zeros(R.shape[1:])
    kx.fold(R, T, mode=0, table=tk.table("cpu"), w0=False, wlast=False,
            tau=tau, em=None, wout=w)
    torch.testing.assert_close(w, tk(T, R) * R, rtol=0, atol=0)
    torch.testing.assert_close(tau, w.sum(0), rtol=1e-6, atol=0)


def test_torch_read_propaceos_is_jaxs(tmp_path):
    n_temp, n_dens, n_groups = 10, 20, 9
    temps = np.linspace(1, 100, n_temp)
    dens = np.logspace(16, 20, n_dens)
    groups = np.linspace(0.1, 10, n_groups + 1)
    zf = np.arange(n_temp * n_dens, dtype=float).reshape(n_temp, n_dens)

    def lines10(vals):
        vals = list(vals)
        return [" ".join(f"{v:.6e}" for v in vals[i:i + 10])
                for i in range(0, len(vals), 10)]

    content = ["header"] * 38 + [str(n_temp)] + lines10(temps)
    content += [str(n_dens)] + lines10(dens)
    content += ["skip"] * (n_temp // 10 + n_dens // 10 + 2 + 5)
    content += [str(n_groups), "skip"] + lines10(groups) + ["ZF table"]
    for t in range(n_temp):
        content += lines10(zf[t])
    fname = str(tmp_path / "prp")
    with open(fname, "w") as f:
        f.write("\n".join(content) + "\n")
    want = jread_propaceos(fname, need_zf_table=True)
    got = read_propaceos(fname, need_zf_table=True)
    assert set(got) == set(want)
    for k, v in want.items():
        if v is None:
            assert got[k] is None
        else:
            np.testing.assert_array_equal(got[k], v)


# -- the JAX package's gates (tests/test_xray.py) on the port ---------------

def test_port_opacity_lookup_power_law_exact():
    T, rho, table, exact = _power_law_table()
    kfn = tx.make_opacity_lookup(T, rho, table, device="cpu")
    rng = np.random.default_rng(0)
    qt = np.exp(rng.uniform(np.log(T[0]), np.log(T[-1]), 64))
    qr = np.exp(rng.uniform(np.log(rho[0]), np.log(rho[-1]), 64))
    np.testing.assert_allclose(kfn(_t(qt), _t(qr)).numpy(), exact(qt, qr),
                               rtol=2e-5)


def test_port_opacity_lookup_clamps_to_edges():
    T, rho, table, exact = _power_law_table()
    kfn = tx.make_opacity_lookup(T, rho, table, device="cpu")
    np.testing.assert_allclose(
        kfn(_t([T[0] * 1e-3, T[-1] * 1e3]), _t([rho[5], rho[5]])).numpy(),
        [exact(T[0], rho[5]), exact(T[-1], rho[5])], rtol=2e-5)
    assert np.isfinite(float(kfn(_t(10.0), _t(0.0))))


def test_port_opacity_lookup_linear_space_passthrough():
    T = np.array([1.0, 10.0, 100.0])
    rho = np.array([1e-4, 1e-2])
    table = np.array([[0.0, 1.0], [2.0, 3.0], [4.0, 5.0]])
    kfn = tx.make_opacity_lookup(T, rho, table, log_space=False,
                                 device="cpu")
    np.testing.assert_allclose(float(kfn(_t(T[1]), _t(rho[0]))), 2.0,
                               rtol=1e-6)


def test_port_opacity_lookup_shape_mismatch_and_nonpositive_grids():
    with pytest.raises(ValueError):
        tx.make_opacity_lookup(np.ones(3), np.ones(4), np.ones((4, 3)),
                               device="cpu")
    with pytest.raises(ValueError):
        tx.make_opacity_lookup(np.array([0.0, 1.0, 10.0]),
                               np.array([1e-3, 1e-2]), np.ones((3, 2)),
                               device="cpu")


def _uniform_scene(n=16, rho0=1e-3, Te0=50.0, spacing=1e-4):
    return (torch.full((n, n, n), rho0), torch.full((n, n, n), Te0),
            spacing)


def test_port_attenuation_uniform_slab_beer_lambert():
    rho, Te, ds = _uniform_scene()
    kappa0 = 7.5
    img = tx.attenuation_image(rho, Te, lambda t, r: torch.full_like(
        t, kappa0), ds, probing_direction="z")
    L_cm = (rho.shape[2] - 1) * ds * 100.0
    assert img.shape == (16, 16)
    np.testing.assert_allclose(img.numpy(), np.exp(-kappa0 * 1e-3 * L_cm),
                               rtol=1e-5)


def test_port_attenuation_axis_selection():
    n = 8
    rho = torch.zeros((n, n, n))
    rho[n // 2:] = 1e-3
    Te = torch.full((n, n, n), 10.0)

    def kfn(t, r):
        return torch.ones_like(t)

    img_z = tx.attenuation_image(rho, Te, kfn, 1e-4, "z").numpy()
    assert np.all(img_z[: n // 2] == 1.0) and np.all(img_z[n // 2:] < 1.0)
    img_x = tx.attenuation_image(rho, Te, kfn, 1e-4, "x").numpy()
    assert np.all(img_x < 1.0)


def test_port_self_emission_uniform_grey():
    rho, Te, ds = _uniform_scene(rho0=2e-3, Te0=30.0)
    kappa0 = 4.0
    img = tx.self_emission_image(rho, Te, tx.grey_emissivity(
        lambda t, r: torch.full_like(t, kappa0)), ds, probing_direction="y")
    L_cm = (rho.shape[1] - 1) * ds * 100.0
    np.testing.assert_allclose(img.numpy(),
                               kappa0 * 2e-3 * 30.0 ** 4 * L_cm, rtol=1e-4)


def _ball_scene(n=48, half=2e-3, R=6e-4, rho0=5e-3):
    ax = np.linspace(-half, half, n)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    r2 = X ** 2 + Y ** 2 + Z ** 2
    rho = _t(np.where(r2 <= R ** 2, rho0, 0.0))
    Te = torch.full((n, n, n), 20.0)
    return rho, Te, [_t(ax)] * 3


def _const(k):
    return lambda t, r: torch.full_like(t, k)


def test_port_point_projection_centre_chord_and_magnification():
    R, rho0, kappa0, half = 6e-4, 5e-3, 50.0, 2e-3
    rho, Te, coords = _ball_scene(half=half, R=R, rho0=rho0)
    sd, dd = 10e-3, 50e-3
    bins, Lx = (201, 7), 20.0
    img = tx.point_projection_radiograph(rho, Te, _const(kappa0), coords,
                                         sd, dd, bins=bins, Lx=Lx, Ly=2.0,
                                         n_steps=256).numpy()
    assert img.shape == bins
    tau_c = -np.log(img[bins[0] // 2, bins[1] // 2])
    np.testing.assert_allclose(tau_c, kappa0 * rho0 * 2 * R * 100.0,
                               rtol=0.04)
    M = (sd + 2 * half + dd) / (sd + half)
    tau_row = -np.log(img[:, bins[1] // 2])
    xs = (np.arange(bins[0]) + 0.5) / bins[0] * Lx - Lx / 2
    hit = xs[tau_row > 0.5 * tau_c.max()]
    np.testing.assert_allclose((hit.max() - hit.min()) / 2,
                               np.sqrt(3) / 2 * M * R * 1e3, rtol=0.06)
    assert img[0, bins[1] // 2] > 0.999


def test_port_point_projection_with_propaceos_style_table():
    rho, Te, coords = _ball_scene(n=24)
    T_grid, rho_grid, table, _ = _power_law_table(aT=0.0, ar=0.0, k0=25.0)
    kfn = tx.make_opacity_lookup(T_grid, rho_grid, table, device="cpu")
    kw = dict(bins=(41, 5), Lx=20.0, Ly=2.0, n_steps=64)
    img_tab = tx.point_projection_radiograph(rho, Te, kfn, coords, 10e-3,
                                             50e-3, **kw).numpy()
    img_const = tx.point_projection_radiograph(rho, Te, _const(25.0),
                                               coords, 10e-3, 50e-3,
                                               **kw).numpy()
    np.testing.assert_allclose(img_tab, img_const, rtol=1e-4)


def test_port_point_projection_offcenter_grid_same_framing():
    rho, Te, coords = _ball_scene(n=32)
    kw = dict(bins=(41, 5), Lx=20.0, Ly=2.0, n_steps=64)
    img_c = tx.point_projection_radiograph(rho, Te, _const(40.0), coords,
                                           10e-3, 50e-3, **kw).numpy()
    shifted = [c + 2e-3 for c in coords]
    img_s = tx.point_projection_radiograph(rho, Te, _const(40.0), shifted,
                                           10e-3, 50e-3, **kw).numpy()
    np.testing.assert_allclose(img_s, img_c, rtol=1e-5, atol=1e-6)
    assert img_c.min() < 0.99


def test_port_point_projection_rejects_single_step():
    rho, Te, coords = _ball_scene(n=8)
    with pytest.raises(ValueError):
        tx.point_projection_radiograph(rho, Te, lambda t, r: t, coords,
                                       1e-3, 1e-3, bins=(3, 3), n_steps=1)


def test_port_radiography_streamed_matches_dense():
    T, rho_g, table, _ = _power_law_table()
    kfn = tx.make_opacity_lookup(T, rho_g, table, device="cpu")
    jfn = tx.grey_emissivity(kfn)
    rng = np.random.default_rng(7)
    n = 23
    rho = (1e-3 * (1.0 + 0.5 * rng.random((n, n, n)))).astype(np.float32)
    Te = (50.0 * (1.0 + rng.random((n, n, n)))).astype(np.float32)
    sp = 1e-4
    for pd in ("z", "x"):
        dense_t = tx.attenuation_image(_t(rho), _t(Te), kfn, sp, pd)
        dense_e = tx.self_emission_image(_t(rho), _t(Te), jfn, sp, pd)
        st_t, st_e = tx.radiography_streamed(rho, Te, kfn, sp, pd,
                                             emiss_fn=jfn, plane_batch=5,
                                             device="cpu")
        np.testing.assert_allclose(st_t.numpy(), dense_t.numpy(), rtol=2e-5)
        np.testing.assert_allclose(st_e.numpy(), dense_e.numpy(), rtol=2e-5)
    only = tx.radiography_streamed(rho, Te, kfn, sp, plane_batch=23,
                                   device="cpu")
    np.testing.assert_allclose(only.numpy(), tx.attenuation_image(
        _t(rho), _t(Te), kfn, sp, "z").numpy(), rtol=2e-5)


def test_port_point_projection_streamed_matches_dense_quadrature():
    T, rho_g, table, _ = _power_law_table()
    kfn = tx.make_opacity_lookup(T, rho_g, table, device="cpu")
    n, ext = 33, 2e-3
    x = np.linspace(-ext, ext, n, dtype=np.float32)
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    rho = (2e-2 * np.exp(-(X**2 + Y**2 + Z**2) / (1e-3) ** 2)
           + 1e-4).astype(np.float32)
    Te = np.full((n,) * 3, 80.0, np.float32)
    for pd in ("z", "y"):
        dense = tx.point_projection_radiograph(
            _t(rho), _t(Te), kfn, (x, x, x), n_steps=4 * n,
            probing_direction=pd, **PP).numpy()
        streamed = tx.point_projection_radiograph_streamed(
            rho, Te, kfn, (x, x, x), probing_direction=pd, plane_batch=9,
            device="cpu", **PP).numpy()
        assert np.abs(np.log(streamed) - np.log(dense)).max() < 0.02
        streamed2 = tx.point_projection_radiograph_streamed(
            rho, Te, kfn, (x, x, x), probing_direction=pd, plane_batch=33,
            device="cpu", **PP).numpy()
        np.testing.assert_allclose(streamed2, streamed, rtol=2e-5)


def test_port_xray_survey_single_pass_matches_individual_streams():
    """One pass feeds all three images, bit for bit what the
    single-diagnostic streams give."""
    T, rho_g, table, _ = _power_law_table()
    kfn = tx.make_opacity_lookup(T, rho_g, table, device="cpu")
    jfn = tx.grey_emissivity(kfn)
    rho, Te = _random_scene()
    x = np.linspace(-2e-3, 2e-3, 25, dtype=np.float32)
    sp = float(x[1] - x[0])
    for pd in ("z", "x"):
        kw = dict(probing_direction=pd, plane_batch=7, device="cpu")
        out = tx.xray_survey_streamed(rho, Te, kfn, (x, x, x), emiss_fn=jfn,
                                      **kw, **PP)
        st_t, st_e = tx.radiography_streamed(rho, Te, kfn, sp, pd,
                                             emiss_fn=jfn, plane_batch=7,
                                             device="cpu")
        pp = tx.point_projection_radiograph_streamed(rho, Te, kfn,
                                                     (x, x, x), **kw, **PP)
        assert torch.equal(out["transmission"], st_t)
        assert torch.equal(out["emission"], st_e)
        assert torch.equal(out["point_projection"], pp)
    out = tx.xray_survey_streamed(rho, Te, kfn, (x, x, x), device="cpu",
                                  **PP)
    assert set(out) == {"transmission", "point_projection"}
