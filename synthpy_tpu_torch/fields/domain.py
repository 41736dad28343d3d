"""Scene state: the gridded plasma domain and its trace-ready packing.

Port of ``synthpy_tpu.fields.domain`` (main-path subset): ``ScalarDomain``
with per-axis coordinates, the analytic test fields and external-field
loading; ``ChannelLayout``, ``TracePack``, ``build_pack``, ``layout_of``
and ``peak_ne_over_nc``. Fields live on the domain's device as tensors;
ne may also be a ``parallel.Sharded`` split over a mesh (``external_ne``),
which the sharded pack build reads shard by shard and which ``ne`` gathers
for everything else.
The ``test_*`` fields also set ``domain.analytic``, the closed forms of the
pack-free analytic march (``fields.forms``).
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from synthpy_tpu_torch import _device, constants
from synthpy_tpu_torch.fields.forms import ClosedForm

AXES = ("x", "y", "z")


def _as_triple(v, name: str) -> Tuple:
    if isinstance(v, (int, float)):
        return (v, v, v)
    v = tuple(v)
    if len(v) != 3:
        raise ValueError(f"{name} must be a scalar or length-3 sequence")
    return v


def linspace(start: float, stop: float, num: int, dtype=torch.float32,
             device="cpu") -> torch.Tensor:
    """``jnp.linspace``'s formula, ``start*(1-t) + stop*t`` at
    ``t = i/(num-1)`` in ``dtype`` with the endpoint exactly ``stop``, so
    the grid agrees with the JAX package's to the last place or so
    (torch.linspace steps from both ends instead)."""
    lo = torch.tensor(start, dtype=dtype, device=device)
    hi = torch.tensor(stop, dtype=dtype, device=device)
    if num == 1:
        return lo.reshape(1)
    div = num - 1
    t = (torch.arange(div, dtype=dtype, device=device)
         / torch.tensor(div, dtype=dtype, device=device))
    return torch.cat([lo * (1 - t) + hi * t, hi.reshape(1)])


def gradient(f: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """``jnp.gradient(f, h, axis=dim)``: central differences inside,
    one-sided at both edges, in the same operation order."""
    n = f.shape[dim]
    hh = torch.tensor(h, dtype=f.dtype, device=f.device)
    upper = (f.narrow(dim, 1, 1) - f.narrow(dim, 0, 1)) / hh
    lower = (f.narrow(dim, n - 1, 1) - f.narrow(dim, n - 2, 1)) / hh
    inner = (f.narrow(dim, 2, n - 2) - f.narrow(dim, 0, n - 2)) * 0.5 / hh
    return torch.cat([upper, inner, lower], dim=dim)


class ScalarDomain:
    """Gridded plasma scene: n_e (+ optional B, Te, Z) on a uniform grid.

    Create from (lengths, dims), with coordinates linspace(-L/2, L/2, n)
    per axis, or from explicit uniform coordinate vectors x, y, z.
    ``device`` defaults to ``"cuda"`` and raises on a host without a card
    unless ``device="cpu"`` is given.
    """

    def __init__(
        self,
        lengths: Union[float, Sequence[float], None] = None,
        dims: Union[int, Sequence[int], None] = None,
        *,
        x=None,
        y=None,
        z=None,
        ne_type: Optional[str] = None,
        inv_brems: bool = False,
        phaseshift: bool = False,
        B_on: bool = False,
        probing_direction: str = "z",
        dtype=torch.float32,
        device="cuda",
    ):
        if probing_direction not in AXES:
            raise ValueError("probing_direction must be 'x', 'y' or 'z'")
        self.device = _device.resolve(device)
        self.dtype = dtype
        if x is not None:
            self.x, self.y, self.z = (
                torch.as_tensor(np.array(c), dtype=dtype,
                                device=self.device) for c in (x, y, z))
            cs = [np.asarray(c, np.float64) for c in (x, y, z)]
            self.lengths = tuple(float(c[-1]) - float(c[0]) for c in cs)
            self.dims = tuple(int(c.shape[0]) for c in cs)
        else:
            if lengths is None or dims is None:
                raise ValueError("pass (lengths, dims) or explicit x/y/z")
            self.lengths = tuple(float(v)
                                 for v in _as_triple(lengths, "lengths"))
            self.dims = tuple(int(v) for v in _as_triple(dims, "dims"))
            self.x, self.y, self.z = (
                linspace(-L / 2, L / 2, n, dtype, self.device)
                for L, n in zip(self.lengths, self.dims))
        self.inv_brems = inv_brems
        self.phaseshift = phaseshift
        self.B_on = B_on
        self.probing_direction = probing_direction

        self.ne = None          # a tensor or a parallel.Sharded
        self.B: Optional[torch.Tensor] = None
        self.Te: Optional[torch.Tensor] = None
        self.Z: Optional[torch.Tensor] = None
        # closed-form closures of the analytic march (tracer.analytic):
        # {"ne": f(x, y, z), optional "B", "Te", "Z"}, torch closures. The
        # test_* fields set ClosedForms, which the kernel K7 evaluates;
        # external grids clear it.
        self.analytic: Optional[dict] = None

        if ne_type is not None:
            generator = getattr(self, ne_type, None)
            if generator is None:
                raise ValueError(f"unknown ne_type {ne_type!r}")
            generator()

    # -- the density -------------------------------------------------------

    @property
    def ne(self) -> Optional[torch.Tensor]:
        """The electron density, a tensor on the domain's device, or None.
        A sharded ne (``external_ne`` of a ``parallel.Sharded``) is kept
        sharded in ``ne_stored``, and reading ``ne`` gathers it whole onto
        the domain's device, afresh at every read, as XLA moves a sharded
        array into a single-device program. This is the one place where a
        single-device builder or solver meets a sharded ne; the sharded
        routes (``build_segment_pack_device(mesh=)``, ``pipeline.run(mesh=,
        grid_axis=)``) and ``peak_ne_over_nc`` read ``ne_stored`` and never
        gather it."""
        v = self._ne
        return v if v is None or isinstance(v, torch.Tensor) else v.gather(
            self.device)

    @ne.setter
    def ne(self, v) -> None:
        self._ne = v

    @property
    def ne_stored(self):
        """ne as it is held: a tensor, a ``parallel.Sharded`` or None (read
        without moving data)."""
        return self._ne

    # -- geometry ----------------------------------------------------------

    @property
    def probe_axis(self) -> int:
        return AXES.index(self.probing_direction)

    @property
    def extent(self) -> float:
        """Half-length along the probing axis [m] (the exit-plane coord)."""
        return float((self.x, self.y, self.z)[self.probe_axis][-1])

    def _mesh(self, *needed: str):
        grids = {
            "x": self.x[:, None, None],
            "y": self.y[None, :, None],
            "z": self.z[None, None, :],
        }
        return tuple(grids[n] for n in needed)

    def _fill(self, f: torch.Tensor) -> torch.Tensor:
        return f.expand(*self.dims).to(self.dtype).contiguous()

    # -- analytic test fields ----------------------------------------------

    def test_null(self):
        """Empty cube: rays pass undeflected."""
        self.ne = torch.zeros(self.dims, dtype=self.dtype,
                              device=self.device)
        self.analytic = {"ne": ClosedForm("null")}
        return self

    def test_slab(self, s: float = 1.0, ne_0: float = 2e23):
        """Linear x-gradient slab: deflects rays in x."""
        (X,) = self._mesh("x")
        self.ne = self._fill(ne_0 * (1.0 + s * X / self.extent))
        self.analytic = {"ne": ClosedForm("slab", ne_0=ne_0, s=s,
                                          ext=self.extent)}
        return self

    def test_linear_cos(self, s1: float = 0.1, s2: float = 0.1,
                        ne_0: float = 2e23, Ly: float = 1.0):
        """Linearly growing sinusoid."""
        X, Y = self._mesh("x", "y")
        self.ne = self._fill(ne_0 * (1.0 + s1 * X / self.extent) * (
            1.0 + s2 * torch.cos(2 * np.pi * Y / Ly)))
        self.analytic = {"ne": ClosedForm("linear_cos", ne_0=ne_0, s1=s1,
                                          ext=self.extent, s2=s2, Ly=Ly)}
        return self

    def test_exponential_cos(self, ne_0: float = 1e24, Ly: float = 1e-3,
                             s: float = 2e-3):
        """Exponentially growing sinusoid."""
        X, Y = self._mesh("x", "y")
        self.ne = self._fill(ne_0 * torch.pow(10.0, X / s)
                             * (1.0 + torch.cos(2 * np.pi * Y / Ly)))
        self.analytic = {"ne": ClosedForm("exponential_cos", ne_0=ne_0, s=s,
                                          Ly=Ly)}
        return self

    def test_lens(self, ne_0: float = 1e24, LR: float = 1e-3):
        """Gaussian column along z: a plasma lens."""
        X, Y = self._mesh("x", "y")
        self.ne = self._fill(ne_0 * torch.exp(-(X**2 + Y**2) / LR**2))
        self.analytic = {"ne": ClosedForm("lens", ne_0=ne_0, LR=LR)}
        return self

    def test_liner(self, ne_0: float = 1e24, LR: float = 1e-3):
        """Gaussian column along y."""
        X, Z = self._mesh("x", "z")
        self.ne = self._fill(ne_0 * torch.exp(-(X**2 + Z**2) / LR**2))
        self.analytic = {"ne": ClosedForm("liner", ne_0=ne_0, LR=LR)}
        return self

    def test_B(self, Bmax: float = 1.0):
        """Bz with a linear x-gradient."""
        (X,) = self._mesh("x")
        B = torch.zeros((*self.dims, 3), dtype=self.dtype,
                        device=self.device)
        B[..., 2] = (Bmax * X / self.extent).expand(*self.dims)
        self.B = B
        self.B_on = True
        if self.analytic is not None:
            self.analytic = dict(self.analytic)
            self.analytic["B"] = ClosedForm("bz_linear", Bmax=Bmax,
                                            ext=self.extent)
        return self

    # -- external field loading ----------------------------------------------

    def _as_field(self, v, host: bool = False) -> torch.Tensor:
        """``v`` as a tensor of the domain's dtype: on the domain's device,
        or with ``host=True`` a CPU tensor, pinned when the domain is on a
        card (fields larger than the card: the scale pack builders copy
        them up plane batch by plane batch)."""
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v))
        if not host or self.device.type == "cpu":
            return v.to(device=self.device, dtype=self.dtype)
        v = v.to(device="cpu", dtype=self.dtype)
        return v if v.is_pinned() else v.pin_memory()

    def external_ne(self, ne, host: bool = False):
        """Load an electron-density grid of shape ``dims``; a gridded field
        replaces any closed form (``analytic`` becomes None). ``host=True``
        keeps it in (pinned) host memory: for fields larger than the card,
        which ``tracer.zscan.build_segment_pack_upload`` and
        ``build_segment_pack_streaming`` read batch by batch; the builders
        that read the whole volume on the card refuse it. A
        ``parallel.Sharded`` ne (``grf_domain_fft(mesh=)``) stays sharded,
        each block on its shard's device, in the domain's dtype (see
        ``ne``)."""
        from synthpy_tpu_torch.parallel.mesh import Sharded

        if isinstance(ne, Sharded):
            if host:
                raise ValueError("a sharded ne stays on its shards' "
                                 "devices; host=True does not apply")
            self.ne = ne.map(lambda s: s.to(self.dtype))
        else:
            self.ne = self._as_field(ne, host)
        self.analytic = None
        if tuple(self._ne.shape) != tuple(self.dims):
            raise ValueError(
                f"ne shape {tuple(self._ne.shape)} != grid dims {self.dims}")
        return self

    def external_B(self, B, host: bool = False):
        self.B = self._as_field(B, host)
        self.B_on = True
        self.analytic = None
        return self

    def external_Te(self, Te, Te_min: float = 1.0, host: bool = False):
        if not isinstance(Te, torch.Tensor):
            Te = torch.from_numpy(np.array(Te))
        self.Te = self._as_field(torch.clamp_min(Te.to(self.dtype), Te_min),
                                 host)
        self.analytic = None
        return self

    def external_Z(self, Z, host: bool = False):
        self.Z = self._as_field(Z, host)
        self.analytic = None
        return self

    def build_pack(self, lwl: float = constants.DEFAULT_LWL) -> "TracePack":
        return build_pack(self, lwl)


class ChannelLayout(NamedTuple):
    """Static description of what lives in each pack channel."""

    inv_brems: bool
    phaseshift: bool
    B_on: bool

    @property
    def n_channels(self) -> int:
        return 3 + self.inv_brems + self.phaseshift + 3 * self.B_on

    @property
    def kappa_index(self) -> int:
        return 3

    @property
    def phase_index(self) -> int:
        return 3 + self.inv_brems

    @property
    def faraday_index(self) -> int:
        return 3 + self.inv_brems + self.phaseshift


class TracePack(NamedTuple):
    """channels: (nx, ny, nz, C): the 3 acceleration components
    (-c^2/2 * d(ne/nc)/dx_i), then optionally kappa [1/s],
    omega*(n-1) [rad/s] and Verdet*ne*B. Geometry is host-side numpy."""

    channels: torch.Tensor
    origin: np.ndarray
    inv_spacing: np.ndarray
    omega: float


def build_pack(domain: ScalarDomain,
               lwl: float = constants.DEFAULT_LWL,
               dtype=None,
               ne_max: float | None = None) -> TracePack:
    """Precompute the packed RHS channel grid for a domain (central
    differences inside, one-sided at the boundary, as numpy.gradient)."""
    if domain.ne is None:
        raise RuntimeError("domain has no electron density")
    if host_resident(domain):
        raise ValueError(
            "build_pack needs the fields on the domain's device; ne is "
            "host-resident (external_ne(host=True)): build a segment pack "
            "with build_segment_pack_upload or build_segment_pack_streaming")
    omega = float(constants.omega_from_lwl(lwl))
    nc = float(constants.critical_density(omega))
    # divided by a tensor: PyTorch on CUDA divides by a Python scalar
    # through its reciprocal, which moves half the values by an ulp
    ne_nc = domain.ne / torch.tensor(nc, dtype=domain.ne.dtype,
                                     device=domain.ne.device)
    if ne_max is not None:
        ne_nc = torch.clamp_max(ne_nc, ne_max)
    cs = [c.cpu().numpy() for c in (domain.x, domain.y, domain.z)]
    spacings = [float(c[1] - c[0]) for c in cs]
    chans = [(-0.5 * constants.C**2) * gradient(ne_nc, h, d)
             for d, h in enumerate(spacings)]
    if domain.inv_brems:
        if domain.Te is None or domain.Z is None:
            raise RuntimeError("inv_brems requires Te and Z grids")
        chans.append(constants.kappa(domain.ne, domain.Te, domain.Z, omega))
    if domain.phaseshift:
        chans.append(omega * (constants.n_refrac(domain.ne, omega) - 1.0))
    if domain.B_on:
        if domain.B is None:
            raise RuntimeError("B_on requires a B grid")
        verdet = constants.verdet_constant(lwl)
        for i in range(3):
            chans.append(verdet * domain.ne * domain.B[..., i])
    channels = torch.stack([c.to(dtype or domain.dtype) for c in chans],
                           dim=-1)
    np_dt = cs[0].dtype
    origin = np.stack([c[0] for c in cs]).astype(np_dt)
    inv_spacing = np.stack([1.0 / (c[1] - c[0]) for c in cs]).astype(np_dt)
    return TracePack(channels, origin, inv_spacing, omega)


def host_resident(domain: ScalarDomain) -> bool:
    """True when the domain's ne stays in host memory for a domain on a
    card (``external_ne(host=True)``)."""
    ne = domain.ne_stored
    return (isinstance(ne, torch.Tensor) and ne.device.type == "cpu"
            and domain.device.type != "cpu")


def layout_of(domain: ScalarDomain) -> ChannelLayout:
    return ChannelLayout(domain.inv_brems, domain.phaseshift, domain.B_on)


def peak_ne_over_nc(domain: ScalarDomain,
                    lwl: float = constants.DEFAULT_LWL) -> float:
    """max(ne)/nc for the probe wavelength, or 0.0 if ne was freed.

    The critical-density guard of ``pipeline.run`` reads it: the z-scan
    march divides by v_p, which is ill-conditioned near turning points.
    Memoised per (ne tensor, lwl), so repeated runs on one field read the
    device once. A sharded ne is reduced shard by shard, never gathered.
    """
    ne = domain.ne_stored
    if ne is None:
        return 0.0
    cached = getattr(domain, "_peak_cache", None)
    if cached is not None:
        ref, clwl, val = cached
        if ref() is ne and clwl == float(lwl):
            return val
    nc = float(constants.critical_density(constants.omega_from_lwl(lwl)))
    peak = (float(ne.max()) if isinstance(ne, torch.Tensor)
            else max(float(s.max()) for s in ne.shards))
    frac = peak / nc
    domain._peak_cache = (weakref.ref(ne), float(lwl), frac)
    return frac
