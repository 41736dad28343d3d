"""K19: the differentiable renderer's pack chain, forward and adjoint.

The chain maps an ``ne`` volume (nx, ny, nz) to the segment tables the
renderer marches: ``build_pack`` (ne/nc, its ``jnp.gradient`` along every
axis times -c^2/2, one-sided at both ends of every axis; kappa, the phase
channel omega (n - 1) and Verdet ne B as the layout asks) ->
``make_zscan_pack`` (probe-major planes, the gradient and Faraday channels
in (a, b, p) order, an optional bf16 cast) -> ``make_segment_pack``
(K-slab segments, border planes in both neighbours, zero pad planes):
``seg_planes`` (n_seg, na*nb, (K+1) C), entry [s, a*nb + b, k*C + c]
channel c of plane s*K + k at cell (a, b). It replaces the JAX package's
``_seg_planes`` under ``jax.checkpoint`` (``synthpy_tpu/inverse.py:288``)
and its VJP.

``SegPlanes`` is a ``torch.autograd.Function`` that saves only ``ne``: on
CUDA tensors its forward launches ``pack_chain_forward`` and its backward
``pack_chain_adjoint`` of ``csrc/pack_chain.cu``, each over the launch
plan ``plan`` gives (tiles of cells along b, chunks of a segment's planes,
runs of rows along a, the grid and shared bytes); on CPU tensors it runs
``seg_planes_plain`` (the chain above, unchanged) and
``seg_planes_vjp_plain`` (the adjoint written out in the kernel's gather
form: each ne cell sums the table cotangents of its own plane position and
its stencil neighbours, both copies of a border plane, and the pointwise
channels' derivatives). Te, Z and B are constants of the chain (``spec``);
only ne gets a gradient.

Rounding: the plain forward divides (ne by a tensor nc, the differences by
a tensor h), bit-equal to the JAX package's chain run op by op; JAX's
jitted chain multiplies by the float32 reciprocals of nc and h instead
(XLA folds a division by a constant; found by emulating both on the CPU),
which moves about half the gradient values by an ulp. The kernel follows
the plain version (``__fdiv_rn``, ``__float2bfloat16_rn``).

The derivatives are 0, never NaN, where the chain is flat or clamped: the
phase channel beyond the critical density (n_refrac's double ``where``), the
kappa channel's Coulomb logarithm where it is floored at 2 or where
``max(omega_pe, omega)`` takes omega (ne = 0 included, where autograd of
the plain chain gives 0 * inf).
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Tuple

import torch

from synthpy_tpu_torch import constants
from synthpy_tpu_torch.fields.domain import (ChannelLayout, ScalarDomain,
                                             build_pack, layout_of)
from synthpy_tpu_torch.kernels._build import F, I, P, Kernel

# the geometry (4 pointers, 10 ints), then the plan's TB, PB and AR
_ARGS = [P, P, P, P] + [I] * 10 + [I] * 3
KERNEL = Kernel("pack_chain.cu", {
    "pack_chain_forward": _ARGS + [F, F, F, F, F, F, F, F, P, P],
}, flags=["--fmad=false"], helpers={"pack_chain_smem": [I] * 6})
BACKWARD_KERNEL = Kernel("pack_chain.cu", {
    "pack_chain_adjoint": _ARGS + [P, F, F, F, F, F, F, F, F, P, P],
}, flags=["--fmad=false"])

SMEM_MAX = 232448        # a block's shared memory on an H100 (227 KB)
# a block's share of an H100 SM's shared memory at four blocks an SM (228
# KB, 1 KB of it each block's own)
SMEM_QUARTER = 233472 // 4 - 1024
# the plan's defaults: cells a tile (forward, adjoint) and rows a run
FORWARD_TB, ADJOINT_TB, RUN_ROWS = 23, 16, 16


class Plan(NamedTuple):
    """K19's launch plan: a block owns a tile of ``TB`` cells along b and a
    chunk of ``PB`` planes of one segment, and walks a run of ``AR`` rows
    along a. ``pack_chain.cu`` derives the rest from it (``plan_of``: the
    staged rows' pitch, the grid and the shared bytes) and refuses a plan
    that does not fit the card."""

    TB: int
    PB: int
    AR: int


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def plan_smem(kind: str, TB: int, PB: int, C: int, K: int,
              tbytes: int = 4) -> int:
    """A block's shared bytes, the model by which ``plan`` picks PB (the
    kernel computes its own, ``pack_chain.cu`` smem_of, exported as
    ``pack_chain_smem``): the forward's four staged rows of ne / nc and
    three of ne as copied, (TB + 2) x ((PB + 2) | 1) floats each; the
    adjoint's, each region from a 16-byte boundary, a staged plane's
    sources (two table offsets and a border index), a staged cell's
    offset, a ring of four rows of table slots as copied (C
    ``tbytes``-byte values each), its rows' second copies of their border
    planes ((PB + 1) // K + 1 at most) and its border planes as float32
    sums."""
    sp, sc = PB + 2, TB + 2
    if kind == "forward":
        return 7 * sc * (sp | 1) * 4
    B, nbx = C * tbytes, (PB + 1) // K + 1
    return (2 * _up16(8 * sp) + _up16(4 * sp) + _up16(4 * sc)
            + _up16(4 * sc * sp * B) + _up16(4 * sc * nbx * B)
            + 4 * sc * nbx * C * 4)


def plan(kind: str, na: int, nb: int, K: int, C: int, tbytes: int = 4,
         TB: Optional[int] = None, PB: Optional[int] = None,
         AR: Optional[int] = None) -> Plan:
    """The launch plan of the ``kind`` ("forward" or "adjoint") kernel for
    na x nb cells, K, C channels and a table of ``tbytes``-byte values (2
    for bf16; the adjoint copies them): TB (default ``FORWARD_TB``, or
    ``ADJOINT_TB`` halved, down to 4, while the adjoint's ring of a whole
    segment takes more than ``SMEM_QUARTER``: four blocks an SM, 16 cells
    a tile for 8-byte slots, 8 for 16-byte and 4 for 32-byte ones at K =
    64) at most nb, AR
    (``RUN_ROWS``) at most na, PB at most the K + 1 slots of a segment; by
    default the most whose shared bytes fit ``SMEM_MAX``, evened out over
    the chunks."""
    if kind not in ("forward", "adjoint"):
        raise ValueError(f"no K19 kernel {kind!r}")
    if TB is None and kind == "adjoint":
        TB = ADJOINT_TB
        while TB > 4 and plan_smem(kind, TB, K + 1, C, K,
                                   tbytes) > SMEM_QUARTER:
            TB //= 2
    TB = min(TB or FORWARD_TB, nb)
    AR = min(AR or RUN_ROWS, na)
    if PB is None:
        PB = K + 1
        while PB > 1 and plan_smem(kind, TB, PB, C, K, tbytes) > SMEM_MAX:
            PB -= 1
        n_pc = -(-(K + 1) // PB)
        PB = -(-(K + 1) // n_pc)
    PB = min(PB, K + 1)
    if plan_smem(kind, TB, PB, C, K, tbytes) > SMEM_MAX:
        raise ValueError(f"K19's {kind} tile of {TB} cells does not fit "
                         f"{SMEM_MAX} shared bytes at C = {C}")
    return Plan(TB, PB, AR)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_AXIS = {"x": 0, "y": 1, "z": 2}


class ChainSpec(NamedTuple):
    """What the chain holds fixed: the domain (its grid, layout, probing
    direction, and Te, Z, B as constants), the probe wavelength, K and the
    stored dtype of the tables (None: the domain's)."""

    domain: ScalarDomain
    lwl: float
    K: int
    pack_dtype: Optional[torch.dtype]

    @property
    def layout(self) -> ChannelLayout:
        return layout_of(self.domain)

    @property
    def axes(self) -> Tuple[int, int, int]:
        """(p_ax, a_ax, b_ax)."""
        p = _AXIS[self.domain.probing_direction]
        a, b = [d for d in range(3) if d != p]
        return p, a, b


def chain_spec(domain: ScalarDomain, lwl: float = constants.DEFAULT_LWL,
               K: int = 64, pack_dtype=None) -> ChainSpec:
    """The spec of ``domain``'s chain (a shallow copy: a later change of
    the domain's fields does not reach it)."""
    return ChainSpec(copy.copy(domain), float(lwl), int(K), pack_dtype)


def _dims(spec: ChainSpec, ne: torch.Tensor):
    p, a, b = spec.axes
    n = tuple(ne.shape)
    n_p = n[p]
    n_seg = -(-(n_p - 1) // spec.K)
    return n, n_p, n[a], n[b], n_seg


class _Consts(NamedTuple):
    nc: float
    h: Tuple[float, float, float]
    pref: float
    omega: float
    n_coef: float
    verdet: float


def _consts(spec: ChainSpec) -> _Consts:
    """The chain's scalars as Python floats, as ``build_pack`` and
    ``constants`` take them (h from the coordinates in their own type).
    The plain versions round each to the field's type, as PyTorch does a
    Python scalar; the kernels take each rounded to float32."""
    omega = float(constants.omega_from_lwl(spec.lwl))
    nc = float(constants.critical_density(omega))
    d = spec.domain
    cs = [c.cpu().numpy() for c in (d.x, d.y, d.z)]
    h = tuple(float(c[1] - c[0]) for c in cs)
    return _Consts(nc, h, -0.5 * constants.C ** 2, omega,
                   constants.OMEGA_PE_COEFF ** 2 * 1e-6 / omega ** 2,
                   constants.verdet_constant(spec.lwl))


def seg_planes_plain(ne: torch.Tensor, spec: ChainSpec) -> torch.Tensor:
    """Plain version of the forward: ``build_pack`` -> ``make_zscan_pack``
    -> ``make_segment_pack`` of the spec's domain with this ``ne``."""
    from synthpy_tpu_torch.tracer.zscan import (make_segment_pack,
                                                make_zscan_pack)

    g = copy.copy(spec.domain)
    g.ne = ne
    zp = make_zscan_pack(build_pack(g, spec.lwl), spec.layout,
                         g.probing_direction, dtype=spec.pack_dtype)
    return make_segment_pack(zp, K=spec.K).seg_planes


def _plane_cotangents(dseg: torch.Tensor, n_p: int, na: int, nb: int,
                      K: int, C: int, dtype) -> torch.Tensor:
    """(n_p, na, nb, C) cotangents of the probe-major planes: plane
    q = s*K + k reads [s, k] and, at a border (k = 0, s >= 1), adds
    [s - 1, K]; the pad planes past n_p - 1 are dropped."""
    n_seg = dseg.shape[0]
    t = dseg.to(dtype).reshape(n_seg, na, nb, K + 1, C)
    planes = t[:, :, :, :K].permute(0, 3, 1, 2, 4).reshape(
        n_seg * K, na, nb, C)
    planes = torch.cat([planes, t[-1, :, :, K][None]])
    if n_seg > 1:
        border = t[:-1, :, :, K]
        inner = planes[K:n_seg * K:K] + border
        planes = planes.clone()
        planes[K:n_seg * K:K] = inner
    return planes[:n_p]


def _stencil_t(W: torch.Tensor, dim: int) -> torch.Tensor:
    """The transpose of ``jnp.gradient``'s stencil along ``dim`` without
    its 1/h: out[j] = cf[j-1] W[j-1] - cf[j+1] W[j+1], cf 1 at the two
    ends and 0.5 inside; then -W[0] at j = 0 and +W[n-1] at j = n-1."""
    n = W.shape[dim]
    cf = torch.full((n,), 0.5, dtype=W.dtype, device=W.device)
    cf[0] = cf[-1] = 1.0
    shape = [1] * W.dim()
    shape[dim] = n
    Wc = W * cf.reshape(shape)
    zero = torch.zeros_like(W.narrow(dim, 0, 1))
    left = torch.cat([zero, Wc.narrow(dim, 0, n - 1)], dim)
    right = torch.cat([Wc.narrow(dim, 1, n - 1), zero], dim)
    s = left - right
    first = s.narrow(dim, 0, 1) - W.narrow(dim, 0, 1)
    last = s.narrow(dim, n - 1, 1) + W.narrow(dim, n - 1, 1)
    return torch.cat([first, s.narrow(dim, 1, n - 2), last], dim)


def kappa_grad(ne, Te, Z, omega: float):
    """d kappa / d ne (``constants.kappa``) written out: 0 where the
    Coulomb logarithm is floored at 2 or where max(omega_pe, omega) takes
    omega, whose derivative is then 0 (ne = 0 included)."""
    c = constants
    ne_cc = ne * 1e-6
    # PyTorch on a card divides by a Python scalar through its reciprocal
    # (as constants.kappa's ne_cc / omega runs there): so do the plain
    # version, on either device, and the kernel
    r = ne_cc * torch.reciprocal(torch.tensor(omega, dtype=ne.dtype,
                                              device=ne.device))
    o_pe = c.OMEGA_PE_COEFF * torch.sqrt(ne_cc)
    o_max = torch.clamp_min(o_pe, omega)
    L_max = torch.maximum(Z * c.E_CHARGE / Te,
                          c.L_QUANTUM_COEFF / torch.sqrt(Te))
    lg = torch.log(c.v_the(Te) / (o_max * L_max))
    CL = torch.clamp_min(lg, 2.0)
    live = (lg > 2.0) & (o_pe > omega)
    safe = torch.where(live, ne, torch.ones_like(ne))
    dCL = torch.where(live, -0.5 / safe, torch.zeros_like(ne))
    A = c.KAPPA_COEFF * Z * c.C * Te ** (-1.5)
    return A * (2.0 * r * (1e-6 / omega) * CL + r * r * dCL)


def seg_planes_vjp_plain(ne: torch.Tensor, dseg: torch.Tensor,
                         spec: ChainSpec) -> torch.Tensor:
    """Plain version of the adjoint: d ne (ne's shape and type) for the
    table cotangent ``dseg`` (bf16 for a bf16 table), in the kernel's
    gather form and operation order."""
    wd = ne.dtype
    lay = spec.layout
    C = lay.n_channels
    p_ax, a_ax, b_ax = spec.axes
    n, n_p, na, nb, _ = _dims(spec, ne)
    k = _consts(spec)
    P = _plane_cotangents(dseg, n_p, na, nb, spec.K, C, wd)
    inv = [0, 0, 0]
    for i, ax in enumerate((p_ax, a_ax, b_ax)):
        inv[ax] = i
    vol = P.permute(*inv, 3)              # (nx, ny, nz, C)
    chan = {a_ax: 0, b_ax: 1, p_ax: 2}
    df = None
    for d in range(3):
        q = torch.tensor(k.pref / k.h[d], dtype=wd, device=ne.device)
        term = _stencil_t(vol[..., chan[d]], d) * q
        df = term if df is None else df + term
    out = df / torch.tensor(k.nc, dtype=wd, device=ne.device)
    dom = spec.domain
    if lay.inv_brems:
        out = out + vol[..., lay.kappa_index] * kappa_grad(
            ne, dom.Te, dom.Z, k.omega)
    if lay.phaseshift:
        arg = 1.0 - k.n_coef * ne
        pos = arg > 0.0
        root = torch.sqrt(torch.where(pos, arg, torch.ones_like(arg)))
        t = (vol[..., lay.phase_index] * k.omega) / (2.0 * root)
        out = out + torch.where(pos, -t * k.n_coef, torch.zeros_like(t))
    if lay.B_on:
        f = lay.faraday_index
        B = dom.B
        far = (vol[..., f] * B[..., a_ax] + vol[..., f + 1] * B[..., b_ax]
               + vol[..., f + 2] * B[..., p_ax])
        out = out + far * k.verdet
    return out


def _checked(ne: torch.Tensor, spec: ChainSpec):
    """The kernel's inputs: float32 contiguous volumes on ne's card."""
    dom = spec.domain
    lay = spec.layout
    if ne.dtype != torch.float32 or ne.dim() != 3 or min(ne.shape) < 2:
        raise ValueError("the pack chain kernel takes a float32 (nx, ny, "
                         f"nz) ne with every dim >= 2, not {ne.dtype} "
                         f"{tuple(ne.shape)}")
    if dom.dtype != torch.float32 or spec.pack_dtype not in (
            None, torch.float32, torch.bfloat16):
        raise ValueError("the pack chain kernel builds float32 or bf16 "
                         f"tables of a float32 domain, not {dom.dtype} / "
                         f"{spec.pack_dtype}")
    if tuple(ne.shape) != tuple(dom.dims):
        raise ValueError(f"ne {tuple(ne.shape)} is not the domain's grid "
                         f"{tuple(dom.dims)}")

    def vol(t, shape, what):
        if t is None:
            raise RuntimeError(f"the layout needs {what}")
        if (t.device != ne.device or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"{what} must be a float32 {shape} tensor on "
                             "ne's device")
        return t.contiguous()

    shape = tuple(ne.shape)
    te = vol(dom.Te, shape, "Te") if lay.inv_brems else None
    z = vol(dom.Z, shape, "Z") if lay.inv_brems else None
    B = vol(dom.B, shape + (3,), "B") if lay.B_on else None
    return ne.contiguous(), te, z, B


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


_INT_MAX = 2 ** 31 - 1


def _geometry_args(spec: ChainSpec, kind: str, ne, te, z, B):
    """The geometry and the plan, as the kernel takes them: refused here,
    before a launch, where its 32-bit extents and a block's 32-bit offsets
    from its row's first cell (``pack_chain.cu`` geo_of, plan_of) would
    not hold them."""
    lay = spec.layout
    n, n_p, na, nb, n_seg = _dims(spec, ne)
    C = lay.n_channels
    L = plan(kind, na, nb, spec.K, C,
             2 if spec.pack_dtype == torch.bfloat16 else 4)
    p, a, b = spec.axes
    st = (n[1] * n[2], n[2], 1)
    if max(n[1] * n[2], na * nb, nb * (spec.K + 1) * C,
           (L.TB + 1) * st[b] + (L.PB + 1) * st[p]) > _INT_MAX:
        raise ValueError(f"K19 takes no {tuple(n)} volume probed along "
                         f"{'xyz'[p]} at K = {spec.K}, C = {C}: its "
                         "32-bit offsets would overflow")
    return [_ptr(ne), _ptr(te), _ptr(z), _ptr(B), *n, p, spec.K, n_seg,
            int(lay.inv_brems), int(lay.phaseshift), int(lay.B_on),
            _DTYPE_CODE[spec.pack_dtype or torch.float32], *L]


def forward(ne: torch.Tensor, spec: ChainSpec) -> torch.Tensor:
    """The segment tables of ``ne``: the kernel on a CUDA tensor,
    ``seg_planes_plain`` on a CPU tensor."""
    if ne.device.type == "cpu":
        return seg_planes_plain(ne, spec)
    ne, te, z, B = _checked(ne, spec)
    _, _, na, nb, n_seg = _dims(spec, ne)
    C = spec.layout.n_channels
    out = torch.empty((n_seg, na * nb, (spec.K + 1) * C),
                      dtype=spec.pack_dtype or torch.float32,
                      device=ne.device)
    k = _consts(spec)
    KERNEL.launch("pack_chain_forward", ne.device,
                  *_geometry_args(spec, "forward", ne, te, z, B), k.nc,
                  *k.h, k.pref, k.omega, k.n_coef, k.verdet,
                  out.data_ptr())
    return out


def adjoint(ne: torch.Tensor, dseg: torch.Tensor,
            spec: ChainSpec) -> torch.Tensor:
    """d ne for the table cotangent ``dseg``: the kernel on a CUDA tensor,
    ``seg_planes_vjp_plain`` on a CPU tensor."""
    if ne.device.type == "cpu":
        return seg_planes_vjp_plain(ne, dseg, spec)
    ne, te, z, B = _checked(ne, spec)
    _, _, na, nb, n_seg = _dims(spec, ne)
    C = spec.layout.n_channels
    shape = (n_seg, na * nb, (spec.K + 1) * C)
    dt = spec.pack_dtype or torch.float32
    if (dseg.device != ne.device or dseg.dtype != dt
            or tuple(dseg.shape) != shape):
        raise ValueError(f"the table cotangent must be a {dt} {shape} "
                         "tensor on ne's device")
    dseg = dseg.contiguous()
    if dseg.data_ptr() % 16:
        # the kernel reads a slot's channels as aligned vectors: a view
        # off a 16-byte boundary is copied to one of its own
        dseg = dseg.clone()
    dne = torch.empty_like(ne)
    k = _consts(spec)
    q = [k.pref / h for h in k.h]
    BACKWARD_KERNEL.launch("pack_chain_adjoint", ne.device,
                           *_geometry_args(spec, "adjoint", ne, te, z, B),
                           dseg.data_ptr(), k.nc, *q, k.omega, k.n_coef,
                           k.verdet, 1e-6 / k.omega, dne.data_ptr())
    return dne


class SegPlanes(torch.autograd.Function):
    """The chain under autograd, saving only ``ne``: K19's forward and
    adjoint on a card, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, ne, spec):
        ctx.save_for_backward(ne)
        ctx.spec = spec
        return forward(ne, spec)

    @staticmethod
    def backward(ctx, dseg):
        ne, = ctx.saved_tensors
        return adjoint(ne, dseg, ctx.spec), None


def seg_planes(ne: torch.Tensor, spec: ChainSpec) -> torch.Tensor:
    """(n_seg, na*nb, (K+1) C) segment tables of ``ne``, differentiable
    in ne (kernel K19 on a card)."""
    return SegPlanes.apply(ne, spec)
