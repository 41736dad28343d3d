"""Differentiable diagnostics: ``torch.autograd`` through field -> trace ->
image (PyTorch port of ``synthpy_tpu.inverse``).

The forward model, electron density grid -> gradient pack -> segmented rk4
slab march -> composed ABCD optics -> detector, is differentiable end to
end, so an experimental image can be inverted for the density with
gradient descent:

- the pack chain (``build_pack`` -> ``make_zscan_pack`` ->
  ``make_segment_pack``) is kernel K19's autograd Function
  (``kernels.pack_chain.SegPlanes``), which saves only ``ne``: the forward
  and its adjoint each one launch, where the JAX package recomputes the
  chain under ``jax.checkpoint`` in the backward pass;
- the march is ``trace_zscan_segments``' autograd Function: kernel K1
  forward, kernel K11 (``kernels.march_adjoint``) backward;
- ``apply_stages_weighted``: apertures and stops multiply a per-ray
  transmission weight in {0, 1} instead of NaN-killing the rays, so the
  rays stay differentiable;
- ``cic_image`` / ``cic_intensity_image``: cloud-in-cell deposits, linear
  in the ray positions piecewise (kernel K12, ``kernels.cic``, forward and
  adjoint), where histogram binning has no derivative.

Usage::

    render = make_renderer(domain, s0, bins=(64, 48))
    image = render(ne)
    g, = torch.autograd.grad(loss(render(ne)), ne)
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence, Tuple

import torch

from synthpy_tpu_torch.fields.domain import ScalarDomain, layout_of
from synthpy_tpu_torch.kernels import pack_chain
from synthpy_tpu_torch.kernels.cic import cic
from synthpy_tpu_torch.optics import rtm
from synthpy_tpu_torch.optics.compose import (BENCHES, NEEDS_JONES,
                                              advance_phase, analyser_weight,
                                              interfere_ref_beam)
from synthpy_tpu_torch.optics.rtm import m_to_mm
from synthpy_tpu_torch.tracer.propagator import _AXIS_OF, ray_to_Jonesvector
from synthpy_tpu_torch.tracer.zscan import (reassemble_state,
                                            segment_pack_metadata,
                                            trace_zscan_segments)

__all__ = ["apply_stages_weighted", "cic_image", "cic_intensity_image",
           "make_renderer", "make_multiview_renderers"]


def apply_stages_weighted(r: torch.Tensor, stages: Sequence[Tuple],
                          E: Optional[torch.Tensor] = None,
                          wavelength: Optional[float] = None):
    """Apply composed optics stages, tracking a transmission weight.

    The matrices of ``optics.compose.apply_stages``, but filters multiply
    a per-ray weight instead of NaN-killing coordinates. Returns (rays
    (4, N), weight (N,)), or (rays, E, weight) with a Jones vector ``E``
    (2, N): phase checkpoints then advance E by e^{ik path} as
    ``apply_stages`` does, with the safe norm (0, not NaN, for a ray that
    did not move; ``wavelength`` [m] required)."""
    w = torch.ones(r.shape[1], dtype=r.dtype, device=r.device)
    r_mark = r

    def keep(mask):
        return w * mask.to(r.dtype)

    for st in stages:
        kind = st[0]
        if kind == "matrix":
            r = rtm.matvec(st[1], r)
        elif kind == "mark":
            r_mark = r
        elif kind == "phase":
            if E is not None:
                E = advance_phase(E, r, r_mark, wavelength)
            r_mark = r
        elif kind == "aperture":
            w = keep(r[0] ** 2 + r[2] ** 2 <= st[1] ** 2)
        elif kind == "stop":
            w = keep(r[0] ** 2 + r[2] ** 2 > st[1] ** 2)
        elif kind == "rect":
            # rtm.rect_aperture's corner clip: only rays outside both
            # half-widths die
            w = keep(~((r[0] ** 2 > st[1] ** 2) & (r[2] ** 2 > st[2] ** 2)))
        elif kind == "knife":
            # ("knife", offset, axis, direction): rtm.knife_edge kills
            # r > offset for direction > 0
            offset, axis, direction = st[1], st[2], st[3]
            row = 0 if axis == "x" else 2
            w = keep(r[row] <= offset if direction > 0 else r[row] >= offset)
        else:
            raise ValueError(f"unknown stage {kind!r}")
    if E is not None:
        return r, E, w
    return r, w


def cic_image(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
              bins: Tuple[int, int], Lx: float, Ly: float) -> torch.Tensor:
    """Differentiable detector: cloud-in-cell density deposit of the
    weights ``w`` onto the pixel centres of [-Lx/2, Lx/2] x [-Ly/2, Ly/2]
    [mm]; the (ny, nx) image (kernel K12)."""
    return cic(x, y, w[:, None], bins, Lx, Ly)[..., 0].T


def cic_intensity_image(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                        E: torch.Tensor, bins: Tuple[int, int], Lx: float,
                        Ly: float) -> torch.Tensor:
    """Differentiable coherent detector: the real and imaginary parts of
    both Jones components, weighted by ``w``, deposited cloud-in-cell as
    four channels (kernel K12), then I = |sum Ex|^2 + |sum Ey|^2 per
    pixel; the (ny, nx) image."""
    chans = torch.stack([E[0].real, E[0].imag, E[1].real, E[1].imag], 1)
    acc = cic(x, y, chans * w[:, None], bins, Lx, Ly)
    I = (acc[..., 0] ** 2 + acc[..., 1] ** 2 + acc[..., 2] ** 2
         + acc[..., 3] ** 2)
    return I.T


def make_renderer(
    domain: ScalarDomain,
    s0: torch.Tensor,
    *,
    diagnostic="shadowgraphy",
    bins: Tuple[int, int] = (64, 48),
    lwl: float = 1064e-9,
    K: int = 16,
    L: float = 400.0,
    R: float = 25.0,
    Lx: float = 18.0,
    Ly: float = 13.5,
    focal_plane: float = 0.0,
    probing_depth: Optional[float] = None,
    n_fringes: float = 10.0,
    deg: float = 20.0,
    pol_beta_deg: float = 85.0,
    remat: bool = True,
    pack_dtype=None,
    bench_kwargs: Optional[dict] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Build ``render(ne) -> image``, differentiable with respect to ne.

    ``domain`` gives the static geometry (grid coordinates, probing
    direction, physics switches); ``s0`` is the (9, N) ray bundle on the
    domain's device. Every call builds the segment pack from its ``ne``
    (kernel K19 forward; its adjoint in the backward pass, which keeps
    only ``ne``) and marches it with K = ``K`` slabs a segment;
    ``pack_dtype`` (e.g. ``torch.bfloat16``) down-casts the traced tables,
    the arithmetic staying float32.

    Incoherent benches deposit transmission weights (``cic_image``);
    coherent ones (interferometry, refractometry_coherent) need
    ``domain.phaseshift``, carry the Jones vector through the phase
    checkpoints, add the tilted reference beam for interferometry
    (``n_fringes``, ``deg``) and deposit |sum E|^2
    (``cic_intensity_image``); "phase_map" is the transmission-weighted
    mean traced phase per pixel through the interferometry lens train;
    polarimetry folds the analyser weight at ``pol_beta_deg`` into the
    deposit. ``diagnostic`` may be a tuple of bench names: the bundle is
    traced once and ``render`` returns a tuple of images in that order.
    ``bench_kwargs`` maps a bench name to overrides of its stage builder.

    ``remat`` is accepted so that JAX callers run unchanged: the march's
    backward recomputes each segment from its start state either way
    (``trace_zscan_segments``), so both values give the same gradient.
    """
    multi = not isinstance(diagnostic, str)
    names = tuple(diagnostic) if multi else (diagnostic,)
    needs_phase = [n == "phase_map" or BENCHES[n][1] for n in names]
    any_coherent = any(BENCHES[n][1] or n in NEEDS_JONES
                       for n in names if n != "phase_map")
    if any(needs_phase) and not domain.phaseshift:
        raise ValueError(f"{names} includes a phase-carrying bench: "
                         "requires domain.phaseshift=True (the trace "
                         "must accumulate refractive phase)")
    geom = copy.copy(domain)
    layout = layout_of(domain)
    depth = domain.extent if probing_depth is None else probing_depth
    pd = domain.probing_direction
    p_ax = _AXIS_OF[pd]
    a_ax, b_ax = [a for a in range(3) if a != p_ax]
    bk = bench_kwargs or {}
    all_stages = [
        BENCHES["interferometry" if n == "phase_map" else n][0](
            L=L, R=R, focal_plane=focal_plane, **bk.get(n, {}))
        for n in names]
    u0 = torch.stack([s0[a_ax], s0[b_ax], s0[3 + a_ax], s0[3 + b_ax],
                      s0[3 + p_ax], s0[6], s0[7], s0[8]], dim=1)
    sp0 = segment_pack_metadata(geom, lwl, K=K)
    n_seg0 = -(-sp0.n_slabs // K)
    p_end = sp0.p0 + n_seg0 * sp0.K * sp0.dp

    spec = pack_chain.chain_spec(geom, lwl, K=K, pack_dtype=pack_dtype)

    def render(ne: torch.Tensor):
        """Differentiable forward model: ne volume -> detector image(s)."""
        planes = pack_chain.seg_planes(ne, spec)
        uf = trace_zscan_segments(
            u0, planes, sp0.origin_ab, sp0.inv_spacing_ab, sp0.dp,
            shape_ab=sp0.shape_ab, layout=layout, K=sp0.K, n_seg=n_seg0,
            remat=remat)
        sf = reassemble_state(uf, p_end, pd)
        rf, Jf = ray_to_Jonesvector(sf, depth, probing_direction=pd,
                                    return_E=any_coherent)
        r_mm = m_to_mm(rf)
        images = []
        for name, stages in zip(names, all_stages):
            if name == "phase_map":
                # deposit w * phi and w with one footprint; the division
                # is regularised by 1e-3 of one ray's weight, so unsampled
                # pixels go to 0 and the backward jacobian stays bounded
                # (a tiny epsilon overflows 1/den^2 on sliver pixels and
                # inf * 0 poisons the gradient with NaN)
                r_out, w = apply_stages_weighted(r_mm, stages)
                acc = cic(r_out[0], r_out[2], torch.stack([w * sf[7], w], 1),
                          bins, Lx, Ly)
                num, den = acc[..., 0].T, acc[..., 1].T
                images.append(num / (den + 1e-3))
            elif BENCHES[name][1]:
                E = Jf
                if name == "interferometry":
                    E = interfere_ref_beam(r_mm, E, n_fringes, deg)
                r_out, E_out, w = apply_stages_weighted(
                    r_mm, stages, E=E, wavelength=lwl)
                images.append(cic_intensity_image(
                    r_out[0], r_out[2], w, E_out, bins, Lx, Ly))
            elif name in NEEDS_JONES:
                wp = analyser_weight(Jf, pol_beta_deg)
                r_out, w = apply_stages_weighted(r_mm, stages)
                images.append(cic_image(r_out[0], r_out[2], w * wp, bins,
                                        Lx, Ly))
            else:
                r_out, w = apply_stages_weighted(r_mm, stages)
                images.append(cic_image(r_out[0], r_out[2], w, bins, Lx,
                                        Ly))
        return tuple(images) if multi else images[0]

    return render


def make_multiview_renderers(domain: ScalarDomain, beams: dict,
                             **renderer_kwargs) -> dict:
    """Renderers of one volume for several probing directions: each entry
    of ``beams`` maps a direction ('x', 'y', 'z') to its (9, N) bundle, and
    the result maps it to a ``make_renderer`` closure over a copy of
    ``domain`` probing along that axis. All closures take the same ``ne``,
    so a joint loss over the views is differentiable in one volume."""
    renders = {}
    for view, s0 in beams.items():
        g = copy.copy(domain)
        g.probing_direction = view
        renders[view] = make_renderer(g, s0, **renderer_kwargs)
    return renders
