"""K19's launch plan (``kernels.pack_chain.plan``) and a walk of its tiled
kernels, on the CPU.

``csrc/pack_chain.cu`` takes its plan from the host: a block owns a tile
of TB cells along b and a chunk of PB planes of one segment, and walks a
run of AR rows along a, with a ring of three staged rows in shared memory.
The kernels run only on a card; here:

* on many shapes (odd dims, dims of 2, K that divides n_p - 1 and K that
  pads the last segment, one segment, every probing axis, C = 3, 4, 8,
  1024^3 at C = 4 and 8) the plan's blocks, over the grid the kernel
  derives from the plan and with its index arithmetic, cover every table
  slot (forward) and every ne cell (adjoint) exactly once; a block's
  shared bytes fit 227 KB and the grid the card's limits;
* a PyTorch walk of both kernels, block by block and row by row as they
  step (the plane sources, the clamped staging, the border sums, the pad
  planes, the ring's rotation), is bit-equal to ``seg_planes_plain`` and
  ``seg_planes_vjp_plain``, at the default plan and at plans cut small
  enough to exercise every halo and chunk;
* the wrappers hand the kernels the plan, and refuse before a launch a
  volume whose offsets would overflow the kernels' 32 bits (the "meta"
  device standing in for the card).
"""

import numpy as np
import pytest
import torch

from synthpy_tpu_torch import constants
from synthpy_tpu_torch.fields import ScalarDomain
from synthpy_tpu_torch.kernels import _build
from synthpy_tpu_torch.kernels import pack_chain as pc

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

EXT = 5e-3
LWL = 1064e-9
NC = constants.critical_density(constants.omega_from_lwl(LWL))
LAYOUTS = {3: (False, False, False), 4: (False, True, False),
           8: (True, True, True)}


def domain(dims, probe, C, seed=0):
    """A CPU domain with seeded ne (vacuum, critical and overdense cells
    among them), Te, Z and B, in the layout of C channels."""
    rng = np.random.default_rng(seed)
    ne = (NC * 1.6 * rng.random(dims)).astype(np.float32)
    ne.flat[0] = 0.0
    ne.flat[ne.size // 2] = np.float32(NC)
    ne.flat[-1] = np.float32(3.0 * NC)
    d = ScalarDomain(2 * EXT, dims, probing_direction=probe, device="cpu")
    d.external_ne(torch.from_numpy(ne))
    d.external_Te(torch.from_numpy(
        (20.0 + 40.0 * rng.random(dims)).astype(np.float32)))
    d.external_Z(torch.from_numpy(
        (1.0 + 3.0 * rng.random(dims)).astype(np.float32)))
    d.external_B(torch.from_numpy(
        (5.0 * rng.standard_normal(dims + (3,))).astype(np.float32)))
    d.inv_brems, d.phaseshift, d.B_on = LAYOUTS[C]
    return d, torch.from_numpy(ne)


def geometry(dims, probe, K):
    """The kernel's Geo: (n_p, na, nb), ne's strides (sp, sa, sb) and
    n_seg."""
    p = "xyz".index(probe)
    a, b = [d for d in range(3) if d != p]
    st = (dims[1] * dims[2], dims[2], 1)
    n_seg = -(-(dims[p] - 1) // K)
    return (dims[p], dims[a], dims[b]), (st[p], st[a], st[b]), n_seg


def grid(L, na, nb, K):
    """(n_bt, n_ac, n_pc): the tiles, runs and chunks of a segment that
    ``pack_chain.cu`` plan_of derives from the plan; the grid is (n_bt,
    n_ac * n_pc, n_seg)."""
    return -(-nb // L.TB), -(-na // L.AR), (K + L.PB) // L.PB


def blocks(kind, L, n_p, na, nb, K, n_seg):
    """Each block's (s, b0, ncell, a0, a1, first plane or slot, count), by
    the kernel's arithmetic from its (blockIdx.x, .y, .z); the adjoint's
    blocks past their segment's planes return at once and are left out."""
    n_bt, n_ac, n_pc = grid(L, na, nb, K)
    for s in range(n_seg):
        for y in range(n_ac * n_pc):
            run, chunk = y % n_ac, y // n_ac
            for x in range(n_bt):
                b0, a0 = x * L.TB, run * L.AR
                a1, ncell = min(a0 + L.AR, na), min(L.TB, nb - b0)
                if kind == "forward":
                    k0 = chunk * L.PB
                    yield s, b0, ncell, a0, a1, k0, min(L.PB, K + 1 - k0)
                    continue
                q_end = n_p if s == n_seg - 1 else s * K + K
                q0 = s * K + chunk * L.PB
                if q0 < q_end:
                    yield s, b0, ncell, a0, a1, q0, min(L.PB, q_end - q0)


SHAPES = [((9, 5, 7), "x", 4, 3), ((9, 5, 7), "y", 2, 4),
          ((9, 5, 7), "z", 3, 8), ((9, 5, 7), "z", 4, 4),
          ((2, 2, 2), "x", 1, 8), ((2, 3, 4), "y", 1, 3),
          ((3, 2, 5), "z", 4, 4), ((17, 33, 12), "x", 16, 8),
          ((17, 33, 12), "y", 64, 3), ((65, 40, 65), "z", 64, 4),
          ((512, 512, 512), "z", 64, 4), ((512, 512, 512), "x", 64, 4),
          ((512, 512, 512), "y", 64, 4), ((1024,) * 3, "z", 64, 4),
          ((1024,) * 3, "x", 64, 8), ((1024,) * 3, "z", 64, 8),
          ((1024,) * 3, "y", 512, 8), ((1024,) * 3, "z", 1023, 8),
          ((600, 7, 9), "x", 1, 4)]


def _shape_id(case):
    dims, probe, K, C = case
    return f"{'x'.join(map(str, dims))}-{probe}-K{K}-C{C}"


@pytest.mark.parametrize("tbytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("kind", ["forward", "adjoint"])
@pytest.mark.parametrize("case", SHAPES, ids=[_shape_id(c) for c in SHAPES])
def test_plan_covers_once_and_fits(case, kind, tbytes):
    """Along each axis the blocks' ranges partition it, so every (segment,
    row, cell, slot) of the table (forward) and every ne cell (adjoint)
    is a block's exactly once; shared bytes and the grid fit the card."""
    dims, probe, K, C = case
    (n_p, na, nb), _, n_seg = geometry(dims, probe, K)
    L = pc.plan(kind, na, nb, K, C, tbytes)
    assert 1 <= L.TB <= nb and 1 <= L.AR <= na and 1 <= L.PB <= K + 1
    assert pc.plan_smem(kind, L.TB, L.PB, C, K, tbytes) <= 232448
    # the grid (n_bt, n_ac * n_pc, n_seg) within an H100's limits
    n_bt, n_ac, n_pc = grid(L, na, nb, K)
    assert n_bt <= 2 ** 31 - 1 and n_ac * n_pc <= 65535
    assert n_seg <= 65535
    rows, cells = set(), set()
    planes = {}
    for s, b0, ncell, a0, a1, first, count in blocks(kind, L, n_p, na, nb,
                                                     K, n_seg):
        assert ncell >= 1 and a1 > a0 and count >= 1
        rows.add((a0, a1))
        cells.add((b0, ncell))
        planes.setdefault(s, set()).add((first, count))

    def partition(ranges, n):
        ranges = sorted(ranges)
        assert ranges[0][0] == 0
        for (lo, hi), (nxt, _) in zip(ranges, ranges[1:]):
            assert hi == nxt
        assert ranges[-1][1] == n

    partition(rows, na)
    partition([(b0, b0 + n) for b0, n in cells], nb)
    if kind == "forward":
        for s in range(n_seg):
            partition([(k, k + n) for k, n in planes[s]], K + 1)
    else:
        partition([(q, q + n) for s in planes for q, n in planes[s]], n_p)


def test_plan_at_the_path_shapes():
    """512^3, K = 64, C = 4, bf16: a segment's 65 slots a block, 23 cells a
    forward tile (1,495 slots a row, 97% of three trips of 2 x 256 threads)
    and 16 an adjoint one, 16 rows a run; the forward's seven staged rows
    take 46,900 bytes, the adjoint's plane and cell tables, four ring rows of
    copied slots, their second copies and border sums 43,488."""
    f = pc.plan("forward", 512, 512, 64, 4, 2)
    a = pc.plan("adjoint", 512, 512, 64, 4, 2)
    assert tuple(f) == (23, 65, 16) and tuple(a) == (16, 65, 16)
    assert pc.plan_smem("forward", 23, 65, 4, 64, 2) == 7 * 25 * 67 * 4 \
        == 46900
    assert pc.plan_smem("adjoint", 16, 65, 4, 64, 2) == (
        544 + 544 + 272 + 80 + 4 * 18 * 67 * 8 + 4 * 18 * 2 * 8
        + 4 * 18 * 2 * 4 * 4) == 43488
    assert grid(f, 512, 512, 64) == (23, 32, 1)
    assert grid(a, 512, 512, 64) == (32, 32, 1)
    # a K too deep for one chunk is cut into even chunks
    deep = pc.plan("adjoint", 1024, 1024, 1023, 8)
    n_pc = grid(deep, 1024, 1024, 1023)[2]
    assert n_pc > 1 and deep.PB * n_pc >= 1024
    assert deep.PB * (n_pc - 1) < 1024
    assert pc.plan_smem("adjoint", deep.TB, deep.PB, 8, 1023) <= pc.SMEM_MAX


@pytest.mark.parametrize("C,tbytes,TB", [(4, 2, 16), (3, 2, 16), (3, 4, 8),
                                         (4, 4, 8), (8, 2, 8), (8, 4, 4)])
def test_adjoint_tile_halves_for_wide_slots(C, tbytes, TB):
    """At 512^3, K = 64 the adjoint's tile is halved from 16 cells until
    its ring of a segment fits a quarter of an SM's shared memory (four
    blocks an SM): 16 for 8-byte bf16 slots of C = 4, 8 for 12- and
    16-byte slots, 4 for the 32-byte slots of f32 C = 8. The forward's
    tile does not depend on the slots."""
    a = pc.plan("adjoint", 512, 512, 64, C, tbytes)
    assert (a.TB, a.PB) == (TB, 65)
    assert pc.plan_smem("adjoint", a.TB, a.PB, C, 64, tbytes) \
        <= pc.SMEM_QUARTER
    if TB < 16:
        assert pc.plan_smem("adjoint", 2 * TB, 65, C, 64, tbytes) \
            > pc.SMEM_QUARTER
    assert pc.plan("forward", 512, 512, 64, C, tbytes).TB == pc.FORWARD_TB


# -- a walk of the kernels -----------------------------------------------------


def _scalars(spec):
    k = pc._consts(spec)
    p, a, b = spec.axes
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    return k, f32, (f32(k.h[p]), f32(k.h[a]), f32(k.h[b]))


def walk_forward(ne, spec, L):
    """The forward kernel's steps on the CPU: (table, times each slot was
    written)."""
    dom = spec.domain
    lay = spec.layout
    C = lay.n_channels
    K = spec.K
    dims = tuple(ne.shape)
    (n_p, na, nb), (sp, sa, sb), n_seg = geometry(dims, dom.probing_direction,
                                                  K)
    p_ax, a_ax, b_ax = spec.axes
    k, f32, (hp, ha, hb) = _scalars(spec)
    nc, pref = f32(k.nc), f32(k.pref)
    flat = ne.reshape(-1)
    extra = {}
    if lay.inv_brems:
        # PyTorch's vectorised log and pow on the CPU can round a short
        # tile's tail otherwise than the whole volume's: kappa of the whole
        # volume, read at the staged body's cells
        extra["kappa"] = constants.kappa(ne, dom.Te, dom.Z,
                                         k.omega).reshape(-1)
    if lay.B_on:
        extra["B"] = dom.B.reshape(-1, 3)
    out = torch.full((n_seg, na * nb, K + 1, C), float("nan"))
    seen = torch.zeros((n_seg, na * nb, K + 1), dtype=torch.int32)

    def grad(lo, hi, edge, h):
        d = hi - lo
        return torch.where(edge, d / h, (d * 0.5) / h) * pref

    for s, b0, ncell, a0, a1, k0, nk in blocks("forward", L, n_p, na, nb,
                                               K, n_seg):
        # the seven staged rows: 0-3 ne / nc, 4-6 ne as copied
        staged = torch.full((7, L.TB + 2, L.PB + 2), float("nan"))
        p0 = s * K + k0
        sc, sk = ncell + 2, nk + 2
        bs = (b0 - 1 + torch.arange(sc)).clamp(0, nb - 1)
        ps = (p0 - 1 + torch.arange(sk)).clamp(0, n_p - 1)

        def issue(a, r):
            # row a's ne, clamped into the grid, into slot 4 + r
            ar = min(max(a, 0), na - 1)
            staged[4 + r, :sc, :sk] = flat[
                ar * sa + bs[:, None] * sb + ps[None, :] * sp]

        def divide(r, q):
            staged[q, :sc, :sk] = staged[4 + r, :sc, :sk] / nc

        def compute(a, lo, mid, hi, r):
            flo, fmid, fhi = staged[lo], staged[mid], staged[hi]
            body = staged[4 + r]
            cs, kk = slice(1, ncell + 1), slice(1, nk + 1)
            b = b0 + torch.arange(ncell)[:, None]
            p = p0 + torch.arange(nk)[None, :]
            edge_a = torch.tensor(a == 0 or a == na - 1)
            ch = [grad(flo[cs, kk], fhi[cs, kk], edge_a, ha),
                  grad(fmid[:ncell, kk], fmid[2:ncell + 2, kk],
                       (b == 0) | (b == nb - 1), hb),
                  grad(fmid[cs, :nk], fmid[cs, 2:nk + 2],
                       (p == 0) | (p == n_p - 1), hp)]
            if C > 3:
                # the pointwise channels as build_pack computes them
                body_c = body[cs, kk]
                off = a * sa + b * sb + p.clamp(max=n_p - 1) * sp
                real = (p <= n_p - 1).expand_as(body_c)
                assert torch.equal(body_c[real], flat[off][real])
                if lay.inv_brems:
                    ch.append(extra["kappa"][off])
                if lay.phaseshift:
                    ch.append(k.omega * (constants.n_refrac(body_c, k.omega)
                                         - 1.0))
                if lay.B_on:
                    for ax in (a_ax, b_ax, p_ax):
                        ch.append(k.verdet * body_c * extra["B"][off, ax])
            v = torch.stack(ch, -1)
            v = torch.where((p <= n_p - 1)[..., None], v, torch.zeros(()))
            rows = a * nb + b0 + torch.arange(ncell)
            out[s, rows, k0:k0 + nk] = v
            seen[s, rows, k0:k0 + nk] += 1

        for r in range(3):
            issue(a0 - 1 + r, r)
            divide(r, r)
        for a in range(a0, a1):
            j = a - a0
            if a + 2 <= a1:
                issue(a + 2, j % 3)
                divide(j % 3, (j + 3) & 3)
            compute(a, j & 3, (j + 1) & 3, (j + 2) & 3, (j + 1) % 3)
    dt = spec.pack_dtype or torch.float32
    return out.to(dt).reshape(n_seg, na * nb, (K + 1) * C), seen


def walk_adjoint(ne, dseg, spec, L):
    """The adjoint kernel's steps on the CPU: (d ne, times each cell was
    written)."""
    dom = spec.domain
    lay = spec.layout
    C = lay.n_channels
    K = spec.K
    dims = tuple(ne.shape)
    (n_p, na, nb), (sp, sa, sb), n_seg = geometry(dims, dom.probing_direction,
                                                  K)
    k, f32, _ = _scalars(spec)
    p_ax, a_ax, b_ax = spec.axes
    qs = [f32(k.pref / h) for h in k.h]          # along x, y, z
    nc = f32(k.nc)
    table = dseg.float().reshape(-1)
    row = (K + 1) * C
    flat = ne.reshape(-1)
    if lay.inv_brems:
        # as in walk_forward: the whole volume's, read at each cell
        kgrad = pc.kappa_grad(ne, dom.Te, dom.Z, k.omega).reshape(-1)
    dne = torch.full((ne.numel(),), float("nan"))
    seen = torch.zeros(ne.numel(), dtype=torch.int32)

    def stencil_t(j, n, Wm, W0, Wp):
        cf = lambda i: torch.where((i == 0) | (i == n - 1), 1.0,  # noqa
                                   0.5)
        left = torch.where(j >= 1, Wm * cf(j - 1), torch.zeros(()))
        right = torch.where(j <= n - 2, Wp * cf(j + 1), torch.zeros(()))
        s = left - right
        s = torch.where(j == 0, s - W0, s)
        return torch.where(j == n - 1, s + W0, s)

    for s, b0, ncell, a0, a1, q0, nq in blocks("adjoint", L, n_p, na, nb,
                                               K, n_seg):
        # a ring of four rows of copied slots (held here as float values),
        # their border planes' second copies and the border sums; at most
        # (PB + 1) // K + 1 border planes among the PB + 2 staged
        SP, SC = L.PB + 2, L.TB + 2
        nbx = (L.PB + 1) // K + 1
        raw = torch.full((4, SC, SP, C), float("nan"))
        xraw = torch.full((4, SC, nbx, C), float("nan"))
        fb = torch.full((4, SC, nbx, C), float("nan"))
        pmain, psec, pbx = [], [], []
        sc, sq = ncell + 2, nq + 2
        m0 = max(1, (q0 + K - 2) // K)
        for pl in range(sq):
            q = q0 - 1 + pl
            first = second = x = -1
            if 0 <= q <= n_p - 1:
                ss, kq = q // K, q % K
                if ss < n_seg:
                    first = (ss * (na * nb) * (K + 1) + kq) * C
                if kq == 0 and ss >= 1:
                    second = ((ss - 1) * (na * nb) * (K + 1) + K) * C
                    x = ss - m0
                    assert 0 <= x < nbx
            pmain.append(first)
            psec.append(second)
            pbx.append(x)
        coff = (b0 - 1 + torch.arange(sc)).clamp(0, nb - 1) * row
        chans = torch.arange(C)

        def issue(a, r):
            base = min(max(a, 0), na - 1) * nb * row
            for pl in range(sq):
                if pmain[pl] >= 0:
                    raw[r, :sc, pl] = table[base + coff[:, None] + pmain[pl]
                                            + chans]
                else:
                    raw[r, :sc, pl] = 0.0
                if pbx[pl] >= 0:
                    xraw[r, :sc, pbx[pl]] = table[base + coff[:, None]
                                                  + psec[pl] + chans]

        def borders(r):
            for pl in range(sq):
                if pbx[pl] >= 0:
                    fb[r, :sc, pbx[pl]] = (raw[r, :sc, pl]
                                           + xraw[r, :sc, pbx[pl]])

        def plane(r, c):
            """(SC, SP) channel c of ring row r as the compute reads it: a
            border plane's sum, else the copied slot."""
            v = raw[r, :, :, c].clone()
            for pl in range(sq):
                if pbx[pl] >= 0:
                    v[:, pl] = fb[r, :, pbx[pl], c]
            return v

        def compute(a, lo, mid, hi):
            cs, ks = slice(1, ncell + 1), slice(1, nq + 1)
            b = b0 + torch.arange(ncell)[:, None]
            p = q0 + torch.arange(nq)[None, :]
            aa = torch.tensor(a)
            P2 = plane(mid, 2)
            tp = stencil_t(p, n_p, P2[cs, :nq], P2[cs, ks],
                           P2[cs, 2:nq + 2]) * qs[p_ax]
            ta = stencil_t(aa, na, plane(lo, 0)[cs, ks], plane(mid, 0)[cs, ks],
                           plane(hi, 0)[cs, ks]) * qs[a_ax]
            P1 = plane(mid, 1)
            tb = stencil_t(b, nb, P1[:ncell, ks], P1[cs, ks],
                           P1[2:ncell + 2, ks]) * qs[b_ax]
            t = {p_ax: tp, a_ax: ta, b_ax: tb}
            out = ((t[0] + t[1]) + t[2]) / nc
            off = a * sa + b * sb + p * sp
            body = flat[off]
            if lay.inv_brems:
                g = plane(mid, lay.kappa_index)[cs, ks]
                out = out + g * kgrad[off]
            if lay.phaseshift:
                g = plane(mid, lay.phase_index)[cs, ks]
                arg = 1.0 - k.n_coef * body
                pos = arg > 0.0
                root = torch.sqrt(torch.where(pos, arg, torch.ones_like(arg)))
                tt = (g * k.omega) / (2.0 * root)
                out = out + torch.where(pos, -tt * k.n_coef,
                                        torch.zeros_like(tt))
            if lay.B_on:
                f = lay.faraday_index
                B = dom.B.reshape(-1, 3)
                far = (plane(mid, f)[cs, ks] * B[off, a_ax]
                       + plane(mid, f + 1)[cs, ks] * B[off, b_ax]
                       + plane(mid, f + 2)[cs, ks] * B[off, p_ax])
                out = out + far * k.verdet
            dne[off] = out
            seen[off] += 1

        for r in range(3):
            issue(a0 - 1 + r, r)
        for r in range(3):
            borders(r)
        for a in range(a0, a1):
            j = a - a0
            if a + 2 <= a1:
                issue(a + 2, (j + 3) & 3)
                borders((j + 3) & 3)
            compute(a, j & 3, (j + 1) & 3, (j + 2) & 3)
    return dne.reshape(ne.shape), seen.reshape(ne.shape)


# (dims, probe, K, C, table dtype, the plan's TB, PB and AR where not the
# default): K dividing n_p - 1 and padding, one segment, dims of 2; the
# default plans, then plans cut to a few cells, rows and planes a block
# (several tiles, runs and chunks)
SMALL = {"TB": 2, "AR": 2, "PB": 3}
WALKS = [((9, 5, 7), "x", 4, 8, torch.float32, {}),
         ((9, 5, 7), "x", 3, 8, torch.bfloat16, SMALL),
         ((9, 5, 7), "y", 2, 4, torch.bfloat16, SMALL),
         ((9, 5, 7), "y", 3, 3, torch.float32, {"TB": 3, "AR": 4}),
         ((9, 5, 7), "z", 3, 4, torch.bfloat16, {}),
         ((9, 5, 7), "z", 4, 8, torch.float32, SMALL),
         ((9, 5, 7), "z", 8, 4, torch.float32, {"PB": 4}),
         ((2, 3, 4), "x", 1, 8, torch.bfloat16, {}),
         ((2, 3, 4), "y", 1, 4, torch.float32, {"TB": 1, "AR": 1}),
         ((3, 2, 2), "z", 1, 3, torch.bfloat16, {"PB": 1}),
         ((6, 11, 10), "z", 3, 4, torch.bfloat16, {"TB": 4, "AR": 3}),
         ((10, 6, 11), "x", 2, 8, torch.float32,
          {"TB": 5, "AR": 2, "PB": 2})]


def _walk_id(case):
    dims, probe, K, C, dt, over = case
    return (f"{'x'.join(map(str, dims))}-{probe}-K{K}-C{C}-{str(dt)[6:]}-"
            + ("-".join(f"{k}{v}" for k, v in over.items()) or "default"))


def _walk_plan(kind, case):
    dims, probe, K, C, dt, over = case
    (_, na, nb), _, _ = geometry(dims, probe, K)
    return pc.plan(kind, na, nb, K, C, 2 if dt == torch.bfloat16 else 4,
                   **over)


@pytest.mark.parametrize("case", WALKS, ids=[_walk_id(c) for c in WALKS])
def test_walk_of_the_forward_is_the_plain_chain(case):
    dims, probe, K, C, dt, over = case
    d, ne = domain(dims, probe, C)
    spec = pc.chain_spec(d, LWL, K=K, pack_dtype=dt)
    got, seen = walk_forward(ne, spec, _walk_plan("forward", case))
    assert bool((seen == 1).all())
    want = pc.seg_planes_plain(ne, spec)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.int16) if dt == torch.bfloat16
                       else got.view(torch.int32),
                       want.view(torch.int16) if dt == torch.bfloat16
                       else want.view(torch.int32))


@pytest.mark.parametrize("case", WALKS, ids=[_walk_id(c) for c in WALKS])
def test_walk_of_the_adjoint_is_the_plain_adjoint(case):
    dims, probe, K, C, dt, over = case
    d, ne = domain(dims, probe, C)
    spec = pc.chain_spec(d, LWL, K=K, pack_dtype=dt)
    (n_p, na, nb), _, n_seg = geometry(dims, probe, K)
    g = torch.Generator().manual_seed(3)
    dseg = torch.randn((n_seg, na * nb, (K + 1) * C), generator=g).to(dt)
    got, seen = walk_adjoint(ne, dseg, spec, _walk_plan("adjoint", case))
    assert bool((seen == 1).all())
    want = pc.seg_planes_vjp_plain(ne, dseg, spec)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_walk_of_the_adjoint_fails_without_the_border_sum():
    """The walk's check sees a dropped second copy of a border plane (the
    planted fault chip_smoke builds into the kernel)."""
    dims, probe, K, C, dt, over = WALKS[1]
    d, ne = domain(dims, probe, C)
    spec = pc.chain_spec(d, LWL, K=K, pack_dtype=dt)
    (n_p, na, nb), _, n_seg = geometry(dims, probe, K)
    dseg = torch.randn((n_seg, na * nb, (K + 1) * C),
                       generator=torch.Generator().manual_seed(4)).to(dt)
    # the border copies [s, K] of s < n_seg - 1 zeroed: the walk must see it
    cut = dseg.reshape(n_seg, na * nb, K + 1, C).clone()
    cut[:-1, :, K] = 0
    got, _ = walk_adjoint(ne, cut.reshape(dseg.shape), spec,
                          _walk_plan("adjoint", WALKS[1]))
    want = pc.seg_planes_vjp_plain(ne, dseg, spec)
    assert not torch.equal(got, want)


def _record_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(_build.Kernel, "launch",
                        lambda self, name, device, *a: calls.append(
                            (name, a)))
    monkeypatch.setattr(pc, "_checked",
                        lambda ne, spec: (ne, None, None, None))
    return calls


def test_wrappers_hand_the_kernels_the_plan(monkeypatch):
    """On the "meta" device the wrappers launch with the plan's TB, PB and
    AR after the geometry, the forward's plan and the adjoint's apart."""
    dims, probe, K, C = (9, 40, 7), "z", 3, 4
    d, ne = domain(dims, probe, C)
    spec = pc.chain_spec(d, LWL, K=K, pack_dtype=torch.bfloat16)
    meta = torch.empty(ne.shape, device="meta")
    calls = _record_launches(monkeypatch)
    table = pc.forward(meta, spec)
    pc.adjoint(meta, table, spec)
    (_, na, nb), _, _ = geometry(dims, probe, K)
    for (name, args), kind in zip(calls, ("forward", "adjoint")):
        assert tuple(args[14:17]) == tuple(pc.plan(kind, na, nb, K, C, 2))
    assert calls[0][1][14:17] != calls[1][1][14:17]


@pytest.mark.parametrize("probe", ["x", "y", "z"])
def test_wrappers_take_volumes_past_2_31_cells(probe, monkeypatch):
    """A 1300^3 volume (2.2e9 cells) is launched along every axis: the
    kernels' row, segment and cell offsets are 64-bit, a block's from its
    row's first cell 32-bit."""
    d, _ = domain((9, 5, 7), probe, 4)
    spec = pc.chain_spec(d, LWL, K=64, pack_dtype=torch.bfloat16)
    meta = torch.empty((1300,) * 3, device="meta")
    calls = _record_launches(monkeypatch)
    table = pc.forward(meta, spec)
    pc.adjoint(meta, table, spec)
    assert [name for name, _ in calls] == ["pack_chain_forward",
                                           "pack_chain_adjoint"]
    assert tuple(calls[0][1][4:7]) == (1300,) * 3


@pytest.mark.parametrize("probe,dims,K", [
    ("x", (8, 6000, 6000), 64),        # a block's planes: 66 x 3.6e7 cells
    ("z", (4, 50000, 50000), 4),       # ne's stride along x
    ("z", (50000, 50000, 2), 4),       # a plane's cells
    ("z", (2, 2000000, 3), 1023)],     # a row of a segment's entries
    ids=["block", "stride", "plane", "row"])
def test_wrappers_refuse_offsets_past_32_bits(probe, dims, K, monkeypatch):
    """Where a block's offset from its row's first cell, ne's strides, a
    plane's cells or a row of a segment's entries would pass 2^31 - 1, the
    wrappers raise before a launch (the kernels would refuse it too)."""
    d, _ = domain((9, 5, 7), probe, 4)
    spec = pc.chain_spec(d, LWL, K=K, pack_dtype=torch.bfloat16)
    meta = torch.empty(dims, device="meta")
    calls = _record_launches(monkeypatch)
    with pytest.raises(ValueError, match="32-bit offsets"):
        pc.forward(meta, spec)
    (_, na, nb), _, n_seg = geometry(dims, probe, K)
    dseg = torch.empty((n_seg, na * nb, (K + 1) * 4), dtype=torch.bfloat16,
                       device="meta")
    with pytest.raises(ValueError, match="32-bit offsets"):
        pc.adjoint(meta, dseg, spec)
    assert calls == []
