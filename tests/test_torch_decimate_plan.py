"""The host plan of K2's decimator (``kernels.pack.decimate_plan``), on the CPU.

``csrc/pack.cu`` ``decimate_kernel`` moves tiles of R whole table rows by
1-D bulk copies (16-byte aligned starts and lengths) through a ring of
shared-memory stages, copies the kept planes of each tile by a walk over
(row, kept plane, channel) that advances by additions, and sends rows past
the last whole tile through a plain row loop in the same launch. The
kernel runs only on a card; here the plan is checked over a grid of
forms and shapes (spans on 16-byte boundaries, shared memory within the
opt-in limit, every output value written exactly once), and a PyTorch
walk of the plan's tile, row, kept-plane and channel loops, as the kernel
steps them, is held bit for bit to ``decimate_tables_plain`` and to the
JAX package's ``decimate_segment_pack``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthpy_tpu.tracer import zscan as jz
from synthpy_tpu_torch import convert
from synthpy_tpu_torch.kernels import pack
from synthpy_tpu_torch.tracer import zscan as tz

torch.set_num_threads(1)

THREADS = 256           # csrc/pack.cu THREADS: a block's threads
FORMS = {"f32": (torch.float32, 4, False), "bf16": (torch.bfloat16, 2, False),
         "int8": (torch.int8, 1, False), "int4": (torch.int8, 1, True)}


def tile_walk(R, ncol_out, C):
    """(e, row, kept column, channel) of every value of a tile, in the
    order decimate_kernel's threads take them: thread t starts at value t
    and steps by THREADS values, carrying channel into kept column into
    row."""
    nkd = ncol_out // C
    t = np.arange(THREADS)
    r = t // ncol_out
    kd = (t - r * ncol_out) // C
    c = t - r * ncol_out - kd * C
    dr = THREADS // ncol_out
    dkd = (THREADS - dr * ncol_out) // C
    dc = THREADS - dr * ncol_out - dkd * C
    e, out = t.copy(), []
    while (e < R * ncol_out).any():
        live = e < R * ncol_out
        out.append(np.stack([e[live], r[live], kd[live], c[live]]))
        e = e + THREADS
        c, kd, r = c + dc, kd + dkd, r + dr
        carry = c >= C
        c, kd = c - C * carry, kd + carry
        carry = kd >= nkd
        kd, r = kd - nkd * carry, r + carry
    return np.concatenate(out, axis=1)


def row_walk(ncol_out, C):
    """(j, kept column, channel) of a tail row, as the row loop steps."""
    j = np.arange(THREADS)
    kd, c = j // C, j % C
    dk, dc = THREADS // C, THREADS % C
    out = []
    while (j < ncol_out).any():
        live = j < ncol_out
        out.append(np.stack([j[live], kd[live], c[live]]))
        j = j + THREADS
        c, kd = c + dc, kd + dk
        carry = c >= C
        c, kd = c - C * carry, kd + carry
    return np.concatenate(out, axis=1)


def check_plan(plan, K, C, S, n_seg, cells, eb, nib, limit):
    """Spans on 16-byte boundaries, shared memory within ``limit``, every
    row in one tile or the tail, every value of a tile and a row once."""
    assert plan.rows == n_seg * cells and plan.Kd == K // S
    assert plan.ncol_in == ((K // 2 + 1) * C if nib else (K + 1) * C)
    assert plan.ncol_out == ((K // S // 2 + 1) * C if nib
                             else (K // S + 1) * C)
    bin_, bout = plan.R * plan.ncol_in * eb, plan.R * plan.ncol_out * eb
    assert plan.smem <= limit
    assert plan.tiles * plan.R + plan.tail_rows == plan.rows
    assert 0 <= plan.tail_rows and 1 <= plan.blocks
    if plan.tiles:
        # tile t spans bytes [t * bin_, (t + 1) * bin_) in, likewise out
        assert bin_ % 16 == 0 and bout % 16 == 0
        assert plan.smem == pack.DEC_BARS + plan.stages * bin_ + 2 * bout
        assert 1 <= plan.stages <= pack.DEC_STAGES
        assert plan.blocks <= max(plan.tiles, plan.tail_rows)
        assert plan.tail_rows < plan.R
        # the persistent blocks take tiles b, b + blocks, ... : each once
        owner = np.concatenate([np.arange(b, plan.tiles, plan.blocks)
                                for b in range(plan.blocks)])
        assert np.array_equal(np.sort(owner), np.arange(plan.tiles))
        w = tile_walk(plan.R, plan.ncol_out, C)
        assert np.array_equal(np.sort(w[0]), np.arange(bout // eb))
        assert np.array_equal(w[0], w[1] * plan.ncol_out + w[2] * C + w[3])
        assert (w[2] < plan.ncol_out // C).all() and (w[3] < C).all()
    else:
        assert plan.smem == 0 and plan.stages == 0
    w = row_walk(plan.ncol_out, C)
    assert np.array_equal(np.sort(w[0]), np.arange(plan.ncol_out))
    assert np.array_equal(w[0], w[1] * C + w[2])


@pytest.mark.parametrize("stride", [2, 4, 8])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_plan_spans_memory_and_coverage(form, stride):
    _, eb, nib = FORMS[form]
    n = 0
    for K in (8, 16, 24, 64, 512):
        if K % stride:
            continue
        for C in (1, 3, 4, 7, 8, 16):
            for n_seg, cells in ((1, 5), (3, 1000), (1, 512 * 512),
                                 (8, 4096)):
                plan = pack.decimate_plan(eb, nib, n_seg, cells, K, C,
                                          stride)
                check_plan(plan, K, C, stride, n_seg, cells, eb, nib,
                           pack.H100_SMEM_OPTIN)
                n += 1
    assert n > 50


def test_plan_of_the_main_path_shape():
    """512^3, K = 512, C = 3, stride 2: 8 bf16 rows a tile (24,624 bytes
    in, 12,336 out), 4 f32 rows, 16 int8 rows, each its 16-byte minimum,
    in three blocks an SM; 16 nibble rows (12,336 bytes) in four; a ring
    of two stages."""
    for form, R, per_sm in (("bf16", 8, 3), ("f32", 4, 3), ("int8", 16, 3),
                            ("int4", 16, 4)):
        _, eb, nib = FORMS[form]
        plan = pack.decimate_plan(eb, nib, 1, 512 * 512, 512, 3, 2)
        assert plan.R == R and plan.stages == 2
        assert plan.tiles == 512 * 512 // R and plan.tail_rows == 0
        assert plan.blocks == per_sm * pack.H100_SMS
    plan = pack.decimate_plan(2, False, 1, 512 * 512, 512, 3, 2)
    assert plan.R * plan.ncol_in * 2 == 24_624
    assert plan.R * plan.ncol_out * 2 == 12_336


def test_plan_keeps_within_a_smaller_limit():
    """A smaller opt-in limit takes stages off the ring; rows too long for
    one stage raise, and a table off a 16-byte boundary goes to the row
    loop."""
    full = pack.decimate_plan(4, False, 1, 4096, 512, 8, 2)
    assert full.stages == pack.DEC_STAGES > 1
    lim = full.smem - 1
    plan = pack.decimate_plan(4, False, 1, 4096, 512, 8, 2, smem_optin=lim)
    assert plan.stages == pack.DEC_STAGES - 1 and plan.smem <= lim
    check_plan(plan, 512, 8, 2, 1, 4096, 4, False, lim)
    with pytest.raises(ValueError, match="above the card's 1000"):
        pack.decimate_plan(4, False, 1, 4096, 512, 8, 2, smem_optin=1000)
    off = pack.decimate_plan(2, False, 3, 1000, 64, 3, 2, aligned=False)
    assert off.tiles == 0 and off.tail_rows == 3000


def _codes(byte, odd):
    """Sign-extended nibble codes of int8 bytes (csrc nibble_code)."""
    w = byte.to(torch.int16) & 255
    n = torch.where(odd, (w >> 4) & 15, w & 15)
    return (n ^ 8) - 8


def _keep(flat, base, kd, c, C, S, Kd, nib):
    """Value (kd, c) of the rows starting at ``base`` of ``flat``."""
    if not nib:
        return flat[base + kd * S * C + c]
    p_lo, p_hi = 2 * kd * S, (2 * kd + 1) * S
    lo = _codes(flat[base + (p_lo >> 1) * C + c], (p_lo & 1) == 1)
    hi_ok = 2 * kd + 1 <= Kd
    p_hi = torch.where(hi_ok, p_hi, torch.zeros_like(p_hi))
    hi = _codes(flat[base + (p_hi >> 1) * C + c], (p_hi & 1) == 1)
    hi = torch.where(hi_ok, hi, torch.zeros_like(hi))
    return ((lo & 15) | ((hi & 15) << 4)).to(torch.uint8).view(torch.int8)


def walk(table, plan, C, S, nib):
    """The decimation as the kernel computes it: each block's tiles by the
    threads' walk, then the tail rows by the row loop. Returns the output
    and how many times each output value was written."""
    flat = table.reshape(-1)
    out = torch.zeros(plan.rows * plan.ncol_out, dtype=table.dtype)
    writes = torch.zeros(plan.rows * plan.ncol_out, dtype=torch.int32)
    tin, tout = plan.R * plan.ncol_in, plan.R * plan.ncol_out
    if plan.tiles:
        e, r, kd, c = (torch.from_numpy(a) for a in
                       tile_walk(plan.R, plan.ncol_out, C))
        for b in range(plan.blocks):
            for t in range(b, plan.tiles, plan.blocks):
                tile = flat[t * tin:(t + 1) * tin]
                out[t * tout + e] = _keep(tile, r * plan.ncol_in, kd, c, C,
                                          S, plan.Kd, nib)
                writes[t * tout + e] += 1
    j, kd, c = (torch.from_numpy(a) for a in row_walk(plan.ncol_out, C))
    for row in range(plan.tiles * plan.R, plan.rows):
        src = flat[row * plan.ncol_in:(row + 1) * plan.ncol_in]
        out[row * plan.ncol_out + j] = _keep(src, 0, kd, c, C, S, plan.Kd,
                                             nib)
        writes[row * plan.ncol_out + j] += 1
    return out, writes


# (n_seg, cells, K, C; C None: rows of a multiple of 16 bytes, 16 // eb)
WALK_CASES = {
    "rows_odd_tail": (3, 200, 64, 3, True),
    "rows_16": (2, 150, 24, None, True),
    "smaller_than_a_tile": (1, 5, 16, 3, True),
    "unaligned_start": (3, 200, 64, 3, False),
}


def _jax_table(table):
    a = table.numpy() if table.dtype != torch.bfloat16 else (
        table.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(a)


@pytest.mark.parametrize("case", sorted(WALK_CASES))
@pytest.mark.parametrize("stride", [2, 4, 8])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_walk_of_the_plan_equals_plain_and_jax(form, stride, case):
    dt, eb, nib = FORMS[form]
    n_seg, cells, K, C, aligned = WALK_CASES[case]
    C = C or 16 // eb
    plan = pack.decimate_plan(eb, nib, n_seg, cells, K, C, stride,
                              aligned=aligned)
    check_plan(plan, K, C, stride, n_seg, cells, eb, nib,
               pack.H100_SMEM_OPTIN)
    assert (plan.tiles > 0) == (case in ("rows_odd_tail", "rows_16"))
    rng = np.random.default_rng(stride * 7 + len(case))
    raw = rng.integers(0, 2**32, n_seg * cells * plan.ncol_in * eb // 4 + 1,
                       dtype=np.uint32).view(np.uint8)
    flat = torch.from_numpy(raw[:n_seg * cells * plan.ncol_in * eb].copy())
    table = flat.view(dt).reshape(n_seg, cells, plan.ncol_in)
    if dt.is_floating_point:
        # finite values: the JAX side compares values
        table = torch.where(table.isfinite(), table,
                            torch.zeros_like(table))
    got, writes = walk(table, plan, C, stride, nib)
    assert bool((writes == 1).all())
    want = pack.decimate_tables_plain(table, K, C, stride, nib)
    as_int = {4: torch.int32, 2: torch.int16, 1: torch.int8}[eb]
    assert torch.equal(got.view(as_int), want.reshape(-1).view(as_int))
    if nib and (K // stride) % 2:
        return      # JAX decimates nibble pairs to an even K / stride only
    jpack = jz.SegmentPack(
        _jax_table(table), jnp.zeros(2), jnp.ones(2), (1, cells), K, K,
        0.0, 1.0, 1.0,
        None if dt.is_floating_point else jnp.ones((n_seg, K + 1, C)),
        4 if nib else None)
    jd = jz.decimate_segment_pack(jpack, stride)
    td = tz.decimate_segment_pack(convert.segment_pack(jpack, "cpu"), stride)
    jt = torch.from_numpy(np.asarray(jd.seg_planes).view(
        {4: np.int32, 2: np.int16, 1: np.int8}[eb]).reshape(-1).copy())
    assert torch.equal(got.view(as_int), jt)
    assert torch.equal(td.seg_planes.reshape(-1).view(as_int), jt)
