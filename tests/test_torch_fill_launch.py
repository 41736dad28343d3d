"""K9's wrapper on the card's branch: ``kernels.fill.fill`` on the "meta"
device (standing in for the card, its launch recorded instead of run)
checks its batch and hands ``pack_fill`` of ``csrc/fill.cu`` the batch's
pointers, strides and scalars; the kernel cuts the batch into tiles, chunks
and stores itself from those.
"""

import pytest
import torch

from synthpy_tpu_torch import constants
from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels import _build, fill

NA, NB = 19, 23
KW = dict(g0=4, seg_i=1, k0=4, n_p=7, pref=-3e-10, da=1e-4, db=1.1e-4,
          dp=0.9e-4, omega=1.77e15, verdet=5e-2)


def _batch(mode, physics, pb=4, blocks=None, ex_t=False):
    dev = torch.device("meta")
    lay = ChannelLayout(physics, physics, physics)
    C, n_extra = lay.n_channels, 5 if physics else 0
    dtype = {0: torch.float32, 1: torch.bfloat16}.get(mode, torch.int8)
    blocks = blocks or (5 if mode == 3 else 9)
    buf = torch.empty((2, NA * NB, blocks * C), dtype=dtype, device=dev)
    scl = torch.empty((2, 9, C), device=dev) if mode >= 2 else None
    slab = torch.empty((pb + 2, NA, NB), device=dev)
    ex = (torch.empty((n_extra, pb, NA, NB), device=dev).transpose(0, 1)
          if ex_t else torch.empty((pb, n_extra, NA, NB), device=dev))
    return lay, buf, scl, slab, ex


def _record(monkeypatch):
    seen = []
    monkeypatch.setattr(_build.Kernel, "launch",
                        lambda self, name, device, *args:
                        seen.append((name, args)))
    return seen


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("physics", [False, True])
def test_fill_launches_with_the_batchs_arguments(monkeypatch, physics,
                                                 mode):
    """One ``pack_fill`` launch with as many arguments as its C signature
    takes: the output at (segment, cell 0, col0) for every column offset,
    the table's row length, the scale row (segment, k0) of a quantised
    tier, the pointwise volumes' strides (transposed leading axes too),
    and the batch's planes, grid, spacings and layout."""
    seen = _record(monkeypatch)
    for col_block, ex_t in ((0, False), (1, True), (3, False)):
        seen.clear()
        lay, buf, scl, slab, ex = _batch(mode, physics, ex_t=ex_t)
        C = lay.n_channels
        fill.fill(buf, scl, slab, ex, col0=col_block * C, pb=4, lone=False,
                  mode=mode, layout=lay,
                  dither=(3, 9) if mode >= 2 else None, **KW)
        ((name, args),) = seen
        assert name == "pack_fill"
        assert len(args) + 1 == len(fill.KERNEL.functions[name])
        assert args[:3] == (buf[1, 0, col_block * C:].data_ptr(), mode,
                            buf.shape[2])
        assert args[3] == (None if mode < 2 else scl[1, 4].data_ptr())
        assert args[5] == slab.data_ptr()
        if physics:
            assert args[6:9] == (ex.data_ptr(), ex.stride(0), ex.stride(1))
        else:
            assert args[6:9] == (None, 0, 0)
        assert args[9:15] == (4, 4, 0, 7, NA, NB)
        assert args[15:23] == pytest.approx(
            (-3e-10, 1e-4, 1.1e-4, 1.8e-4, 0.9e-4, 1.77e15,
             constants.OMEGA_PE_COEFF**2 * 1e-6 / 1.77e15**2, 5e-2))
        assert args[23:26] == (int(physics),) * 3
        assert args[26] == int(mode >= 2)


@pytest.mark.parametrize("pb,lone", [(3, False), (2, True), (5, True),
                                     (7, False)])
def test_fill_refuses_an_int4_batch_without_pairs(monkeypatch, pb, lone):
    """An int4 batch is nibble pairs of planes, or one lone plane: anything
    else is refused before a launch."""
    seen = _record(monkeypatch)
    lay, buf, scl, slab, ex = _batch(3, True, pb=pb)
    with pytest.raises(ValueError, match="int4"):
        fill.fill(buf, scl, slab, ex, col0=0, pb=pb, lone=lone, mode=3,
                  layout=lay, **KW)
    assert not seen


def test_fill_takes_a_lone_int4_plane(monkeypatch):
    seen = _record(monkeypatch)
    lay, buf, scl, slab, ex = _batch(3, False, pb=1)
    fill.fill(buf, scl, slab, ex, col0=0, pb=1, lone=True, mode=3,
              layout=lay, **KW)
    ((_, args),) = seen
    assert args[11] == 1


@pytest.mark.parametrize("fault", ["slab", "ex_rows", "columns", "dtype"])
def test_fill_refuses_a_batch_it_cannot_write(monkeypatch, fault):
    """A slab of the wrong shape, pointwise volumes whose rows are not
    contiguous, a table without the batch's columns, or a table of another
    tier's dtype: refused before a launch."""
    seen = _record(monkeypatch)
    lay, buf, scl, slab, ex = _batch(2, True, blocks=4 if fault == "columns"
                                     else None)
    if fault == "slab":
        slab = slab[:-1]
    elif fault == "ex_rows":
        ex = torch.empty((4, 5, NB, NA), device="meta").transpose(2, 3)
    elif fault == "dtype":
        buf = buf.float()
    match = {"slab": "slab shape", "ex_rows": "rows contiguous",
             "columns": "cannot take", "dtype": "buf: need"}[fault]
    with pytest.raises(ValueError, match=match):
        fill.fill(buf, scl, slab, ex, col0=lay.n_channels, pb=4, lone=False,
                  mode=2, layout=lay, **KW)
    assert not seen
