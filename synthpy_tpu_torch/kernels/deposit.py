"""K8: cloud-in-cell deposit of per-ray values onto a 2-D grid.

``deposit`` launches ``csrc/deposit.cu`` on CUDA tensors and runs
``deposit_plain`` on CPU tensors. Both take (N,) positions, (N, V) values
(V = 1 or 2 channels sharing one bilinear weight channel) and the grid's
node coordinates, and return the (nx, ny, V) grid of weight-normalised
values in the JAX package's layout. ``ops.histogram.deposit_cic`` calls it
with the real or complex value of one deposit, ``ops.fresnel.propagate``
with the amplitude and phase that it deposits at the same positions.

The kernel buckets the rays by tile of the grid before it adds them in
shared memory (``deposit.cu``), ``BATCH`` rays at a time; ``tiles_plain``
is that bucketing's plain version, which the CPU tests hold to the
deposit's rule.
"""

from __future__ import annotations

import torch

from synthpy_tpu_torch.kernels._build import I, L, P, Kernel, refuse_grad

KERNEL = Kernel("deposit.cu", {
    "deposit_cic": [P, P, P, I, P, P, I, I, P, L, P, I, L, L, I, P],
}, flags=["--fmad=false"], helpers={
    "deposit_scratch_blocks": [L, I, I, I, I, L, I]})

MAX_CHANNELS = 2  # value channels of one deposit (deposit.cu)
# rays a batch of the kernel takes: its scratch holds four 16-byte bucket
# entries a ray of one batch (256 MiB), and a call of more rays runs in
# batches, each adding its sums to those before it
BATCH = 1 << 22
TILE = 32  # nodes a tile along x and y (deposit.cu)


def _corner(t: torch.Tensor, n: int) -> torch.Tensor:
    """clip(floor(t), 0, n - 2) as a float, NaN -> 0 (the JAX program's
    float-to-int32 conversion)."""
    f = torch.floor(t)
    return torch.where(torch.isnan(f), torch.zeros_like(f), f).clamp(0, n - 2)


def deposit_plain(x: torch.Tensor, y: torch.Tensor, vals: torch.Tensor,
                  x_coords: torch.Tensor, y_coords: torch.Tensor,
                  return_acc: bool = False) -> torch.Tensor:
    """Plain version of the deposit: ``deposit_cic``'s arithmetic
    (histogram.py:158-216) in PyTorch, four ``index_add_`` scatters; a NaN
    position spreads NaN to its corners, as in the JAX program."""
    nx, ny = x_coords.shape[0], y_coords.shape[0]
    tx = (x - x_coords[0]) / (x_coords[1] - x_coords[0])
    ty = (y - y_coords[0]) / (y_coords[1] - y_coords[0])
    inside = (torch.isfinite(tx) & torch.isfinite(ty) & (tx >= 0)
              & (tx <= nx - 1) & (ty >= 0) & (ty <= ny - 1))
    cx, cy = _corner(tx, nx), _corner(ty, ny)
    fx = (tx - cx).clamp(0.0, 1.0)
    fy = (ty - cy).clamp(0.0, 1.0)
    ix, iy = cx.long(), cy.long()
    chans = torch.cat([vals, torch.ones_like(vals[:, :1])], dim=1)
    chans = torch.where(inside[:, None], chans, torch.zeros_like(chans))
    acc = torch.zeros((nx * ny, chans.shape[1]), dtype=chans.dtype,
                      device=x.device)
    for ddx, wx in ((0, 1.0 - fx), (1, fx)):
        for ddy, wy in ((0, 1.0 - fy), (1, fy)):
            acc.index_add_(0, (ix + ddx) * ny + iy + ddy,
                           chans * (wx * wy)[:, None])
    if return_acc:
        return acc.reshape(nx, ny, chans.shape[1])
    den = acc[:, -1:]
    den = torch.where(den < 1e-12, torch.full_like(den, 1e-12), den)
    return (acc[:, :-1] / den).reshape(nx, ny, vals.shape[1])


def tiles_plain(x: torch.Tensor, y: torch.Tensor, x_coords: torch.Tensor,
                y_coords: torch.Tensor, tile: int = TILE):
    """The kernel's buckets: (rays, tiles), each entry a ray and a tile of
    ``tile`` x ``tile`` nodes (row-major over the tiles, nodes along y
    fastest) that its four corners touch, each pair once. A ray outside
    the grid with finite positions has none (it adds exactly 0); a NaN
    coordinate puts the ray in the tiles at corner index 0 along it."""
    nx, ny = x_coords.shape[0], y_coords.shape[0]
    tx = (x - x_coords[0]) / (x_coords[1] - x_coords[0])
    ty = (y - y_coords[0]) / (y_coords[1] - y_coords[0])
    inside = (torch.isfinite(tx) & torch.isfinite(ty) & (tx >= 0)
              & (tx <= nx - 1) & (ty >= 0) & (ty <= ny - 1))
    keep = torch.nonzero(inside | tx.isnan() | ty.isnan()).reshape(-1)
    ix, iy = (_corner(t[keep], n).long() for t, n in ((tx, nx), (ty, ny)))
    nty = (ny + tile - 1) // tile
    n_t = ((nx + tile - 1) // tile) * nty
    # (ray, tile) pairs as one integer each, every pair once
    pairs = torch.unique(torch.cat([
        keep * n_t + ((ix + a) // tile) * nty + (iy + b) // tile
        for a in (0, 1) for b in (0, 1)]))
    return pairs // n_t, pairs % n_t


def deposit(x: torch.Tensor, y: torch.Tensor, vals: torch.Tensor,
            x_coords: torch.Tensor, y_coords: torch.Tensor,
            return_acc: bool = False) -> torch.Tensor:
    """(nx, ny, V) grid of (N, V) ``vals`` deposited at (N,) positions
    (``x``, ``y``) onto the nodes ``x_coords`` (nx,) x ``y_coords`` (ny,),
    each node divided by its deposited weight (``deposit_cic``).
    ``return_acc=True`` returns the (nx, ny, V + 1) sums before the
    division instead, the bilinear weight last."""
    V = vals.shape[-1]
    nx, ny = x_coords.shape[0], y_coords.shape[0]
    if not 1 <= V <= MAX_CHANNELS or nx < 2 or ny < 2:
        raise ValueError(f"{V} value channels on a {nx} x {ny} grid: the "
                         f"deposit takes 1-{MAX_CHANNELS} channels and at "
                         "least 2 nodes an axis")
    if x.device.type == "cpu":
        return deposit_plain(x, y, vals, x_coords, y_coords, return_acc)
    refuse_grad("deposit.deposit (K8)", x, y, vals, x_coords, y_coords)
    dev = x.device
    n = x.shape[0]
    for name, t, shape in (("x", x, (n,)), ("y", y, (n,)),
                           ("vals", vals, (n, vals.shape[-1])),
                           ("x_coords", x_coords, (x_coords.shape[0],)),
                           ("y_coords", y_coords, (y_coords.shape[0],))):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a float32 tensor of shape "
                             f"{shape} on the rays' device")
    x, y, vals = x.contiguous(), y.contiguous(), vals.contiguous()
    x_coords, y_coords = x_coords.contiguous(), y_coords.contiguous()
    lib = KERNEL.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = lib.deposit_scratch_blocks(n, V, nx, ny, sms, BATCH,
                                        int(return_acc))
    scratch = torch.empty((blocks * 256,), dtype=torch.uint8, device=dev)
    out = torch.empty((nx, ny, V + 1 if return_acc else V),
                      dtype=torch.float32, device=dev)
    KERNEL.launch("deposit_cic", dev, x.data_ptr(), y.data_ptr(),
                  vals.data_ptr(), V, x_coords.data_ptr(),
                  y_coords.data_ptr(), nx, ny, scratch.data_ptr(),
                  scratch.numel(), out.data_ptr(), int(return_acc), n, BATCH,
                  sms)
    return out
