"""Device meshes: ray data-parallelism, grid sharding and the collectives
between shards (PyTorch port of ``synthpy_tpu.parallel.mesh``).

A ``Mesh`` is single-controller, as a ``jax.sharding.Mesh`` is: one
process holds every device of the mesh and drives each shard's work in
turn, on the current stream of the shard's device, with the collectives as
plain functions over the per-shard tensors between the phases of that
work (``psum``: each shard receives the sum over an axis, added in shard
order 0..G-1, computed once per distinct device; ``ppermute``: a copy to
the target shard's device). With one card the shards run in turn; on
distinct cards their launches overlap.

A device may repeat. ``Mesh((4,), ("grid",), devices=["cuda:0"] * 4)``
runs a 4-way grid on one H100, as the JAX package's tests run every mesh
mode on 8 fake CPU devices (``tests/conftest.py``); the repeated-device
mesh is the port's counterpart of that fake-device mesh, not a mode of its
own, and the CPU tests use ``["cpu"] * 8``. The constructors place shards
on distinct cards where ``torch.cuda.device_count()`` allows, or on the
devices they are given.

Values split over a mesh are ``Sharded``: the per-shard tensors and a spec
naming the mesh axis each dimension is split over (JAX's ``PartitionSpec``);
``gather()`` gives the whole tensor back, ``map`` (and adding or
multiplying by a Python number) works shard by shard. ``shard_rays`` and
``replicate`` make them, as do ``fields.grf.grf_domain_fft(mesh=)`` and
``tracer.zscan.build_segment_pack_device(mesh=)``; the tracers below,
``sharded_histogram`` and ``pipeline.run(mesh=)`` take them or plain
tensors. ``all_to_all`` moves a split from one dimension to another (the
sharded FFT's transposes) and ``pmax`` reduces over an axis.

The mesh modes:

* rays split over a ``rays`` axis (``pipeline.run(mesh=)``: each shard runs
  the single-device path and the images are psummed; ``sharded_histogram``:
  K3's ``bin_image`` a shard, then a psum);
* the field split along a transverse axis over a ``grid`` axis, with a
  one-row halo from the right neighbour: ``make_gridsharded_segment_tracer``
  (kernel K17, ``kernels.march_sharded``, one launch a device and segment
  for the device's shards; where the line spans several devices, each
  reads the rows the others own, ``march_sharded.exchange_rows``) and
  ``make_gridsharded_tracer``
  (the time tracer; kernel K18, ``kernels.sharded_rhs``, one launch a
  device and stage: the stage's update and the gather of the device's
  shards, then a psum of the devices' partials where the line spans
  several);
* the segments split by probing depth over a ``seg`` axis
  (``parallel.pipeline_pp``).

Across processes (``parallel.multihost``) a mesh holds this process's
devices; its ``process_axis`` (a rays axis) is the one that spans the
processes, and a psum over it also all-reduces over the default process
group. A grid or seg axis cannot span processes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from synthpy_tpu_torch.fields.domain import ChannelLayout
from synthpy_tpu_torch.kernels import march as _march
from synthpy_tpu_torch.kernels import march_sharded as _owned
from synthpy_tpu_torch.kernels import sharded_rhs as _rhs
from synthpy_tpu_torch.kernels.time_march import Steps
from synthpy_tpu_torch.parallel import multihost


def _visible_devices() -> List[torch.device]:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass devices=['cpu'] * n to run "
            "a mesh of the plain PyTorch versions on the host")
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """A mesh of torch devices: ``axis_names``, ``shape`` (name -> size,
    as JAX's ``mesh.shape``) and ``devices``, an object array of
    ``torch.device`` of that shape. ``devices`` (default: the visible
    CUDA devices) may repeat a device. ``process_axis``: the axis that
    spans the processes of the default process group, or None."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices=None, process_axis: Optional[str] = None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names) or min(shape, default=0) < 1:
            raise ValueError(f"bad mesh shape {shape} / axes {axis_names}")
        n = math.prod(shape)
        devs = (_visible_devices() if devices is None
                else [torch.device(d) for d in devices])
        if n > len(devs):
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} wants {n} "
                             f"devices; torch sees {len(devs)}")
        if process_axis is not None and process_axis not in axis_names:
            raise ValueError(f"process axis {process_axis!r} not in "
                             f"{axis_names}")
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, shape))
        arr = np.empty(n, dtype=object)
        for i, d in enumerate(devs[:n]):
            arr[i] = d
        self.devices = arr.reshape(shape)
        self.process_axis = process_axis

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def flat_devices(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    def index(self, pos: int, axis: str) -> int:
        """Coordinate of flat position ``pos`` along ``axis``."""
        coords = np.unravel_index(pos, self.devices.shape)
        return int(coords[self.axis_names.index(axis)])

    def groups(self, axis: str) -> List[List[int]]:
        """The flat positions of each line of the mesh along ``axis``, in
        axis order."""
        ax = self.axis_names.index(axis)
        pos = np.arange(self.size).reshape(self.devices.shape)
        lines = np.moveaxis(pos, ax, -1).reshape(-1, self.shape[axis])
        return [[int(p) for p in line] for line in lines]

    def placement(self) -> List[str]:
        """Each shard's device, in flat order (what a run prints)."""
        return [str(d) for d in self.flat_devices]

    def __repr__(self):
        return (f"Mesh({self.shape}, devices={self.placement()}"
                + (f", process_axis={self.process_axis!r})"
                   if self.process_axis else ")"))


def ray_mesh(n_devices: Optional[int] = None, axis: str = "rays",
             devices=None) -> Mesh:
    """1-D mesh over (up to ``n_devices`` of) the visible CUDA devices or
    ``devices``. Inside a multi-process job (``multihost.initialize``) the
    axis spans the processes."""
    devs = (_visible_devices() if devices is None
            else [torch.device(d) for d in devices])
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh((len(devs),), (axis,), devices=devs,
                process_axis=axis if multihost.process_count() > 1 else None)


def mesh_from_spec(spec: str, grid_axis: Optional[str] = None,
                   pp_axis: Optional[str] = None, devices=None):
    """Parse an ``'axis=N[,axis=N]'`` mesh spec (the CLI surface) into a
    Mesh plus the resolved grid axis name, as the JAX package does:
    ``'rays=8'``, ``'grid=4,rays=2'``, ``'seg=8'`` with ``pp_axis='seg'``;
    the grid axis defaults to ``'grid'`` when the spec names one. Raises
    ValueError on malformed specs, unknown grid/pp axes, a missing
    rays/grid/pp axis, or too few devices."""
    try:
        parsed = {}
        for part in spec.split(","):
            name, _, size = part.partition("=")
            parsed[name.strip()] = int(size)
    except ValueError:
        raise ValueError(f"bad mesh spec {spec!r}; expected "
                         "'axis=N[,axis=N]' e.g. 'grid=4,rays=2'")
    grid_axis = grid_axis or ("grid" if "grid" in parsed else None)
    if grid_axis is not None and grid_axis not in parsed:
        raise ValueError(f"grid axis {grid_axis!r} not in mesh spec "
                         f"{spec!r}")
    if pp_axis is not None and pp_axis not in parsed:
        raise ValueError(f"pp axis {pp_axis!r} not in mesh spec {spec!r}")
    if "rays" not in parsed and grid_axis is None and pp_axis is None:
        raise ValueError("mesh spec needs a 'rays' axis and/or a grid "
                         "axis / pp axis")
    devs = (_visible_devices() if devices is None
            else [torch.device(d) for d in devices])
    n_want = math.prod(parsed.values())
    if n_want > len(devs):
        raise ValueError(f"mesh spec {spec!r} wants {n_want} devices; "
                         f"torch sees {len(devs)}")
    return Mesh(tuple(parsed.values()), tuple(parsed.keys()),
                devices=devs), grid_axis


def grid_ray_mesh(n_grid: int, n_rays: Optional[int] = None,
                  devices=None) -> Mesh:
    """2-D mesh: a ``grid`` axis shards the field, a ``rays`` axis the
    bundle."""
    devs = (_visible_devices() if devices is None
            else [torch.device(d) for d in devices])
    if n_rays is None:
        n_rays = len(devs) // n_grid
    return Mesh((n_grid, n_rays), ("grid", "rays"),
                devices=devs[:n_grid * n_rays])


def local_axis(mesh: Mesh, axis: str, what: str) -> None:
    """Raise unless ``axis`` is a mesh axis this process holds whole."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no {axis!r} axis")
    if axis == mesh.process_axis:
        raise NotImplementedError(
            f"{what} over the {axis!r} axis that spans processes: only a "
            "rays axis may span processes (ROADMAP A.17)")


# ---------------------------------------------------------------------------
# Values split over a mesh
# ---------------------------------------------------------------------------

class Sharded:
    """A tensor split over a mesh: ``shards[p]`` is the block held by flat
    position ``p`` of ``mesh``, on its device; ``spec[d]`` names the mesh
    axis dimension d is split over, or None (every shard holds all of it);
    ``shape`` is the whole tensor's. At most one dimension is split."""

    def __init__(self, mesh: Mesh, spec: Sequence[Optional[str]],
                 shards: Sequence[torch.Tensor], shape: Sequence[int]):
        self.mesh = mesh
        self.spec = tuple(spec)
        self.shards = list(shards)
        self.shape = tuple(shape)
        if len(self.shards) != mesh.size:
            raise ValueError("one shard per mesh position")
        if sum(a is not None for a in self.spec) > 1:
            raise ValueError("at most one dimension may be split")

    def split_dim(self) -> Optional[int]:
        for d, a in enumerate(self.spec):
            if a is not None:
                return d
        return None

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor, on ``device`` (default: the first shard's)."""
        dev = self.shards[0].device if device is None else torch.device(
            device)
        dim = self.split_dim()
        if dim is None:
            return self.shards[0].to(dev)
        axis = self.spec[dim]
        # the first line along the split axis holds one block of each
        line = self.mesh.groups(axis)[0]
        return torch.cat([self.shards[p].to(dev) for p in line], dim=dim)

    def map(self, fn) -> "Sharded":
        """``fn`` of each shard, computed once per distinct block tensor;
        ``fn`` keeps a block's shape (an elementwise function)."""
        done = {}
        for s in self.shards:
            if id(s) not in done:
                out = fn(s)
                if tuple(out.shape) != tuple(s.shape):
                    raise ValueError("Sharded.map needs a function that "
                                     "keeps each block's shape")
                done[id(s)] = out
        return Sharded(self.mesh, self.spec,
                       [done[id(s)] for s in self.shards], self.shape)

    def _scalar(self, v, fn) -> "Sharded":
        if not isinstance(v, (int, float)):
            return NotImplemented
        return self.map(lambda s: fn(s, v))

    def __add__(self, v):
        return self._scalar(v, lambda s, v: s + v)

    def __radd__(self, v):
        return self._scalar(v, lambda s, v: v + s)

    def __mul__(self, v):
        return self._scalar(v, lambda s, v: s * v)

    def __rmul__(self, v):
        return self._scalar(v, lambda s, v: v * s)

    def __repr__(self):
        return f"Sharded(shape={self.shape}, spec={self.spec}, {self.mesh})"


def shard(x: torch.Tensor, mesh: Mesh, spec) -> Sharded:
    """``x`` split over ``mesh`` by ``spec`` (JAX's ``device_put`` with a
    ``NamedSharding``): one copy per (block, device), none where the block
    already lies on the shard's device (then it is a view of ``x``)."""
    spec = tuple(spec) + (None,) * (x.dim() - len(spec))
    dim = next((d for d, a in enumerate(spec) if a is not None), None)
    cache = {}
    shards = []
    for p, dev in enumerate(mesh.flat_devices):
        if dim is None:
            b = 0
            block = x
        else:
            n = mesh.shape[spec[dim]]
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(x.shape)} does "
                                 f"not divide over the {n}-way "
                                 f"{spec[dim]!r} axis")
            per = x.shape[dim] // n
            b = mesh.index(p, spec[dim])
            block = x.narrow(dim, b * per, per)
        key = (b, dev)
        if key not in cache:
            cache[key] = block.to(dev)
        shards.append(cache[key])
    return Sharded(mesh, spec, shards, x.shape)


def as_sharded(x, mesh: Mesh, spec) -> Sharded:
    """``x`` (a tensor or a ``Sharded`` of this mesh and spec) as a
    ``Sharded``."""
    if isinstance(x, Sharded):
        spec = tuple(spec) + (None,) * (len(x.shape) - len(spec))
        if x.mesh is not mesh or x.spec != spec:
            raise ValueError(f"a value sharded as {x.spec} on {x.mesh} is "
                             f"not sharded as {spec} on {mesh}")
        return x
    return shard(x, mesh, spec)


def shard_rays(s_rows: torch.Tensor, mesh: Mesh,
               axis: str = "rays") -> Sharded:
    """(N, ...) ray rows split by rows over ``axis``; N is truncated to a
    multiple of the axis size, like the JAX package (and the reference's
    CPU sharding path)."""
    n = mesh.shape[axis]
    N = (s_rows.shape[0] // n) * n
    if N == 0:
        raise ValueError(f"not enough rays to shard over {n} devices")
    return shard(s_rows[:N], mesh, (axis,))


def replicate(x: torch.Tensor, mesh: Mesh) -> Sharded:
    """``x`` on every device of the mesh (one copy per distinct device)."""
    return shard(x, mesh, ())


# ---------------------------------------------------------------------------
# Collectives over per-shard lists (one entry per flat mesh position)
# ---------------------------------------------------------------------------

def line_sum(xs: Sequence[torch.Tensor], devs: Sequence[torch.device],
             across: bool) -> Dict[torch.device, torch.Tensor]:
    """The sum of one line's values, added in shard order, on each distinct
    device of the line (all-reduced over the processes of the default
    group when ``across``)."""
    across = across and multihost.is_initialized()
    done = {}
    for dev in devs:
        if dev not in done:
            acc = xs[0].to(dev)
            for x in xs[1:]:
                acc = acc + x.to(dev)
            done[dev] = multihost.all_reduce(acc) if across else acc
    return done


def psum(xs: Sequence[torch.Tensor], mesh: Mesh,
         axis: str) -> List[torch.Tensor]:
    """Each shard receives the sum of ``xs`` over its line along ``axis``,
    added in shard order 0..G-1, once per distinct device of the line;
    shards on one device share the result. Over the process axis the sum
    is then all-reduced across the processes."""
    out = list(xs)
    across = axis == mesh.process_axis
    devs = mesh.flat_devices
    for line in mesh.groups(axis):
        sums = line_sum([xs[p] for p in line], [devs[p] for p in line],
                         across)
        for p in line:
            out[p] = sums[devs[p]]
    return out


def ppermute(xs: Sequence[torch.Tensor], mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Along each line of ``axis``, shard ``dst`` receives shard ``src``'s
    value for every (src, dst) of ``perm``, copied to its device; a shard
    that receives nothing gets zeros (``jax.lax.ppermute``)."""
    out = [None] * len(xs)
    for line in mesh.groups(axis):
        for src, dst in perm:
            p = line[dst]
            out[p] = xs[line[src]].to(mesh.flat_devices[p])
        for p in line:
            if out[p] is None:
                out[p] = torch.zeros_like(xs[p])
    return out


def all_to_all(xs: Sequence[torch.Tensor], mesh: Mesh, axis: str,
               split_dim: int, concat_dim: int) -> List[torch.Tensor]:
    """Along each line of ``axis`` (G shards), shard h receives block h of
    every shard's value split G ways along ``split_dim``, concatenated in
    shard order along ``concat_dim`` (``jax.lax.all_to_all``): a value
    split over the axis along ``concat_dim`` comes out split along
    ``split_dim``. One copy of each block to its receiver's device."""
    G = mesh.shape[axis]
    out = [None] * len(xs)
    for line in mesh.groups(axis):
        n = xs[line[0]].shape[split_dim]
        if n % G:
            raise ValueError(f"dimension {split_dim} ({n}) does not divide "
                             f"over the {G}-way {axis!r} axis")
        for h, p in enumerate(line):
            dev = mesh.flat_devices[p]
            out[p] = torch.cat([xs[q].narrow(split_dim, h * (n // G),
                                             n // G).to(dev)
                                for q in line], dim=concat_dim)
    return out


def pmax(xs: Sequence[torch.Tensor], mesh: Mesh,
         axis: str) -> List[torch.Tensor]:
    """Each shard receives the elementwise maximum of ``xs`` over its line
    along ``axis``, on its device (exact in any order)."""
    out = list(xs)
    devs = mesh.flat_devices
    for line in mesh.groups(axis):
        m = xs[line[0]]
        for p in line[1:]:
            m = torch.maximum(m, xs[p].to(m.device))
        for p in line:
            out[p] = m.to(devs[p])
    return out


# ---------------------------------------------------------------------------
# Grid-sharded time tracer (K18)
# ---------------------------------------------------------------------------

def _ray_axis(mesh: Mesh, ray_axis: Optional[str]) -> Optional[str]:
    return ray_axis if ray_axis is not None and ray_axis in mesh.shape \
        else None


def _blocks(mesh: Mesh, ray_axis: Optional[str]):
    """Per flat position, the key (ray block, device) of the state it
    shares with the positions of other grid indices."""
    return [((mesh.index(p, ray_axis) if ray_axis else 0), dev)
            for p, dev in enumerate(mesh.flat_devices)]


def _result(u_sh: Sharded, states: dict, keys, was_sharded: bool):
    """The per-block results laid out as the input was."""
    res = Sharded(u_sh.mesh, u_sh.spec, [states[k] for k in keys],
                  u_sh.shape)
    return res if was_sharded else res.gather()


def make_gridsharded_tracer(mesh: Mesh, layout: ChannelLayout, n_steps: int,
                            nx_global: int, atten_sign: float = -1.0,
                            grid_axis: str = "grid",
                            ray_axis: Optional[str] = "rays"):
    """The time tracer (fixed-step RK4) with the field split along x over
    ``grid_axis`` and the rays over ``ray_axis`` (when the mesh has it).

    Returns ``f(s_rows, channels, origin, inv_spacing, dt) -> s_rows_final``
    with ``s_rows`` (N, 9) (a tensor or ``Sharded`` over ``ray_axis``) and
    ``channels`` the (nx, ny, nz, C) grid (a tensor, split here, or a
    ``Sharded`` over ``grid_axis``). Shard g holds x-rows [g nloc, (g+1)
    nloc) and the first row of shard g+1 (cyclic), ppermuted once. Each
    device runs one K18 launch a stage (``kernels.sharded_rhs.Trace``): it
    finishes the stage from the channel values summed over the grid line
    and gathers, at the new stage state, the values of the queries its
    shards own into one partial; the partials of the line's devices are
    added in shard order between launches (nothing to add when one device
    holds the line). The JAX program rounds the same way (held bit for bit
    on the CPU); it differs from the unsharded tracer by the shards' moved
    origins, within 1e-4 of each column's scale."""
    local_axis(mesh, grid_axis, "the grid-sharded tracer")
    G = mesh.shape[grid_axis]
    r_ax = _ray_axis(mesh, ray_axis)
    if nx_global % G:
        raise ValueError(f"nx {nx_global} must divide over the {G}-way "
                         f"{grid_axis!r} axis")
    nloc = nx_global // G
    keys = _blocks(mesh, r_ax)
    # the positions each block (ray block, device) holds on its grid line,
    # in shard order, and each line's blocks in the order of its shards
    held: Dict[tuple, List[int]] = {}
    for p, k in enumerate(keys):
        held.setdefault(k, []).append(p)
    lines = [list(dict.fromkeys(keys[p] for p in line))
             for line in mesh.groups(grid_axis)]

    def tracer(s_rows, channels, origin, inv_spacing, dt):
        was = isinstance(s_rows, Sharded)
        s_sh = as_sharded(s_rows, mesh, (r_ax, None))
        ch_sh = as_sharded(channels, mesh, (grid_axis, None, None, None))
        if ch_sh.shape[0] != nx_global:
            raise ValueError(f"channels have {ch_sh.shape[0]} x-rows, "
                             f"nx_global={nx_global}")
        o = [float(v) for v in torch.as_tensor(origin).tolist()]
        iv = [float(v) for v in torch.as_tensor(inv_spacing).tolist()]
        kw = dict(origin=o, inv_spacing=iv, nx_global=nx_global,
                  steps=Steps.of(float(dt)), layout=layout,
                  atten_sign=atten_sign)
        # the halo: the first x-row of the right neighbour
        halo = ppermute([c[0].contiguous() for c in ch_sh.shards], mesh,
                        grid_axis, [(i, (i - 1) % G) for i in range(G)])
        traces, orders = {}, {}
        for k, ps in held.items():
            s = s_sh.shards[ps[0]].to(torch.float32).contiguous()
            # march in entry-cell order: a warp's gathers share grid rows
            order = _march.ray_order(s, ch_sh.shape[:3], o, iv)
            shards = [_rhs.Shard(ch_sh.shards[p], halo[p],
                                 mesh.index(p, grid_axis) * nloc,
                                 mesh.index(p, grid_axis) == G - 1)
                      for p in ps]
            traces[k] = _rhs.Trace(s[order].T.contiguous(), shards, **kw)
            orders[k] = order

        def summed():
            """Each block's sum of its line's partials (the partial itself
            where one device holds the line: nothing is added). A partial
            is overwritten in place by its device's next launch: PyTorch
            runs a copy between cards on the source card's current stream,
            the stream the launch goes to, after a barrier with the
            destination's, so the launch follows every copy that reads
            the partial, and each card adds only after its copies land."""
            out = {}
            for line in lines:
                sums = line_sum([traces[k].vals for k in line],
                                [k[1] for k in line], False)
                out.update((k, sums[k[1]]) for k in line)
            return out

        for tr in traces.values():
            tr.stage(None, None, True)
        for step in range(n_steps):
            for stage in range(4):
                sums = summed()
                more = step < n_steps - 1 or stage < 3
                for k, tr in traces.items():
                    tr.stage(sums[k], stage, more)
        out = {}
        for k, tr in traces.items():
            res = torch.empty(tr.s.shape[::-1], dtype=tr.s.dtype,
                              device=tr.s.device)
            res[orders[k]] = tr.s.T
            out[k] = res
        return _result(s_sh, out, keys, was)

    return tracer


# ---------------------------------------------------------------------------
# Grid-sharded segmented march (K17)
# ---------------------------------------------------------------------------

def make_gridsharded_segment_tracer(mesh: Mesh, layout: ChannelLayout,
                                    spack, *, grid_axis: str = "grid",
                                    ray_axis: Optional[str] = None,
                                    substeps: int = 1,
                                    atten_sign: float = -1.0,
                                    integrator: str = "rk4",
                                    unroll: int = 2,
                                    weights: str = "stage",
                                    table_na: Optional[int] = None):
    """The segmented march with the FIELD split along the transverse a-axis
    over ``grid_axis`` (the fast path for fields above one device).

    Shard g holds a-rows [g naloc, (g+1) naloc) of every segment's corner
    table, naloc = table_na / G, plus the first a-row of its right
    neighbour (one ppermute a call). For each segment, each device runs one
    K17 launch (``kernels.march_sharded``) over its ray block: a ray whose
    corner cell, frozen at the segment's start, lies in one of the
    device's shards is marched with the global indices, fractions and
    inside-mask of K1 and the corner rows read from that shard's table,
    with the psum's rounding of JAX's program (+ 0.0 on a line of G > 1
    shards); the other rays get zeros. Where one device holds the whole
    line, that launch is the result; otherwise each device reads the rows
    the others own from their results (``march_sharded.exchange_rows``,
    one launch a device), which equals JAX's psum of the masked results
    bit for bit. Owned rays are bit-identical to the single-device
    march (up to the sign of a zero on G > 1, as in JAX).
    ``table_na``: the tables' a-rows (default the pack's na); a pack whose
    na does not divide over the axis is padded with zero a-rows to it by
    the caller (``pipeline.run``), which no ray ever owns. ``ray_axis``
    splits the rays as well on a 2-D mesh. ``unroll`` is accepted as in
    the JAX package.

    Returns ``f(u, seg_tables, origin_ab, inv_ab, dp) -> uf`` with ``u``
    the (N, 8) permuted state (a tensor, or ``Sharded`` over
    ``ray_axis``) and ``seg_tables`` the (n_seg, table_na, nb, row) tables
    (a tensor, or ``Sharded`` over ``grid_axis`` on dimension 1); the
    result is laid out as ``u`` is.
    """
    from synthpy_tpu_torch.tracer.zscan import check_march

    del unroll
    local_axis(mesh, grid_axis, "the grid-sharded segment march")
    scales = spack.scales
    qbits = spack.qbits
    check_march(integrator, weights, spack.K, qbits, scales, substeps)
    G = mesh.shape[grid_axis]
    na, nb = spack.shape_ab
    if table_na is None:
        table_na = na
    if table_na % G:
        raise ValueError(
            f"transverse a-dim {table_na} must divide over the {G}-way "
            f"{grid_axis!r} axis (pad the segment tables with zero a-rows "
            "to a multiple; pipeline.run(grid_axis=) does this)")
    if table_na < na:
        raise ValueError(f"table_na {table_na} < shape_ab a-dim {na}")
    naloc = table_na // G
    K = spack.K
    r_ax = _ray_axis(mesh, ray_axis)
    keys = _blocks(mesh, r_ax)
    # the positions each block (ray block, device) holds on its grid line,
    # in shard order, and each line's blocks in the order of their shards
    held: Dict[tuple, List[int]] = {}
    for p, k in enumerate(keys):
        held.setdefault(k, []).append(p)
    lines = [list(dict.fromkeys(keys[p] for p in line))
             for line in mesh.groups(grid_axis)]
    # on a line over several devices, each shard's block in the line
    block_of = {k: [line.index(keys[p]) for p in group]
                for line, group in zip(lines, mesh.groups(grid_axis))
                for k in line if len(line) > 1}

    def tracer(u, seg_tables, origin_ab, inv_ab, dp):
        was = isinstance(u, Sharded)
        u_sh = as_sharded(u, mesh, (r_ax, None))
        if isinstance(seg_tables, Sharded):
            t_sh = seg_tables
            if t_sh.mesh is not mesh or t_sh.spec[:2] != (None, grid_axis):
                raise ValueError("seg_tables must be split over the grid "
                                 "axis on dimension 1")
            tabs = [t.reshape(t.shape[0], naloc, nb, -1)
                    for t in t_sh.shards]
        else:
            if seg_tables.dim() == 3:
                seg_tables = seg_tables.reshape(seg_tables.shape[0],
                                                table_na, nb, -1)
            if tuple(seg_tables.shape[1:3]) != (table_na, nb):
                raise ValueError(f"seg_tables {tuple(seg_tables.shape)} are "
                                 f"not (n_seg, {table_na}, {nb}, row)")
            tabs = shard(seg_tables, mesh, (None, grid_axis)).shards
        n_seg = tabs[0].shape[0]
        if scales is not None and scales.shape[0] != n_seg:
            raise ValueError(f"{scales.shape[0]} scale rows for {n_seg} "
                             "segments")
        halo = ppermute([t[:, 0] for t in tabs], mesh, grid_axis,
                        [(i, (i - 1) % G) for i in range(G)])
        sc = (None if scales is None
              else replicate(scales, mesh).shards)
        o_ab = [float(v) for v in torch.as_tensor(origin_ab).tolist()]
        i_ab = [float(v) for v in torch.as_tensor(inv_ab).tolist()]
        kw = dict(shape_ab=(na, nb), origin_ab=o_ab, inv_ab=i_ab,
                  dp=float(dp), layout=layout, K=K, integrator=integrator,
                  weights=weights, qbits=qbits, atten_sign=atten_sign,
                  naloc=naloc, line_shards=G)
        cur, orders = {}, {}
        for k, ps in held.items():
            x = u_sh.shards[ps[0]].contiguous()
            if x.data_ptr() % 16:
                x = x.clone()
            cur[k] = x
            orders[k] = (None if x.device.type == "cpu" else
                         _march.ray_order(x, (na, nb), o_ab, i_ab))
        spread = [line for line in lines if len(line) > 1]
        for s in range(n_seg):
            outs = {k: _owned.march_shards(
                cur[k], [_owned.Shard(tabs[p][s], halo[p][s],
                                      mesh.index(p, grid_axis) * naloc)
                         for p in ps],
                None if sc is None else sc[ps[0]][s], order=orders[k], **kw)
                for k, ps in held.items()}
            # a device's result is read by its peers' exchange; the exchange
            # ends with every device's stream waiting for every peer's
            # launch, so no later work on the device, the reuse of that
            # memory by its allocator after the last segment included,
            # runs before those reads end
            for line in spread:
                _owned.exchange_rows(
                    [outs[k] for k in line], [cur[k] for k in line],
                    block_of[line[0]], naloc=naloc, na=na, origin_a=o_ab[0],
                    inv_a=i_ab[0])
            cur = outs
        return _result(u_sh, cur, keys, was)

    return tracer


# ---------------------------------------------------------------------------
# Sharded detector reduction
# ---------------------------------------------------------------------------

def sharded_histogram(mesh: Mesh, bins, range_, ray_axis: str = "rays"):
    """``f(x, y, w) -> (ny, nx)`` over rays split over ``ray_axis``: K3's
    ``bin_image`` (``ops.histogram.histogram2d``) on each shard's rays,
    then a psum (the reference's MPI ``comm.reduce(H, SUM)``). ``x``, ``y``
    and ``w`` are (N,) tensors (split here, N a multiple of the axis) or
    ``Sharded`` over ``ray_axis``."""
    from synthpy_tpu_torch.ops.histogram import histogram2d

    def hist(x, y, w):
        xs, ys, ws = (as_sharded(v, mesh, (ray_axis,)).shards
                      for v in (x, y, w))
        # one line along the ray axis holds every ray block once
        line = mesh.groups(ray_axis)[0]
        devs = [mesh.flat_devices[p] for p in line]
        parts = [histogram2d(xs[p], ys[p], bins, range_, weights=ws[p])[0]
                 for p in line]
        return line_sum(parts, devs,
                        ray_axis == mesh.process_axis)[devs[0]]

    return hist
