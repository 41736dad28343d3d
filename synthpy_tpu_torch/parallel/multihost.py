"""Multi-process execution helpers on ``torch.distributed`` (PyTorch port
of ``synthpy_tpu.parallel.multihost``).

The reference's mpi4py layer (rank-parallel bundles, pickled fields,
MPI-reduced histograms) becomes a process group: each process traces its
own share of the ray bundle on the devices it holds, and the images are
all-reduced. ``initialize`` connects the processes; a mesh made after it
(``parallel.mesh.ray_mesh``) has its rays axis span them, so that
``pipeline.run(mesh=)`` sums every process's image. Only a rays axis may
span processes; a grid or seg axis that would raises
``NotImplementedError`` (ROADMAP A.17).

Single-process runs work unchanged: with no arguments and no job in the
environment, ``initialize`` does nothing, and the helpers act as for one
process.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from synthpy_tpu_torch import random as _random

# Environment markers of one rank of a multi-process job, with the
# variable that holds the job's process count (torchrun / SLURM / Open MPI
# / MPICH launchers), as the JAX package's _DIST_ENV_VARS
_DIST_ENV = (
    ("WORLD_SIZE", "RANK"),
    ("SLURM_NTASKS", "SLURM_PROCID"),
    ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"),
    ("PMI_SIZE", "PMI_RANK"),
)


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _job_from_env() -> Optional[Tuple[int, int]]:
    """(world size, rank) of the job the environment names, or None for a
    single process (no marker, or a job of one process)."""
    for size_var, rank_var in _DIST_ENV:
        size = os.environ.get(size_var)
        if size and int(size) > 1:
            return int(size), int(os.environ.get(rank_var, "0"))
    return None


def _backend(backend: Optional[str]) -> str:
    if backend is not None:
        return backend
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Connect this process to the others of its job.

    ``coordinator_address`` ("host:port", rank 0's), ``num_processes`` and
    ``process_id`` give the group explicitly. With no arguments the
    environment decides: a job of more than one process named by
    ``WORLD_SIZE`` (with ``MASTER_ADDR`` / ``MASTER_PORT``), SLURM, Open
    MPI or MPICH variables connects through ``MASTER_ADDR:MASTER_PORT``;
    otherwise this is a no-op. The backend is ``nccl`` on a host with a
    card and ``gloo`` without, unless ``backend`` says. Idempotent: once
    connected, later calls return at once.
    """
    if is_initialized():
        return
    dist = _dist()
    backend = _backend(backend)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes "
                             "and process_id")
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
        return
    job = _job_from_env()
    if job is None:
        return  # a single-process run: leave torch.distributed untouched
    world, rank = job
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if not addr or not port:
        raise RuntimeError(
            f"the environment names a job of {world} processes but no "
            "MASTER_ADDR / MASTER_PORT; pass coordinator_address=")
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            world_size=world, rank=rank)


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def local_ray_slice(total_rays: int) -> Tuple[int, int]:
    """(start, count) of this process's share of a global ray bundle; the
    bundle is floored to a multiple of the process count, like the
    reference floors Np to the core count."""
    n_proc = process_count()
    per = total_rays // n_proc
    return process_index() * per, per


def host_local_beam_key(key) -> torch.Tensor:
    """``key`` with the process index folded in (``random.fold_in``), so
    that every process draws a distinct, deterministic sub-bundle: the same
    key as JAX's ``fold_in(key, jax.process_index())``."""
    return _random.fold_in(key, process_index())


def global_ray_array(local_rows: torch.Tensor, mesh=None) -> torch.Tensor:
    """The (N_global, ...) rows of every process, in rank order, on every
    process (an all-gather of each process's ``local_rows``, which must
    have the same shape on all of them). ``mesh`` is accepted as in the
    JAX package; without a process group this process's rows are the
    whole array."""
    del mesh
    if not is_initialized():
        return local_rows
    dist = _dist()
    x = local_rows.contiguous()
    parts = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the processes of the default group, in place
    on a contiguous ``t`` (returned)."""
    t = t.contiguous()
    _dist().all_reduce(t)
    return t
