"""The port's multi-process helpers (``synthpy_tpu_torch.parallel.
multihost``) on ``torch.distributed``.

Two ``gloo`` processes on the CPU run the worker below (``python -c``, each
with its own timeout): ``initialize`` with an explicit coordinator,
``local_ray_slice``, ``host_local_beam_key`` (equal to JAX's ``fold_in``
of the process index, computed here), ``global_ray_array`` and a
ray-parallel ``pipeline.run`` whose rays axis spans the two processes,
equal to the single-process image of the whole bundle. The single-process
tests hold ``initialize``'s no-op and idempotence.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from synthpy_tpu_torch.parallel import multihost

# one intra-op thread: the suite runs one worker process per core
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120     # seconds a worker may take

WORKER = r'''
import sys
import numpy as np
import torch

torch.set_num_threads(1)
pid, port, k0, k1 = (int(a) for a in sys.argv[1:5])
sys.path.insert(0, sys.argv[5])

from synthpy_tpu_torch import pipeline, random
from synthpy_tpu_torch.fields import ScalarDomain
from synthpy_tpu_torch.parallel import multihost, ray_mesh

multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid,
                     backend="gloo")
multihost.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
assert multihost.process_count() == 2
assert multihost.process_index() == pid
assert multihost.local_ray_slice(10) == (5 * pid, 5)
key = multihost.host_local_beam_key(random.PRNGKey(7))
assert key.tolist() == [k0, k1], key.tolist()

local = torch.full((4, 3), float(pid + 1))
arr = multihost.global_ray_array(local)
assert arr.shape == (8, 3) and float(arr.sum()) == 36.0
assert torch.equal(arr[4 * pid:4 * pid + 4], local)

# each process traces its own slice; the rays axis spans the processes
ext = 5e-3
dom = ScalarDomain(2 * ext, 16, device="cpu").test_lens(ne_0=5e24,
                                                        LR=1.5e-3)
rng = np.random.default_rng(3)
N = 512
s_full = np.zeros((9, N), np.float32)
s_full[0:2] = rng.uniform(-3e-3, 3e-3, (2, N))
s_full[2] = -ext
s_full[3:5] = rng.normal(0.0, 1e-3, (2, N)) * 2.99792458e8
s_full[5] = 2.99792458e8
s_full[6] = 1.0
s_full = torch.tensor(s_full)
kw = dict(diagnostic="shadowgraphy", solver="zscan_seg", seg_K=8,
          bins=(24, 18))
ref = pipeline.run(dom, s_full, **kw)
mesh = ray_mesh(devices=["cpu", "cpu"])
assert mesh.process_axis == "rays"
start, count = multihost.local_ray_slice(N)
img = pipeline.run(dom, s_full[:, start:start + count].contiguous(),
                   mesh=mesh, **kw)
assert torch.equal(img, ref), float((img - ref).abs().max())
assert float(img.sum()) > 0.5 * N
print(f"WORKER_OK {pid}", flush=True)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_share_a_rays_axis():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = []
    for pid in range(2):
        k = np.asarray(jax.random.fold_in(jax.random.PRNGKey(7), pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(pid), str(port),
             str(int(k[0])), str(int(k[1])), ROOT],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert f"WORKER_OK {pid}" in out


@pytest.fixture
def no_job(monkeypatch):
    for size_var, rank_var in multihost._DIST_ENV:
        monkeypatch.delenv(size_var, raising=False)
        monkeypatch.delenv(rank_var, raising=False)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    return monkeypatch


def test_initialize_without_a_job_is_a_no_op(no_job):
    multihost.initialize()
    assert not multihost.is_initialized()
    assert multihost.local_ray_slice(1000) == (0, 1000)
    assert multihost.process_count() == 1
    local = torch.arange(6.0).reshape(3, 2)
    assert multihost.global_ray_array(local) is local
    # a job of one process is single-process too
    no_job.setenv("SLURM_NTASKS", "1")
    multihost.initialize()
    assert not multihost.is_initialized()
    # a job of two without a coordinator cannot connect
    no_job.setenv("OMPI_COMM_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multihost.initialize()
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize("localhost:1")


def test_initialize_is_idempotent(no_job):
    import torch.distributed as dist

    port = _free_port()
    multihost.initialize(f"localhost:{port}", num_processes=1, process_id=0,
                         backend="gloo")
    try:
        assert multihost.is_initialized()
        group = dist.group.WORLD
        multihost.initialize(f"localhost:{port}", num_processes=1,
                             process_id=0)
        multihost.initialize()
        assert dist.group.WORLD is group
        assert multihost.process_index() == 0
        np.testing.assert_array_equal(
            multihost.host_local_beam_key([0, 7]).numpy(),
            np.asarray(jax.random.fold_in(jax.random.PRNGKey(7), 0)))
    finally:
        dist.destroy_process_group()
    assert not multihost.is_initialized()
