"""Device meshes, sharded tracing and multi-process runs (PyTorch port of
``synthpy_tpu.parallel``)."""

from synthpy_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Sharded,
    all_to_all,
    grid_ray_mesh,
    make_gridsharded_segment_tracer,
    make_gridsharded_tracer,
    mesh_from_spec,
    pmax,
    ppermute,
    psum,
    ray_mesh,
    replicate,
    shard_rays,
    sharded_histogram,
)
from synthpy_tpu_torch.parallel.pipeline_pp import (  # noqa: F401
    make_pipelined_segment_tracer,
)
