"""Parallelism: the data-parallel process group (``mesh.py``), the launcher
of its rank processes (``launch.py``), program preparation and the
precision casts (``registry.py``) (JAX counterpart:
speakingstyle_tpu/parallel). Tensor parallelism and the sequence axis wait
for ROADMAP.md queue A items 6b and 6c."""

from speakingstyle_torch.parallel.mesh import (
    BatchShardingError,
    Mesh,
    init_distributed,
    local_batch_size,
    make_mesh,
    resolve_mesh,
    shard_batch,
)

__all__ = [
    "BatchShardingError",
    "Mesh",
    "init_distributed",
    "local_batch_size",
    "make_mesh",
    "resolve_mesh",
    "shard_batch",
]
