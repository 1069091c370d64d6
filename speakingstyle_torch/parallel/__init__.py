"""Parallelism: the (data, model) process group (``mesh.py``), the launcher
of its rank processes (``launch.py``), the tensor-parallel layout
(``partition.py``) and its collectives (``tensor.py``), program preparation
and the precision casts (``registry.py``) (JAX counterpart:
speakingstyle_tpu/parallel). The sequence axis waits for ROADMAP.md queue A
item 6c."""

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
