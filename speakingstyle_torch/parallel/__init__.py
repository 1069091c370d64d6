"""Parallelism: the (data, model) process group (``mesh.py``), the launcher
of its rank processes (``launch.py``), the tensor-parallel layout
(``partition.py``) and its collectives (``tensor.py``), program preparation
and the precision casts (``registry.py``), and the sequence axis: its mesh
(``mesh.py``'s ``SeqMesh``) and ring attention (``ring_attention.py``)
(JAX counterpart: speakingstyle_tpu/parallel)."""

from speakingstyle_torch.parallel.mesh import (
    BatchShardingError,
    Mesh,
    SeqMesh,
    init_distributed,
    local_batch_size,
    make_mesh,
    make_seq_mesh,
    resolve_mesh,
    shard_batch,
)

__all__ = [
    "BatchShardingError",
    "Mesh",
    "SeqMesh",
    "init_distributed",
    "local_batch_size",
    "make_mesh",
    "make_seq_mesh",
    "resolve_mesh",
    "shard_batch",
]
