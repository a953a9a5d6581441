"""Multi-card detection and training (the JAX package's ``parallel``):
``mesh.py`` (meshes, ``MeshDetector``), ``distributed.py`` (process start-up,
file partitions, the partition-store merge) and ``grid.py`` (the process
grid and collectives of mesh training)."""

from .distributed import init_distributed, merge_partition_stores, partition_files
from .mesh import Mesh, MeshDetector, make_mesh, shard_windows_forward

__all__ = [
    "Mesh",
    "make_mesh",
    "MeshDetector",
    "shard_windows_forward",
    "init_distributed",
    "partition_files",
    "merge_partition_stores",
]
