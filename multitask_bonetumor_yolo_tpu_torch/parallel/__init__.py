"""Data parallelism over ranks (counterpart of the JAX ``parallel/``): the
rank mesh and batch sharding (``mesh.py``), the process group and its
collectives (``dist.py``), the batch upload (``pack.py``)."""

from .mesh import Mesh, create_mesh, data_sharding, replicate, shard_batch
from .pack import upload

__all__ = ["Mesh", "create_mesh", "data_sharding", "replicate", "shard_batch", "upload"]
