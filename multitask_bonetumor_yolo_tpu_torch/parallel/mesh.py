"""Rank mesh and batch sharding (counterpart of the JAX ``parallel/mesh.py``).

The JAX package trains over a ``jax.sharding.Mesh`` of every visible device
with the batch sharded over its ``data`` axis; XLA inserts the collectives.
The port runs one process per rank, one card per rank, in a
``torch.distributed`` group (``parallel/dist.py``): NCCL between cards, gloo
on the CPU. A :class:`Mesh` here is the grid of the group's ranks, laid out
as JAX lays out its devices, and ``shard_batch`` gives this rank its rows of
a global batch. The batch-coupled arithmetic that XLA partitions in JAX is
explicit in the port: the BatchNorm statistics (``models/common.py``), the
loss normalisers (``losses/multitask.py``) and the gradient
(``train/steps.py``) are reduced over the group whenever it has more than
one rank.

A second ``model`` axis is kept, with JAX's checks, though every shipped
configuration and entry point uses the 1-D data mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import dist
from .pack import upload


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """The ranks as a grid ``[data, model]`` (``grid[i, j]`` is a rank),
    the axis names, this process's ``rank`` and the ``device`` its batches
    go to."""

    grid: np.ndarray
    axis_names: tuple
    rank: int
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.grid.shape))

    @property
    def data_index(self) -> int:
        """This rank's position along the ``data`` axis: the block of each
        batch's rows it holds."""
        where = np.argwhere(self.grid == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} is not in the mesh {self.grid.tolist()}")
        return int(where[0][0])


def create_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data", "model"),
    model_parallel: int = 1,
    *,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: torch.device | str | None = None,
) -> Mesh:
    """1-D data mesh by default; pass model_parallel>1 for a 2-D layout.

    The devices are the ranks of the joined group (``world_size`` and
    ``rank`` default to it, else 1 and 0). ``device`` defaults to the
    current card."""
    if world_size is None:
        world_size = dist.world_size()
    if rank is None:
        rank = dist.rank()
    n = n_devices or world_size
    if n > world_size:
        raise ValueError(f"requested {n} devices, have {world_size}")
    if n % model_parallel:
        raise ValueError("n_devices must divide by model_parallel")
    grid = np.arange(n).reshape(n // model_parallel, model_parallel)
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(grid, tuple(axis_names), int(rank), torch.device(device))


def data_sharding(mesh: Mesh, rows: int) -> slice:
    """This rank's rows of a leading dimension of ``rows``: the block at its
    data index (JAX's ``P("data")`` placement of a batch)."""
    n_data = mesh.shape["data"]
    if rows % n_data:
        raise ValueError(f"{rows} rows not divisible by data-axis size {n_data}")
    per = rows // n_data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Make ``tensors`` the same on every rank: the first rank's values are
    broadcast in place (the role of JAX's replicated placement of a
    restored state). Floating tensors travel as one fp32 buffer."""
    if dist.world_size() == 1:
        return
    src = int(mesh.grid.flat[0])
    floats = [t for t in tensors if t.is_floating_point()]
    others = [t for t in tensors if not t.is_floating_point()]
    with torch.no_grad():
        if floats:
            flat = torch.cat([t.detach().reshape(-1).float() for t in floats])
            dist.broadcast_(flat, src)
            for t, v in zip(floats, flat.split([t.numel() for t in floats])):
                t.copy_(v.view_as(t))
        for t in others:
            dist.broadcast_(t, src)


def shard_batch(batch: Dict, mesh: Mesh, local: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's rows of each leaf's leading dim, on the mesh's device.

    The leading (batch) dim must divide the data-axis size: the Trainer
    guarantees this by scaling the global batch to per-device x n_devices
    and by pad_last batches being padded to the full global batch; anything
    else fails loudly here. ``local=True``: ``batch`` already holds only this
    rank's rows (a loader given the rank's shard reads only those), and is
    uploaded as it is. The upload is ``parallel/pack.py``'s."""
    if not local:
        n_data = mesh.shape["data"]
        sizes = {k: np.shape(v)[0] for k, v in batch.items() if np.ndim(v)}
        bad = {k: s for k, s in sizes.items() if s % n_data}
        if bad:
            raise ValueError(
                f"batch dims {bad} not divisible by data-axis size {n_data}; "
                f"use a per-device batch size (global = per_device * {n_data}) "
                f"or a pad_last loader"
            )
        batch = {k: v[data_sharding(mesh, np.shape(v)[0])] if np.ndim(v) else v
                 for k, v in batch.items()}
    return upload(batch, mesh.device)
