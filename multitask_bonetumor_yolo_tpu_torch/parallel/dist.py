"""The process group: joining it, the collectives the port reduces with, and
spawning ranks.

One process per rank, one card per rank. :func:`join` enters a
``torch.distributed`` group from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from
explicit arguments with a ``file://`` store; the backend is NCCL on cards
and gloo on the CPU (gloo also takes CUDA tensors, which is how two ranks
share one card: NCCL refuses that). Every collective carries the group's
``timeout``, so that a rank that fails ends the run instead of leaving the
others waiting. :func:`spawn` starts the ranks of a CLI's ``--nproc``.

A group of more than one rank is *active*: the BatchNorm statistics, the
loss normalisers and the gradient are then reduced over it (every rank is
one block of the data axis; training with a model axis is not ported).
Without a group every function here is the identity of one rank.
"""

from __future__ import annotations

import datetime
import os
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as tdist

DEFAULT_TIMEOUT_S = 600.0


def world_size() -> int:
    return tdist.get_world_size() if tdist.is_available() and tdist.is_initialized() else 1


def rank() -> int:
    return tdist.get_rank() if tdist.is_available() and tdist.is_initialized() else 0


def active() -> bool:
    """A group of more than one rank is joined."""
    return world_size() > 1


def is_main() -> bool:
    """Rank 0, the one that writes the run's files (or the only process)."""
    return rank() == 0


def from_torchrun() -> bool:
    """This process was started by torchrun (its environment names a rank)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def local_device(kind: str) -> torch.device:
    """The device of this rank for device type ``kind``: its current card
    (which :func:`join` set), or the CPU."""
    return torch.device("cuda", torch.cuda.current_device()) if kind == "cuda" \
        else torch.device("cpu")


def run_ranks(fn: Callable, args: Sequence, device: str, nproc: Optional[int],
              store_dir: str):
    """A CLI's ranks: ``fn(*args, device)`` in this process when a group is
    joined already (its device the current one) or when one rank is asked
    for (``nproc``; by default every visible card, 1 on the CPU); in a group
    joined from torchrun's environment when torchrun started this process;
    else on ``nproc`` spawned ranks (:func:`spawn`, store under
    ``store_dir``), and then ``None``."""
    kind = torch.device(device).type
    if tdist.is_available() and tdist.is_initialized():
        return fn(*args, local_device(kind))
    if from_torchrun():
        join(device=device)
        try:
            return _as_rank(fn, args, kind)
        finally:
            leave()
    nproc = nproc or (torch.cuda.device_count() if kind == "cuda" else 1)
    if nproc == 1:
        return fn(*args, torch.device(device))
    spawn(_as_rank, (fn, args, kind), nproc, store_dir, device=device)
    return None


def _as_rank(fn: Callable, args: Sequence, kind: str):
    """``fn(*args, device)`` on this rank; on cards rank 0 first builds the
    kernel libraries the paths load, while the others wait."""
    if kind == "cuda":
        if is_main():
            from ..ops.kernels.build import build_all

            build_all()
        barrier()
    return fn(*args, local_device(kind))


def join(rank: Optional[int] = None, world: Optional[int] = None,
         init_file: Optional[str] = None, device: str = "cuda",
         backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Enter the group and return this rank's device. Without ``rank`` the
    group comes from torchrun's environment, else from ``init_file`` (a
    path every rank names alike; it must not exist yet). On cards the rank
    takes card ``LOCAL_RANK`` (or ``rank``) modulo the cards present, set as
    the current device before any kernel library loads; NCCL needs a card
    per rank. ``backend`` defaults to NCCL on cards, gloo on the CPU."""
    kind = torch.device(device).type
    if rank is None:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local, init = int(os.environ.get("LOCAL_RANK", rank)), "env://"
    else:
        local, init = rank, Path(init_file).resolve().as_uri()
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    dev = torch.device("cpu")
    if kind == "cuda":
        n_cards = torch.cuda.device_count()
        if backend == "nccl" and local >= n_cards:
            raise ValueError(f"local rank {local} on {n_cards} card(s): NCCL needs one card "
                             "per rank (gloo can share a card)")
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    tdist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                             timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def leave() -> None:
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()


def barrier() -> None:
    if active():
        tdist.barrier()


def sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks (a new tensor; the input where there is
    one rank). Differentiable where ``t`` requires a gradient: the backward
    sums the incoming gradients over the ranks in turn."""
    if not active():
        return t
    if t.requires_grad:
        return _SumOverRanks.apply(t)
    out = t.clone()
    tdist.all_reduce(out)
    return out


class _SumOverRanks(torch.autograd.Function):
    """The sum over the ranks, differentiable: the gradient of every rank's
    input is the sum of the ranks' output gradients (the semantics of
    ``torch.distributed.nn.functional.all_reduce``, which recent torch
    releases deprecate)."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone(memory_format=torch.contiguous_format)
        tdist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _SumOverRanks.apply(grad)


def sums(*scalars: torch.Tensor) -> List[torch.Tensor]:
    """Scalars that autograd treats as constants, each summed over the
    ranks, in one collective (the inputs where there is one rank)."""
    if not active():
        return list(scalars)
    return list(sum_(torch.stack([s.detach().float() for s in scalars])).unbind())


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along dim 0
    in rank order; ``t`` itself where there is one rank. Booleans travel as
    bytes."""
    if not active():
        return t
    src = t.contiguous()
    if src.dtype == torch.bool:
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(world_size())]
    tdist.all_gather(parts, src)
    out = torch.cat(parts)
    return out.bool() if t.dtype == torch.bool else out


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place."""
    if active():
        tdist.broadcast(t, src)
    return t


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s ``obj`` (a picklable value) on every rank."""
    if not active():
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src)
    return box[0]


def gather_objects(obj) -> Optional[list]:
    """Every rank's ``obj`` in rank order on rank 0, ``None`` elsewhere;
    ``[obj]`` where there is one rank."""
    if not active():
        return [obj]
    out = [None] * world_size() if is_main() else None
    tdist.gather_object(obj, out, dst=0)
    return out


def _rank_main(rank: int, world: int, fn: Callable, args: Sequence, device: str,
               backend: Optional[str], init_file: str, timeout_s: float,
               threads: Optional[int]) -> None:
    if threads:
        torch.set_num_threads(threads)
    join(rank, world, init_file, device=device, backend=backend, timeout_s=timeout_s)
    try:
        fn(*args)
    finally:
        leave()


def spawn(fn: Callable, args: Sequence, nproc: int, store_dir: str, device: str = "cuda",
          backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
          threads: Optional[int] = None, deadline_s: Optional[float] = None) -> None:
    """Run ``fn(*args)`` on ``nproc`` new processes (``spawn`` start method:
    ``fn`` is sent by its import path), rank i of one group whose
    ``file://`` store is a fresh file under ``store_dir``. Returns when all
    ranks have returned. When one raises, the others are stopped and a
    ``torch.multiprocessing.ProcessRaisedException`` carries its traceback;
    past ``deadline_s`` every rank is stopped and ``TimeoutError`` raised.
    ``threads``: torch threads per rank (on the CPU default
    ``OMP_NUM_THREADS``, else the cores over ``nproc``)."""
    import torch.multiprocessing as mp

    if threads is None and torch.device(device).type == "cpu" and "OMP_NUM_THREADS" not in os.environ:
        threads = max(1, (os.cpu_count() or 1) // nproc)
    Path(store_dir).mkdir(parents=True, exist_ok=True)
    init_file = str(Path(store_dir) / f".ranks-{os.getpid()}-{time.monotonic_ns()}")
    ctx = mp.start_processes(_rank_main, args=(nproc, fn, tuple(args), device, backend,
                                               init_file, timeout_s, threads),
                             nprocs=nproc, join=False, start_method="spawn")
    end = None if deadline_s is None else time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=1.0):
            if end is not None and time.monotonic() > end:
                raise TimeoutError(f"{nproc} ranks did not finish within {deadline_s} s")
    except BaseException:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for p in ctx.processes:
            p.join(10)
        raise
    finally:
        if os.path.exists(init_file):
            os.remove(init_file)
