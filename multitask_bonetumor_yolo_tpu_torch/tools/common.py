"""What the profiling tools share: the device flag, the launch counts of the
hand-written kernels, and the rows they print.

Each kernel's wrapper raises its own ``launches`` count by one where it
launches the kernel on the card, and nowhere else (on a CPU tensor it runs
the plain version and counts nothing). :func:`timed` times a call with
:func:`..utils.timing.timeloop` and reads the counts around it, so that a row
says which kernels its call launched, per call.
"""

from __future__ import annotations

import torch

from ..ops.kernels import convnext_block as cnb
from ..ops.kernels import convnext_block_bwd as bwd
from ..utils.timing import timeloop

KERNELS = {  # short name -> the wrapper that counts the kernel's launches
    "K1": cnb.convnext_block,
    "K1 saving": cnb.convnext_block_saving,
    "K2": bwd.convnext_block_bwd,
    "K4": bwd.convnext_block_bwd_v1,
}


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; a CUDA device where there is none raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the plain versions")
    return device


def launch_counts() -> dict:
    return {k: fn.launches for k, fn in KERNELS.items()}


def timed(fn, iters: int, device: torch.device) -> tuple:
    """``(ms, launches)``: ``fn``'s ms per call by :func:`timeloop` (CUDA
    events on the card, the host clock on the CPU) and each kernel's
    launches per call over the timed calls (a dict, kernels that launched)."""
    calls = [0]

    def counted():
        calls[0] += 1
        return fn()

    before = launch_counts()
    ms = timeloop(counted, iters, device=device.type)
    after = launch_counts()
    return ms, {k: (after[k] - before[k]) / calls[0] for k in KERNELS if after[k] != before[k]}


class Rows:
    """The table a profiler prints: :meth:`report` prints one row as the JAX
    scripts' ``report`` does (name padded to ``width``, ms, note) and keeps
    it, with the launches per call of the row's timed call in the note."""

    def __init__(self, width: int):
        self.width = width
        self.rows = []

    def report(self, name: str, ms: float, note: str = "", launches=None) -> None:
        launches = launches or {}
        if launches:
            note = (note + "  " if note else "") + "[" + ", ".join(
                f"{k} {v:g}/call" for k, v in launches.items()) + "]"
        self.rows.append({"name": name, "ms": ms, "note": note, "launches": launches})
        print(f"  {name:<{self.width}s} {ms:8.3f} ms  {note}", flush=True)

    def time(self, name: str, fn, iters: int, device: torch.device, note: str = "") -> float:
        """:func:`timed` ``fn``, :meth:`report` the row; returns its ms."""
        ms, launches = timed(fn, iters, device)
        self.report(name, ms, note, launches)
        return ms
