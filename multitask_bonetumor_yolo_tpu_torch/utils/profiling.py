"""Tracing and profiling helpers (counterpart of the JAX ``utils/profiling.py``).

  * :class:`PhaseTimer`: wall time per named phase (host clock);
  * :func:`annotate`: a named range in a ``torch.profiler`` trace
    (``record_function``; next to nothing when no profiler runs);
  * :func:`trace`: a ``torch.profiler`` capture of a block, CPU and CUDA
    activities, written into ``log_dir`` as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, Iterator


class PhaseTimer:
    """Accumulates wall time per named phase; reference-style bracket logs."""

    def __init__(self, verbose: bool = False):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.verbose = verbose

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if self.verbose:
                print(f"    [{name}] {dt:.3f}s")

    def summary(self) -> Dict[str, float]:
        return {name: self.totals[name] / max(self.counts[name], 1) for name in self.totals}


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named range in the profiler's trace."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block (CPU, and CUDA where a card is present) and write
    ``log_dir/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
