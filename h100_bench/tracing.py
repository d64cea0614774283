"""Spans and the device trace of a ``--trace 1`` run, taken from the
benchmark's own code around the calls into the program.

* :class:`Spans` records a mark at each layer boundary (a CUDA event on the
  card, the host clock in the CPU rehearsal) and pairs them into spans,
  read after the window.
* :func:`fenced_profile` runs calls under ``torch.profiler`` between two
  marker kernels, with calls of the same kind before and after them, and
  keeps only the device events between the markers: the profiler has been
  seen to drop events at the edges of a profile on this card.
* :func:`summary` reduces those events to the busy time, the kernel time
  by name and the longest idle gaps with the host operation under each.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

PAD_S = 0.02  # seconds of calls on each side of the fenced window
MARK = "spin_kernel"  # the kernel of torch.cuda._sleep, the fence's markers


class Spans:
    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: Dict[str, List[Tuple[object, object]]] = defaultdict(list)
        self.open: Dict[str, object] = {}

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def start(self, name: str) -> None:
        self.open[name] = self._mark()

    def end(self, name: str) -> None:
        self.marks[name].append((self.open.pop(name), self._mark()))

    def ms(self) -> Dict[str, List[float]]:
        """Each span's durations in ms (call after a synchronise)."""
        if self.cuda:
            return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.marks.items()}
        return {k: [(b - a) * 1e3 for a, b in v] for k, v in self.marks.items()}


def _pad(call: Callable, sync: Callable) -> None:
    t0 = time.perf_counter()
    while True:
        call()
        sync()
        if time.perf_counter() - t0 >= PAD_S:
            return


def fenced_profile(call: Callable, n: int, attempts: int = 4):
    """``n`` calls of ``call`` under the profiler, fenced. Returns (device
    events, host events, host-clock seconds of the n calls)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sync = torch.cuda.synchronize
    for _ in range(attempts):
        with torch.profiler.profile(activities=acts, acc_events=True) as prof:
            _pad(call, sync)
            torch.cuda._sleep(1)
            sync()
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            sync()
            wall = time.perf_counter() - t0
            torch.cuda._sleep(1)
            _pad(call, sync)
        events = list(prof.events())
        dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        marks = sorted(e.time_range.start for e in dev if MARK in e.name)
        if len(marks) != 2:
            continue
        lo, hi = marks
        dev = [e for e in dev if MARK not in e.name and lo < e.time_range.start < hi]
        host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                and e.time_range.end > lo and e.time_range.start < hi]
        if sum(e.device_time for e in dev) > 0:
            return dev, host, wall
    raise RuntimeError(f"the profiler recorded no fenced device time in {attempts} profiles")


def profile(call: Callable, n: int, device: torch.device) -> Tuple[Dict, float]:
    """:func:`summary` of ``n`` fenced calls and their host-clock seconds;
    on the CPU (the rehearsal) an empty summary: there is no device."""
    if device.type != "cuda":
        return {"busy_s": 0.0, "kernels": [], "device_ops": [], "idle_gaps": []}, 0.0
    dev, host, wall = fenced_profile(call, n)
    return summary(dev, host), wall


def kernel_name(name: str) -> str:
    """A kernel's name up to its argument list, without ``void `` and
    anonymous namespaces."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0]


def summary(dev, host, top: int = 10) -> Dict:
    """Busy seconds (the union of the device events' intervals), per
    event the (name, seconds), and the ``top`` device ops by time and
    idle gaps by length, each gap named by the innermost host operation
    running at its middle, or, where none runs (the host is in Python),
    by the last one that ended before it."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, gaps, cur_lo, cur_hi = 0.0, [], None, None
    for lo, hi in spans:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
                gaps.append((cur_hi, lo))
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    per_kernel = [(kernel_name(e.name), e.device_time / 1e6) for e in dev]
    by_name = defaultdict(float)
    for name, s in per_kernel:
        by_name[name] += s
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = []
    for lo, hi in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (lo + hi) / 2
        ops = [e for e in host if not e.name.startswith("cuda")]
        under = [e for e in ops if e.time_range.start <= mid <= e.time_range.end]
        before = [e for e in ops if e.time_range.end < mid]
        if under:
            name = min(under, key=lambda e: e.time_range.end - e.time_range.start).name
        elif before:
            name = "after " + max(before, key=lambda e: e.time_range.end).name
        else:
            name = "host"
        idle.append([name, (hi - lo) / 1e6])
    return {"busy_s": busy / 1e6, "kernels": per_kernel,
            "device_ops": [[k, v] for k, v in top_ops], "idle_gaps": idle}
