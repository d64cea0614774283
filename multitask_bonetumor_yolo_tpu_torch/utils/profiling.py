"""The port's tracer, its epoch phase timer and the registry of its
hand-written kernels (counterpart of the JAX ``utils/profiling.py``).

The tracer is off by default. Off, :func:`span` is one flag check that
returns a shared null context and :func:`count` one flag check: no clock is
read, no CUDA event made, no profiler range opened. :func:`enable` switches
it on (there is no environment variable and no flag), :func:`disable` off.
On, each span records:

  * its name (one of :data:`SPANS`), an id, the id of the span open around
    it in the same thread (its parent) and a trace id, which a root span
    (no parent) draws anew and its descendants share: one per request or
    step;
  * its host start and end (``time.perf_counter_ns``);
  * on the card, a CUDA timing event on the current stream at its start and
    at its end, read as ms since an event recorded at :func:`enable`;
  * a ``torch.profiler.record_function`` range of the same name, so that in
    any ``torch.profiler`` trace the spans sit on the kernels' timeline.

Records stay in memory, at most :data:`MAX_RECORDS`; the rest are counted
as dropped, but the first root span of each name is kept whatever the cap
drops. Counters (:data:`COUNTERS`) add up over the process and per root
span, where each root also counts the launches of every kernel of
:data:`KERNELS` made inside it (``launches.<kernel>``). :func:`report`
reduces it all, :func:`records` gives the spans one by one, :func:`reset`
clears them.

:class:`PhaseTimer` times the Trainer's epoch phases on the host clock and
opens a span ``epoch.<phase>`` around each.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

import torch

# every span the port opens: name -> where
SPANS = {
    "infer": "cli/infer.py::infer_batch, the whole request (root)",
    "infer.upload": "infer_batch: the host images to float on the model's device",
    "model.forward": "models/model.py::MultitaskModel.forward",
    "model.backbone": "MultitaskModel.forward: the ConvNeXt trunk",
    **{f"model.backbone.stage{i}": f"models/backbone.py::ConvNeXtFeatures: stage {i}, its "
       "downsample (the stem at 0) and blocks" for i in range(4)},
    "model.neck": "MultitaskModel.forward: the BiFPN",
    "model.heads": "MultitaskModel.forward: segment, detect, classifier, projector; "
                   "decode under mode='infer'",
    "nms": "infer_batch: ops/nms.py::postprocess_detections",
    "nms.wait": "ops/nms.py: each host read (the candidate count, each convergence check)",
    "masks": "infer_batch: ops/masks.py::compose_masks",
    "train_step": "train/steps.py::train_step, the whole step (root)",
    "augment": "train_step: data/preprocess.py::augment_batch",
    "loss": "train_step: losses/multitask.py::multitask_loss",
    "loss.assign": "multitask_loss: the task-aligned assigner (_assign_tal)",
    "backward": "train_step: torch.autograd.grad of the loss",
    "optimizer": "train_step: train/state.py::TrainState.apply_gradients",
    "kernels.build": "ops/kernels/build.py: one nvcc run",
    "kernels.load": "ops/kernels/build.py: one library loaded with ctypes",
    "epoch.data": "train/loop.py: PhaseTimer phase 'data'",
    "epoch.train_step": "train/loop.py: PhaseTimer phase 'train_step'",
    "epoch.viz": "train/loop.py: PhaseTimer phase 'viz'",
    "epoch.validate": "train/loop.py: PhaseTimer phase 'validate'",
    "epoch.checkpoint": "train/loop.py: PhaseTimer phase 'checkpoint'",
}
# every counter the port raises: name -> what one unit is
COUNTERS = {
    "nms.candidates": "a candidate of an NMS call (its k, the longest list over the batch)",
    "nms.waits": "a host read in NMS",
    "kernels.built": "an nvcc run",
    "kernels.loaded": "a library load",
    "trunk.blocks.kernel": "a ConvNeXt block on the kernel route (K1; K1's saving form "
                           "and K2 in training; the plain twin on a CPU tensor)",
    "trunk.blocks.eager": "a ConvNeXt block on the eager route (convnext_block_ref)",
}
MAX_RECORDS = 1 << 16
# the hand-written kernels: short name -> the wrapper whose ``launches``
# count rises by one where it launches its kernel on the card, and nowhere
# else (on a CPU tensor each runs its plain version and counts nothing);
# each module of ``ops/kernels`` enters its own as it is imported, so a
# kernel that can have launched is here
KERNELS: Dict[str, Callable] = {}

_on = False
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    """One closed span: ms since :func:`enable` on the host clock and on
    the card's (``None`` off the card)."""

    name: str
    id: int
    parent: Optional[int]
    trace: int
    host_start_ms: float
    host_end_ms: float
    device_start_ms: Optional[float]
    device_end_ms: Optional[float]

    @property
    def host_ms(self) -> float:
        return self.host_end_ms - self.host_start_ms

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_start_ms is None:
            return None
        return self.device_end_ms - self.device_start_ms


class _State:
    def __init__(self):
        self.cuda = torch.cuda.is_available()
        self.base_ns = time.perf_counter_ns()
        self.base_event = None
        if self.cuda:
            self.base_event = torch.cuda.Event(enable_timing=True)
            self.base_event.record()
        self.ids = itertools.count()
        self.traces = itertools.count()
        self.records: List[_Open] = []
        self.first: Dict[str, _Open] = {}
        self.dropped = 0
        self.counters: Dict[str, float] = defaultdict(float)
        self.lock = threading.Lock()
        self.local = threading.local()


_state: Optional[_State] = None


class _Open:
    """A span while it runs, and its record once closed."""

    __slots__ = ("name", "id", "parent", "trace", "t0", "t1", "e0", "e1", "rf", "counts",
                 "launches")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _state
        stack = getattr(st.local, "stack", None)
        if stack is None:
            stack = st.local.stack = []
        self.id = next(st.ids)
        if stack:
            self.parent, self.trace, self.counts = stack[-1].id, stack[-1].trace, None
        else:
            self.parent, self.trace, self.counts = None, next(st.traces), defaultdict(float)
            self.launches = launch_counts()
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.e0 = self.e1 = None
        if st.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        st = _state
        self.t1 = time.perf_counter_ns()
        if self.e0 is not None:
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e1.record()
        self.rf.__exit__(*exc)
        self.rf = None
        st.local.stack.pop()
        if self.parent is None:
            for k, n in launch_counts().items():
                if n != self.launches.get(k, 0):
                    self.counts[f"launches.{k}"] = n - self.launches.get(k, 0)
            st.first.setdefault(self.name, self)
        with st.lock:
            if len(st.records) < MAX_RECORDS:
                st.records.append(self)
            else:
                st.dropped += 1
        return False


def span(name: str):
    """A context that records the span ``name`` while the tracer is on."""
    if not _on:
        return _NULL
    return _Open(name)


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name`` (and to the open root span's)
    while the tracer is on."""
    if not _on:
        return
    st = _state
    stack = getattr(st.local, "stack", None)
    with st.lock:
        st.counters[name] += n
        if stack:
            stack[0].counts[name] += n


def enable() -> None:
    """Switch the tracer on; the first call (or the first after
    :func:`reset`) sets the clocks' zero."""
    global _on, _state
    if _state is None:
        _state = _State()
    _on = True


def disable() -> None:
    """Switch the tracer off; what it recorded stays for :func:`report`."""
    global _on
    _on = False


def reset() -> None:
    """Clear the records and counters (the clocks' zero is set anew)."""
    global _state
    _state = _State() if _on else None


def _closed(rec: _Open, st: _State) -> Span:
    ms = lambda ns: (ns - st.base_ns) / 1e6  # noqa: E731
    d0 = d1 = None
    if rec.e0 is not None:
        d0, d1 = st.base_event.elapsed_time(rec.e0), st.base_event.elapsed_time(rec.e1)
    return Span(rec.name, rec.id, rec.parent, rec.trace, ms(rec.t0), ms(rec.t1), d0, d1)


def records() -> List[Span]:
    """The kept spans in the order they closed (synchronises the card)."""
    st = _state
    if st is None:
        return []
    if st.cuda:
        torch.cuda.synchronize()
    return [_closed(r, st) for r in list(st.records)]


def report() -> Dict:
    """The tracer's record reduced (synchronises the card):

    * ``spans``: per name, ``count`` and the mean per occurrence of
      ``host_ms``, ``device_ms``, ``self_host_ms`` and ``self_device_ms``
      (the duration less what the span's children cover; device numbers
      ``None`` off the card);
    * ``first``: per root name, ``host_ms`` and ``device_ms`` of the
      process's first such span, kept whatever the cap dropped;
    * ``counters``: each counter's total;
    * ``per_root``: per root name, its ``count`` and the mean per root of
      each counter and kernel launch count raised inside it;
    * ``dropped``: spans the cap left out."""
    st = _state
    if st is None:
        return {"spans": {}, "first": {}, "counters": {}, "per_root": {}, "dropped": 0}
    spans = records()
    child_host, child_dev = defaultdict(float), defaultdict(float)
    for s in spans:
        if s.parent is not None:
            child_host[s.parent] += s.host_ms
            child_dev[s.parent] += s.device_ms or 0.0
    acc = defaultdict(lambda: [0, 0.0, 0.0, 0.0, 0.0])
    for s in spans:
        a = acc[s.name]
        a[0] += 1
        a[1] += s.host_ms
        a[2] += s.host_ms - child_host[s.id]
        if s.device_ms is not None:
            a[3] += s.device_ms
            a[4] += s.device_ms - child_dev[s.id]
    dev = st.cuda
    by_name = {name: {"count": n, "host_ms": h / n, "self_host_ms": sh / n,
                      "device_ms": d / n if dev else None,
                      "self_device_ms": sd / n if dev else None}
               for name, (n, h, sh, d, sd) in acc.items()}
    first = {}
    for name, rec in st.first.items():
        s = _closed(rec, st)
        first[name] = {"host_ms": s.host_ms, "device_ms": s.device_ms}
    roots = defaultdict(list)
    for rec in list(st.records):
        if rec.parent is None:
            roots[rec.name].append(rec.counts)
    per_root = {}
    for name, counts in roots.items():
        keys = sorted({k for c in counts for k in c})
        per_root[name] = {"count": len(counts),
                          **{k: sum(c.get(k, 0.0) for c in counts) / len(counts) for k in keys}}
    return {"spans": by_name, "first": first, "counters": dict(st.counters),
            "per_root": per_root, "dropped": st.dropped}


def register_kernels(wrappers: Dict[str, Callable]) -> None:
    """Enter ``wrappers`` (short name -> wrapper) into :data:`KERNELS`."""
    KERNELS.update(wrappers)


def launch_counts() -> Dict[str, int]:
    """Each registered kernel's launches so far."""
    return {k: fn.launches for k, fn in KERNELS.items()}


class PhaseTimer:
    """Host wall time per named phase, summed over an epoch; each phase is
    also the span ``epoch.<phase>``. The train step issues its work and
    never waits for the card, so the ``train_step`` phase is the host's
    time to issue the steps: the card's time shows in the phase that next
    waits for it."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(f"epoch.{name}"):
                yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0
