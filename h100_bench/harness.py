"""One run of one cell: the driver's work, the reduction to the result line.

:func:`execute` runs the cell's driver (``drivers/<kind>.py``, by the
traffic file's ``kind``), judges its numbers against the cell's limits,
reads the cell's per-layer metrics with ``--trace 1``, and returns the
result line's object. ``run.py`` calls it on the card; the tests call it on
the CPU at tiny shapes, the only route by which it runs without a card.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Dict, List, Optional

import torch

from . import compare
from .reference.model import MultitaskModel as Reference
from .reference.precision import FP32, Precision
from .spec import Bench

# top-level module names that no process of the benchmark may hold: the JAX
# stack and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "multitask_bonetumor_yolo_tpu")


@dataclasses.dataclass
class Context:
    """What a driver is given."""

    config: Dict  # the configuration file
    traffic: Dict  # the traffic file
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # the host clock at process start


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]  # by metric name, setup_s included
    numbers: Dict[str, float]  # compared against the cell's limits
    memory_peak_bytes: int
    trace: Optional["TraceData"] = None
    detail: Optional[Dict] = None  # what a number's worst part was, for the calibration


@dataclasses.dataclass
class TraceData:
    """What the per-layer metrics' readers read (``metrics/<name>.py``)."""

    config: Dict
    traffic: Dict
    spans: Dict[str, List[float]]  # ms per call, by span name
    calls: int  # calls in the measured window
    rows: int  # rows (images) per call
    window_s: float  # the measured window's host-clock seconds
    counters: Dict[str, float]  # per call, e.g. kernel launches
    kernels: List  # (name, seconds) of each device event of the fenced profile
    profile_calls: int
    profile_s: float  # host-clock seconds of the fenced profile's calls
    busy_s: float  # seconds with an operation on the device in it
    breakdown: Dict[str, Any]


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def model_config(cfg: Dict):
    """The program's ``ModelConfig`` from the configuration file."""
    from multitask_bonetumor_yolo_tpu_torch.models import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in fields}
    return ModelConfig(**kw)


def program_model(cfg: Dict, state: Dict[str, torch.Tensor], device: torch.device):
    """The program's model with the benchmark's weights, as its entry points
    take it: on ``device``, channels-last, in eval mode."""
    from multitask_bonetumor_yolo_tpu_torch.models import MultitaskModel

    with torch.device("meta"):
        model = MultitaskModel(model_config(cfg))
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model.to(memory_format=torch.channels_last).eval()


def reference_model(cfg: Dict, state: Dict[str, torch.Tensor], precision: Precision = FP32,
                    clone: bool = False) -> Reference:
    """The plain reference holding ``state`` (its own copy with ``clone``)."""
    with torch.device("meta"):
        ref = Reference(cfg, precision)
    if clone:
        state = {k: v.clone() for k, v in state.items()}
    ref.load_state_dict(state, assign=True)
    return ref


def execute(bench: Bench, cell_name: str, seed: int, seconds: float, trace: bool,
            device: torch.device, t0: float) -> Dict:
    cell = bench.cell(cell_name)
    traffic = bench.traffic(cell["traffic"])
    ctx = Context(config=bench.config(cell["config"]), traffic=traffic, seed=seed,
                  seconds=seconds, trace=trace, device=device, t0=t0)
    out: Outcome = bench.driver(traffic["kind"]).run(ctx)
    checks = compare.judge(out.numbers, bench.limits(cell_name))
    correct = all(c["ok"] for c in checks.values())
    metrics = {}
    if trace:
        for m in bench.per_layer(cell_name):
            value = bench.metric_reader(m["name"]).read(out.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench.end_to_end(cell_name):
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
               "memory_peak_bytes": out.memory_peak_bytes}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.profile_s
        result["breakdown"] = out.trace.breakdown
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result

