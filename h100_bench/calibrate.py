"""Readings that the limits of ``correct`` are set from, on the card, at
the cell's own size, in one process:

    python3 -m h100_bench.calibrate --workload v1.train.b32 --seeds 1 2 3 \
        --control-seeds 1 2 3 --seconds 2 --out build/calibrate.jsonl

* ``program``: a run of the cell per seed (a short window; the numbers are
  those a run compares);
* ``control``: the reference computed at the precision below the
  configuration's (``reference/precision.py::CONTROL``) in the program's
  place, on the same seeds' inputs;
* ``half_batch`` (train cells): the fp32 reference stepping on half of each
  batch in the program's place, the loss's means over that half.

A state left unchanged reads 1 on ``grad_gap``, ``update_gap`` and
``bn_gap`` by their definition and needs no run. Each reading is one JSON line, to ``--out``
and to standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from h100_bench import compare, harness
from h100_bench.reference.precision import CONTROL, FP32
from h100_bench.spec import Bench


def readings(bench: Bench, cell_name: str, seeds, control_seeds, seconds: float, device):
    cell = bench.cell(cell_name)
    tr = bench.traffic(cell["traffic"])
    cfg = bench.config(cell["config"])
    drv = bench.driver(tr["kind"])
    for seed in seeds:
        ctx = harness.Context(config=cfg, traffic=tr, seed=seed, seconds=seconds, trace=False,
                              device=device, t0=time.perf_counter())
        out = drv.run(ctx)
        yield {"cell": cell_name, "side": "program", "seed": seed, "numbers": out.numbers,
               "end_to_end": out.end_to_end, "failed": out.failed, "detail": out.detail}
    for seed in control_seeds:
        if tr["kind"] == "serve":
            nums = drv.control_numbers(cfg, tr, seed, device, CONTROL)
            yield {"cell": cell_name, "side": "control", "seed": seed, "numbers": nums}
            continue
        state0, ring = drv.prepare(cfg, tr, seed, device)
        ref = drv.reference_record(cfg, tr, state0, ring, FP32)
        for side, precision, rows in (("control", CONTROL, 0),
                                      ("half_batch", FP32, tr["batch"] // 2)):
            r = drv.reference_record(cfg, tr, state0, ring, precision, rows)
            yield {"cell": cell_name, "side": side, "seed": seed,
                   "numbers": compare.train_numbers(r, ref),
                   "detail": compare.train_detail(r, ref)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True, nargs="+")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="build/calibrate.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    bench = Bench()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for cell in args.workload:
            for r in readings(bench, cell, args.seeds, args.control_seeds, args.seconds,
                              torch.device("cuda", 0)):
                line = json.dumps(r)
                print(line, flush=True)
                f.write(line + "\n")
                f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
