"""Run one cell of the benchmark once, on the card.

    python3 -m h100_bench.run --workload v1.serve.b16 --seed 7 --seconds 20 --trace 0

Prints the cell's metrics as the last line of standard output, one JSON
object: its end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``; ``correct`` from the comparison with the plain
reference, each number compared beside its limit under ``checks`` and as
the last lines of standard error. Exits non-zero, with no result, without
a CUDA card (there is no CPU fallback) or when the process holds the JAX
stack or the JAX package after the window.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # one process with few threads: the timed path's host work is one
    # Python thread issuing to the card, and a thread pool sized to the
    # host's cores only contends with it
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    # every cache of the run at a fixed path inside the checkout; the
    # program's nvcc builds already go to its build/kernels/
    os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build" / "torch_extensions")

    import torch

    torch.set_num_threads(1)
    from h100_bench.harness import execute, forbidden_modules
    from h100_bench.spec import Bench

    bench = Bench()
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100_bench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T0)
    held = forbidden_modules()
    if held:
        print(f"h100_bench: the process holds {', '.join(held)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
