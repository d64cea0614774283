"""The quality-parity recipe over several training seeds, all on one card at
once, held against the TPU bar less a margin.

    python -m multitask_bonetumor_yolo_tpu_torch.tools.train_seeds \\
        --variant v1 --epochs 60 --assigner tal --eval-bn frozen \\
        --data-dir build/synth_rich640 --run-root build/seeds \\
        --run 123 --run 7 [--run 7@tree/parent] [--records quality]

Each ``--run SEED[@TREE]`` is one training run of ``tools.train_synthetic``'s
recipe at training seed SEED, run by the code of the checkout TREE (default
this one; another checkout, say the parent commit's, gives the "before").
The steps:

  1. :func:`.train_synthetic.write_data`, once for every run;
  2. one ``cli.train`` process per run with :func:`.train_synthetic.train_argv`
     plus ``--seed SEED``, all started together, so that they share the
     card (each run waits on its own loader thread for most of an epoch);
  3. when all have ended, ``cli.evaluate`` with :func:`.train_synthetic.
     eval_argv` on each run's best checkpoint, one run at a time;
  4. per run :func:`.train_synthetic.summarize`, the classifier's
     trajectory (:func:`classifier_trajectory`) and ``cli.evaluate``'s
     table against :data:`RULE`; with ``--records``, the run's
     ``metrics.jsonl`` and ``eval/metrics.jsonl`` copied to
     ``<records>/synthetic_<variant>_<assigner>_<eval-bn>_s<seed>[_<tree>]/``
     as ``metrics.jsonl`` and ``eval_metrics.jsonl``.

The last line printed is a JSON object with every run's report. Run dirs
hold ~0.6 GB checkpoints: keep ``--run-root`` under ``build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

from .common import resolve_device
from .train_synthetic import eval_argv, make_parser as recipe_parser, summarize, train_argv
from .train_synthetic import write_data

# The TPU bar of the v1 recipe (BASELINE.md round 5: TAL, frozen BN) less
# 0.03: a run meets the rule when its best checkpoint's ``cli.evaluate``
# table reaches every one of these.
TPU_BAR = {"map50": 0.9794, "map50_95": 0.857, "dice": 0.9736, "img_accuracy": 0.9688}
MARGIN = 0.03
RULE = {k: round(v - MARGIN, 4) for k, v in TPU_BAR.items()}
TABLE_KEYS = {  # report name -> cli.evaluate's logged key
    "map50": "test/map_iou50_map",
    "map50_c0": "test/map_iou50_class_detC0",
    "map50_c1": "test/map_iou50_class_detC1",
    "map50_95": "test/map_iou50_95_map",
    "mar100_50_95": "test/map_iou50_95_mar_100",
    "dice": "test/seg_dice",
    "iou": "test/seg_iou",
    "mask_map": "test/seg_map_map",
    "img_accuracy": "test/img_accuracy",
    "img_f1_macro": "test/img_f1_macro",
}
STEADY_ACCURACY = 0.95


def make_parser() -> argparse.ArgumentParser:
    ap = recipe_parser()
    ap.description = "The quality recipe over several training seeds on one card"
    ap.add_argument("--run", action="append", required=True, metavar="SEED[@TREE]",
                    help="a training run: its seed and, optionally, the checkout whose "
                    "code runs it (repeat for each run)")
    ap.add_argument("--run-root", default="build/seeds",
                    help="the runs' directories, one per run")
    ap.add_argument("--records", default=None,
                    help="copy each run's metrics.jsonl and eval/metrics.jsonl under here")
    return ap


def parse_run(spec: str) -> dict:
    """``"7"`` or ``"7@tree/parent"`` -> ``{"seed", "tree", "name"}``."""
    seed, _, tree = spec.partition("@")
    tree = Path(tree).resolve() if tree else None
    name = f"s{int(seed)}" + (f"_{tree.name}" if tree else "")
    return {"seed": int(seed), "tree": tree, "name": name}


def run_module(module: str, argv: list, tree, log_path: Path) -> subprocess.Popen:
    """``python -m <module> <argv>`` of the package in ``tree`` (default
    this checkout), its output in ``log_path``."""
    root = tree or Path(__file__).resolve().parents[2]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(root), env.get("PYTHONPATH")]))
    pkg = __package__.split(".")[0]
    with open(log_path, "w") as log:  # the child keeps its own descriptor
        return subprocess.Popen([sys.executable, "-m", f"{pkg}.{module}", *map(str, argv)],
                                cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)


def wait_all(procs: dict) -> None:
    """Wait for every process; raise naming those that failed, with the
    end of their logs."""
    failed = []
    for name, (proc, log_path) in procs.items():
        if proc.wait() != 0:
            failed.append(f"{name} exit {proc.returncode}:\n"
                          + "".join(Path(log_path).read_text().splitlines(True)[-20:]))
    if failed:
        raise RuntimeError("runs failed:\n" + "\n".join(failed))


def classifier_trajectory(metrics_path) -> list:
    """Per epoch (in order) the validation image accuracy and image-class
    loss from a run's ``metrics.jsonl``."""
    recs = [json.loads(line) for line in Path(metrics_path).open()]
    epochs = {r["step"]: int(r["train_epoch/epoch"]) for r in recs if "train_epoch/epoch" in r}
    return [{"epoch": epochs[r["step"]], "step": r["step"],
             "img_accuracy": r["val_epoch/img_accuracy"],
             "loss_img_cls": r["val_epoch/loss_img_cls"]}
            for r in sorted((r for r in recs if "val_epoch/img_accuracy" in r),
                            key=lambda r: r["step"]) if r["step"] in epochs]


def steady_from(traj: list, level: float = STEADY_ACCURACY):
    """The first epoch from which the validation accuracy stays >= ``level``
    to the last epoch (None if the last epoch is below it)."""
    first = None
    for row in traj:
        if row["img_accuracy"] >= level:
            first = row["epoch"] if first is None else first
        else:
            first = None
    return first


def eval_table(eval_metrics_path) -> dict:
    """``cli.evaluate``'s last ``test/`` record as :data:`TABLE_KEYS`."""
    rec = [json.loads(line) for line in Path(eval_metrics_path).open()
           if '"test/img_accuracy"' in line][-1]
    return {k: rec.get(key) for k, key in TABLE_KEYS.items()}


def report(run: dict, run_dir: Path, args) -> dict:
    """One run's report: the table against :data:`RULE`, the best-mAP50
    epoch and its validation image accuracy, the epoch from which that
    accuracy stays >= 0.95, the epochs that read 0.50 (one class for every
    validation image) with their image-class loss, the epochs' img/s."""
    summary = summarize(run_dir / "metrics.jsonl", args.batch_size)
    traj = classifier_trajectory(run_dir / "metrics.jsonl")
    table = eval_table(run_dir / "eval" / "metrics.jsonl")
    best = summary["best"]
    at_best = next(r for r in traj if r["step"] == best["step"])
    rates = sorted(r["img_s"] for r in summary["epochs"][1:]) or [summary["epochs"][0]["img_s"]]
    out = {
        "name": run["name"], "seed": run["seed"], "tree": str(run["tree"] or "."),
        "table": table,
        "meets": {k: table[k] is not None and table[k] >= v for k, v in RULE.items()},
        "best_epoch": best["epoch"], "epochs": len(summary["epochs"]),
        "img_accuracy_at_best": at_best["img_accuracy"],
        "accuracy_steady_from": steady_from(traj),
        "epochs_at_one_class": [(r["epoch"], r["loss_img_cls"]) for r in traj
                                if r["img_accuracy"] == 0.5],
        "img_s_median": rates[len(rates) // 2], "img_s_min": rates[0], "img_s_max": rates[-1],
        "epoch_seconds": summary["seconds"], "phases": summary["phases"],
    }
    out["meets_rule"] = all(out["meets"].values())
    print(f"[seeds] {run['name']}: " + ", ".join(f"{k} {v:.4f}" for k, v in table.items()
                                                 if v is not None)
          + f"; rule {'met' if out['meets_rule'] else 'NOT met'} "
          + str({k: v for k, v in out["meets"].items() if not v}))
    print(f"[seeds] {run['name']}: best epoch {best['epoch']} of {len(summary['epochs'])}, "
          f"val accuracy there {at_best['img_accuracy']:.4f}, >= {STEADY_ACCURACY} from epoch "
          f"{out['accuracy_steady_from']}; epochs at 0.50 (loss_img_cls): "
          + (", ".join(f"{e} ({lo:.3f})" for e, lo in out["epochs_at_one_class"]) or "none"))
    return out


def main(argv=None) -> dict:
    args = make_parser().parse_args(argv)
    resolve_device(args.device)
    runs = [parse_run(s) for s in args.run]
    if len({r["name"] for r in runs}) != len(runs):
        raise ValueError(f"each --run needs its own seed or tree: {args.run}")
    args.data_dir = str(Path(args.data_dir).resolve())
    data_dir = write_data(args)
    root = Path(args.run_root).resolve()

    t0 = time.perf_counter()
    procs = {}
    for run in runs:
        run_dir = root / run["name"]
        run_dir.mkdir(parents=True, exist_ok=True)
        run["dir"] = run_dir
        procs[run["name"]] = (run_module(
            "cli.train", train_argv(args, data_dir, str(run_dir)) + ["--seed", run["seed"]],
            run["tree"], run_dir / "train.log"), run_dir / "train.log")
    print(f"[seeds] {len(runs)} training runs started together on one "
          f"{args.device} device: {[r['name'] for r in runs]}")
    wait_all(procs)
    print(f"[seeds] training took {time.perf_counter() - t0:.1f} s (host clock)")

    from ..train.checkpoint import CheckpointManager

    reports = []
    for run in runs:
        run_dir = run["dir"]
        best = CheckpointManager(f"{run_dir}/checkpoints").best_path()
        print(f"[eval] {run['name']}: best checkpoint {best}")
        wait_all({run["name"]: (run_module(
            "cli.evaluate", eval_argv(args, data_dir, str(run_dir), best), run["tree"],
            run_dir / "eval.log"), run_dir / "eval.log")})
        reports.append(report(run, run_dir, args))
        if args.records:
            dst = Path(args.records) / (
                f"synthetic_{args.variant}_{args.assigner}_"
                f"{'frozen' if args.eval_bn == 'frozen' else 'ref'}_{run['name']}")
            dst.mkdir(parents=True, exist_ok=True)
            shutil.copy(run_dir / "metrics.jsonl", dst / "metrics.jsonl")
            shutil.copy(run_dir / "eval" / "metrics.jsonl", dst / "eval_metrics.jsonl")
    result = {"shared_card": len(runs), "rule": RULE, "runs": reports}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
