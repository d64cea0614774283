"""Checkpoints with top-K-on-metric and save-last semantics (counterpart of
the JAX ``train/checkpoint.py::CheckpointManager``).

The directory layout and index are the JAX manager's: one ``step_{step:08d}``
directory per save, ``index.json`` with each one's step, metric and epoch,
pruned to the ``top_k`` best by metric (``mode`` "max" or "min") with the
newest always kept. Orbax needs JAX, so each directory holds instead

  * ``weights.npz``: the model's parameters and BN statistics as Flax trees
    (``bridge.save_npz`` of ``bridge.torch_to_flax``), the file that
    ``cli.infer --checkpoint-path .../weights.npz`` reads;
  * ``optimizer.pt``: ``torch.save`` of the state's step, AdamW moments
    ``mu`` / ``nu`` (flat fp32) and their ``count``.

``restore`` loads both onto the state's device.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Dict, Optional

import torch

from ..bridge import flax_to_torch, load_npz, save_npz, torch_to_flax
from .state import TrainState

WEIGHTS = "weights.npz"
OPTIMIZER = "optimizer.pt"


class CheckpointManager:
    def __init__(self, directory: str, top_k: int = 2, mode: str = "max"):
        self.dir = Path(directory).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.top_k = top_k
        self.mode = mode
        self._index_path = self.dir / "index.json"
        self._index: Dict[str, dict] = {}
        if self._index_path.exists():
            self._index = json.loads(self._index_path.read_text())

    def _write_index(self) -> None:
        self._index_path.write_text(json.dumps(self._index, indent=2))

    def qualifies(self, metric: Optional[float]) -> bool:
        """Would ``metric`` enter the current top-K?"""
        if metric is None:
            return False
        scored = [v["metric"] for v in self._index.values() if v["metric"] is not None]
        if len(scored) < self.top_k:
            return True
        sign = 1.0 if self.mode == "max" else -1.0
        worst = min(scored, key=lambda m: sign * m)
        return sign * metric > sign * worst

    def save(self, state: TrainState, step: int, metric: Optional[float] = None,
             epoch: Optional[int] = None) -> Path:
        """Save as ``step_{step:08d}``; prune to top-K by metric, always
        keeping the newest ('last') checkpoint."""
        name = f"step_{step:08d}"
        path = self.dir / name
        if path.exists():
            shutil.rmtree(path)
        path.mkdir()
        save_npz(str(path / WEIGHTS), *torch_to_flax(state.model.state_dict()))
        torch.save({"step": state.step, "mu": state.mu.cpu(), "nu": state.nu.cpu(),
                    "count": state.count.cpu()}, path / OPTIMIZER)
        self._index[name] = {"step": step, "metric": metric, "epoch": epoch}
        self._prune()
        self._write_index()
        return path

    def _prune(self) -> None:
        names = sorted(self._index, key=lambda n: self._index[n]["step"])
        if not names:
            return
        last = names[-1]
        scored = [n for n in names if self._index[n]["metric"] is not None]
        sign = 1.0 if self.mode == "max" else -1.0
        ranked = sorted(scored, key=lambda n: sign * self._index[n]["metric"], reverse=True)
        keep = set(ranked[: self.top_k]) | {last}
        for n in names:
            if n not in keep:
                shutil.rmtree(self.dir / n, ignore_errors=True)
                del self._index[n]

    def best_path(self) -> Optional[Path]:
        scored = [n for n in self._index if self._index[n]["metric"] is not None]
        if not scored:
            return self.last_path()
        sign = 1.0 if self.mode == "max" else -1.0
        best = max(scored, key=lambda n: sign * self._index[n]["metric"])
        return self.dir / best

    def last_path(self) -> Optional[Path]:
        if not self._index:
            return None
        last = max(self._index, key=lambda n: self._index[n]["step"])
        return self.dir / last

    def restore(self, state: TrainState, path: Optional[str] = None) -> TrainState:
        """Load a checkpoint into ``state`` (built from the same configs), on
        its device, in place; ``path=None`` restores 'last'."""
        target = Path(path) if path else self.last_path()
        if target is None or not (target / WEIGHTS).exists():
            raise FileNotFoundError(f"No checkpoint at {target}")
        state.model.load_state_dict(flax_to_torch(*load_npz(str(target / WEIGHTS))), strict=True)
        dev = state.mu.device
        opt = torch.load(target / OPTIMIZER, map_location=dev, weights_only=True)
        if opt["mu"].shape != state.mu.shape:
            raise ValueError(f"{target}: moments for {opt['mu'].numel()} parameters, the "
                             f"model has {state.mu.numel()}")
        state.mu, state.nu, state.count = opt["mu"], opt["nu"], opt["count"]
        state.step = int(opt["step"])
        return state
