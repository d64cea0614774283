"""Carry the JAX package's Flax weights into the port.

The port's modules are named after the Flax scope paths, so a torch
``state_dict`` key is the Flax path joined with dots, with the leaf renamed,
and the bridge is a walk over the tree with one rule per leaf kind (the
inverse of ``multitask_bonetumor_yolo_tpu/utils/import_torch_weights.py``):

  conv kernel     HWIO [kh, kw, I, O]  -> OIHW ``weight``
  depthwise       [kh, kw, 1, C]       -> [C, 1, kh, kw] (the same transpose)
  Dense kernel    [in, out]            -> Linear ``weight`` [out, in]
  ConvTranspose   [kh, kw, I, O]       -> [I, O, kh, kw] with BOTH tap axes
                                          flipped (Flax places tap [a, b] at
                                          output offset [k-1-a, k-1-b], torch
                                          at [a, b])
  BN / LN scale   -> ``weight``; bias -> ``bias``
  BN mean / var   -> ``running_mean`` / ``running_var``
  ConvNeXt block  dw_kernel as a conv kernel, w1 / w2 as Dense kernels
                  (kept under their names), other leaves unchanged

The trees come in as nested dicts of numpy arrays (callers holding JAX
arrays pass ``jax.tree.map(np.asarray, tree)``), so nothing here needs JAX.
``save_npz`` / ``load_npz`` store the same trees with ``/``-joined keys: the
file ``cli/infer.py --checkpoint-path`` reads. ``torch_to_flax`` is the
inverse walk, for writing such a file from a torch model.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

Tree = Mapping[str, object]
_BLOCK = re.compile(r"stage\d+_block\d+$")


def _walk(tree: Tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _conv(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))


def _param(path: Tuple[str, ...], a: np.ndarray) -> Tuple[str, np.ndarray]:
    *scope, name = path
    parent = scope[-1] if scope else ""
    if _BLOCK.match(parent):
        if name == "dw_kernel":
            a = _conv(a)
        elif name in ("w1", "w2"):
            a = a.T
    elif name == "kernel":
        if parent == "upsample":
            a = np.transpose(a[::-1, ::-1], (2, 3, 0, 1))
        elif a.ndim == 4:
            a = _conv(a)
        elif a.ndim == 2:
            a = a.T
        else:
            raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {a.shape}")
        name = "weight"
    elif name == "scale":
        name = "weight"
    return ".".join(scope + [name]), a


_STATS = {"mean": "running_mean", "var": "running_var"}


def flax_to_torch(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """Flax ``{params, batch_stats}`` trees -> a torch ``state_dict`` for
    ``MultitaskModel`` (or any of its submodules, given the matching
    subtrees)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, a in _walk(params):
        key, v = _param(path, a)
        sd[key] = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    for path, a in _walk(batch_stats):
        *scope, name = path
        sd[".".join(scope + [_STATS[name]])] = torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32)
        )
        sd[".".join(scope + ["num_batches_tracked"])] = torch.tensor(0)
    return sd


def _unparam(key: str, a: np.ndarray) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Inverse of :func:`_param`: a torch key and tensor -> Flax path and leaf."""
    *scope, name = key.split(".")
    parent = scope[-1] if scope else ""
    if _BLOCK.match(parent):
        if name == "dw_kernel":
            a = np.transpose(a, (2, 3, 1, 0))
        elif name in ("w1", "w2"):
            a = a.T
    elif name == "weight":
        if a.ndim == 1:  # a BN / LN scale
            name = "scale"
        else:
            if parent == "upsample":
                a = np.transpose(a, (2, 3, 0, 1))[::-1, ::-1]
            elif a.ndim == 4:
                a = np.transpose(a, (2, 3, 1, 0))
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"unexpected weight rank at {key}: {a.shape}")
            name = "kernel"
    return tuple(scope) + (name,), a


def _insert(tree: Dict, path: Tuple[str, ...], a: np.ndarray) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = np.ascontiguousarray(a)


def torch_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """Inverse of :func:`flax_to_torch`: a ``MultitaskModel`` ``state_dict`` ->
    Flax ``(params, batch_stats)`` nested dicts of fp32 numpy arrays
    (``num_batches_tracked`` has no Flax leaf and is dropped), so that a
    machine without JAX can write a checkpoint with :func:`save_npz`."""
    params: Dict = {}
    stats: Dict = {}
    inv_stats = {v: k for k, v in _STATS.items()}
    for key, t in state_dict.items():
        *scope, name = key.split(".")
        if name == "num_batches_tracked":
            continue
        a = t.detach().float().cpu().numpy()
        if name in inv_stats:
            _insert(stats, tuple(scope) + (inv_stats[name],), a)
        else:
            _insert(params, *_unparam(key, a))
    return params, stats


def save_npz(path: str, params: Tree, batch_stats: Tree) -> None:
    """Write both trees to one ``.npz`` with keys ``params/...`` and
    ``batch_stats/...``."""
    flat = {}
    for root, tree in (("params", params), ("batch_stats", batch_stats)):
        for p, a in _walk(tree):
            flat["/".join((root,) + p)] = a
    np.savez(path, **flat)


def load_npz(path: str) -> Tuple[Dict, Dict]:
    """Inverse of :func:`save_npz`: ``(params, batch_stats)`` nested dicts."""
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            root, *rest = key.split("/")
            node = trees[root]
            for part in rest[:-1]:
                node = node.setdefault(part, {})
            node[rest[-1]] = z[key]
    return trees["params"], trees["batch_stats"]
