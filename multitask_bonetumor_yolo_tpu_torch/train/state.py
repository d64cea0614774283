"""Train state and optimizer (counterpart of the JAX ``train/state.py``).

The JAX package chains ``optax.clip_by_global_norm(grad_clip)`` and
``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
parameter) under ``optax.cosine_decay_schedule(lr, max_epochs *
steps_per_epoch, cosine_alpha)``, and skips a step whose gradient has a
non-finite leaf. The port does the same arithmetic in place on the device,
over all parameters at once (flat fp32 buffers), without waiting for it:

  * clip as optax: ``g / norm * max`` only when ``norm >= max`` (no ``+1e-6``,
    unlike ``torch.nn.utils.clip_grad_norm_``);
  * Adam moments, bias correction with the optimizer's count + 1, the step
    ``-lr(count) * (m_hat / (sqrt(v_hat) + eps) + wd * p)``, the schedule read
    at the optimizer's own count;
  * the skip: when any gradient element is not finite, the parameters, the BN
    running statistics, the moments and the count keep their values (a
    ``torch.where`` on the device, no host read), and only ``step`` advances.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from ..models import ModelConfig, MultitaskModel, build_model

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX ``TrainConfig``'s fields and defaults: the optimizer's, the
    trainer loop's (early stopping, checkpoints) and the evaluation's (NMS
    thresholds of ``make_eval_step``)."""

    lr: float = 1e-4
    weight_decay: float = 5e-4
    max_epochs: int = 500
    steps_per_epoch: int = 100
    grad_clip: float = 10.0
    cosine_alpha: float = 0.01  # eta_min = lr * alpha
    seed: int = 123
    early_stop_patience: int = 50  # epochs without mAP50 improvement
    map_full_freq: int = 5  # epochs between full mAP50-95 computes
    ckpt_dir: str = "checkpoints"
    ckpt_top_k: int = 2
    save_last_every: int = 5  # epochs between unconditional 'last' saves
    eval_conf_thresh: float = 0.05
    eval_nms_iou: float = 0.6
    eval_top_k: int = 100

    @property
    def decay_steps(self) -> int:
        return max(1, self.max_epochs * self.steps_per_epoch)


def lr_at(cfg: TrainConfig, count) -> float | torch.Tensor:
    """``optax.cosine_decay_schedule(lr, decay_steps, alpha)`` at ``count``
    (an int, or a tensor on the device)."""
    if isinstance(count, torch.Tensor):
        t = count.float().clamp(max=float(cfg.decay_steps))
        cos = 0.5 * (1.0 + torch.cos(math.pi * t / cfg.decay_steps))
    else:
        cos = 0.5 * (1.0 + math.cos(math.pi * min(count, cfg.decay_steps) / cfg.decay_steps))
    return cfg.lr * ((1.0 - cfg.cosine_alpha) * cos + cfg.cosine_alpha)


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tensors])


def _write(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    """Copy ``flat`` back into ``tensors`` (in place)."""
    views = [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in tensors]), tensors)]
    torch._foreach_copy_(tensors, views)


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN running statistics), the AdamW moments
    ``mu`` / ``nu`` (flat fp32, in ``model.parameters()`` order), the
    optimizer's ``count`` (int64 on the device: applied steps) and ``step``
    (every call). :meth:`apply_gradients` updates all of it in place."""

    model: MultitaskModel
    cfg: TrainConfig
    mu: torch.Tensor
    nu: torch.Tensor
    count: torch.Tensor
    step: int = 0

    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())

    def bn_stats(self) -> List[torch.Tensor]:
        """The BN running statistics, which the train forward moves."""
        return [b for name, b in self.model.named_buffers()
                if name.endswith(("running_mean", "running_var"))]

    def bn_snapshot(self) -> torch.Tensor:
        """A flat copy of :meth:`bn_stats`, for :meth:`apply_gradients` and
        :meth:`bn_restore`."""
        return _flat(self.bn_stats())

    @torch.no_grad()
    def bn_restore(self, snapshot: torch.Tensor) -> None:
        """Put :meth:`bn_snapshot`'s values back into the BN running
        statistics (in place, bit for bit)."""
        _write(self.bn_stats(), snapshot)

    @torch.no_grad()
    def apply_gradients(self, grads: List[Optional[torch.Tensor]],
                        bn_before: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """One optimizer step from ``grads`` (one per parameter; ``None`` is
        zero), or the skip when a gradient element is not finite; then
        ``step += 1``. ``bn_before`` is :meth:`bn_snapshot`, taken before the
        forward that moved the statistics. Returns ``(grad_norm, ok)`` as
        device scalars, ``ok`` True when the step was applied."""
        params = self.params()
        grads = [torch.zeros_like(p) if d is None else d.float() for p, d in zip(params, grads)]
        g = _flat(grads)
        ok = torch.isfinite(g).all()
        # per-leaf norms, then the norm of those, as optax's global_norm: one
        # fp32 norm of the flat vector came out 4e-4 low on the CPU for the
        # ~7 M gradient elements of a small model
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        c = self.cfg
        g = torch.where(norm < c.grad_clip, g, g / norm * c.grad_clip)
        mu = ADAM_B1 * self.mu + (1.0 - ADAM_B1) * g
        nu = ADAM_B2 * self.nu + (1.0 - ADAM_B2) * (g * g)
        count_inc = self.count + 1
        mu_hat = mu / (1.0 - ADAM_B1 ** count_inc.float())
        nu_hat = nu / (1.0 - ADAM_B2 ** count_inc.float())
        p = _flat(params)
        update = (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS) + c.weight_decay * p) * -lr_at(c, self.count)
        _write(params, torch.where(ok, p + update, p))
        self.mu = torch.where(ok, mu, self.mu)
        self.nu = torch.where(ok, nu, self.nu)
        self.count = torch.where(ok, count_inc, self.count)
        stats = self.bn_stats()
        _write(stats, torch.where(ok, _flat(stats), bn_before))
        self.step += 1
        return norm, ok


def create_train_state(model_cfg: ModelConfig, train_cfg: TrainConfig,
                       device: torch.device | str = "cuda",
                       model: Optional[MultitaskModel] = None) -> TrainState:
    """A fresh state: ``model`` (or one built from ``train_cfg.seed``) on
    ``device``, zero moments and count."""
    if model is None:
        model = build_model(model_cfg, seed=train_cfg.seed, device=device)
    elif model.cfg != model_cfg:
        raise ValueError("create_train_state: the model was built from another ModelConfig")
    n = sum(p.numel() for p in model.parameters())
    dev = next(model.parameters()).device
    return TrainState(
        model=model, cfg=train_cfg,
        mu=torch.zeros(n, device=dev), nu=torch.zeros(n, device=dev),
        count=torch.zeros((), dtype=torch.int64, device=dev),
    )
