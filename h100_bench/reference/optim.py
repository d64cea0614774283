"""The plain train step: forward, loss, backward, clip, AdamW.

Clip by the global norm (the norm of the per-parameter norms): ``g * clip /
norm`` when ``norm >= clip``. AdamW (b1 0.9, b2 0.999, eps 1e-8) with
decoupled weight decay on every parameter and bias correction at step
count + 1; the learning rate follows a cosine decay from ``lr`` to ``lr *
alpha`` over ``decay_steps``, read at the count before the step.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .loss import multitask_loss
from .model import MultitaskModel

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamW:
    def __init__(self, params: List[torch.Tensor], lr=1e-4, weight_decay=5e-4, grad_clip=10.0,
                 decay_steps=50_000, alpha=0.01):
        self.params = params
        self.lr, self.wd, self.clip = lr, weight_decay, grad_clip
        self.decay_steps, self.alpha = decay_steps, alpha
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    def lr_now(self) -> float:
        t = min(self.count, self.decay_steps)
        cos = 0.5 * (1.0 + math.cos(math.pi * t / self.decay_steps))
        return self.lr * ((1.0 - self.alpha) * cos + self.alpha)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]):
        """Returns the global norm before clipping and the clipped
        gradients."""
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        if norm >= self.clip:
            grads = [g / norm * self.clip for g in grads]
        lr = self.lr_now()
        self.count += 1
        c1, c2 = 1.0 - B1 ** self.count, 1.0 - B2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            v.mul_(B2).add_(g * g, alpha=1.0 - B2)
            p.add_(-lr * ((m / c1) / ((v / c2).sqrt() + EPS) + self.wd * p))
        return norm, grads


def train_step(model: MultitaskModel, opt: AdamW, batch: Dict, assigner: str = "tal"):
    """One step on ``batch`` (uint8 ``image`` and the padded ground
    truth); returns the loss terms, the global gradient norm, the clipped
    gradients by parameter name, and the forward's image logits and mask
    probabilities."""
    out = model(batch["image"].float() / 255.0, train=True, mode="train")
    terms = multitask_loss(out, batch, model.cfg, assigner)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    model.ctx.bn_frozen = True  # a checkpointed segment's recompute moves no statistic
    try:
        grads = torch.autograd.grad(terms["total"], params, allow_unused=True)
    finally:
        model.ctx.bn_frozen = False
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    norm, clipped = opt.step(grads)
    fwd = {"cls_logits": out["cls_logits"].detach(),
           "seg_prob": torch.sigmoid(out["seg_logits"].detach())}
    return ({k: v.detach() for k, v in terms.items()}, norm, dict(zip(names, clipped)), fwd)
