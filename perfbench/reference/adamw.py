"""AdamW as the traffic files state it: global-norm clipping, bias-corrected
moments, decoupled weight decay on every parameter, and a learning rate
that warms up linearly to ``peak_lr`` and then follows a cosine to
``end_lr`` at ``total_steps``."""

from __future__ import annotations

import math

import torch

__all__ = ["lr_at", "AdamW"]


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of step ``step`` (1 for the first)."""
    if step < opt["warmup_steps"]:
        return opt["peak_lr"] * step / max(opt["warmup_steps"], 1)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["end_lr"] + 0.5 * (opt["peak_lr"] - opt["end_lr"]) * (
        1 + math.cos(math.pi * t))


class AdamW:
    """Moments for a list of f32 leaves; ``step(params, grads)`` updates
    the leaves in place and returns the clipping factor it applied to the
    gradients."""

    def __init__(self, opt: dict, params: list):
        self.opt = opt
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, params: list, grads: list) -> float:
        o = self.opt
        self.count += 1
        t = self.count
        lr = lr_at(o, t)
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(o["grad_clip"] / (norm + 1e-9), max=1.0).float()
        for p, g, m, v in zip(params, grads, self.m, self.v):
            g = g * scale
            m.mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            v.mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
            mh = m / (1 - o["b1"] ** t)
            vh = v / (1 - o["b2"] ** t)
            p.sub_(lr * (mh / (vh.sqrt() + o["eps"]) + o["weight_decay"] * p))
        return float(scale)
