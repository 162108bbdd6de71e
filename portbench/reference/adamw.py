"""Plain AdamW with fp32 master weights, as a training workload states
it: a linear warm-up to ``lr`` and a cosine decay to a tenth of it over
``total_steps``; gradients clipped to a global norm of ``grad_clip``;
bias-corrected moments; decoupled weight decay on every weight whose
name has none of ``decay_excludes`` in it.  The forward pass reads each
master through the storage rounding (a straight-through estimate), so
the masters move in fp32 and the model sees what it stores.
"""
from __future__ import annotations

import math

import torch


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1),
                   0.0), 1.0)
    return opt["lr"] * warm * (0.1 + 0.45 * (1.0 + math.cos(math.pi
                                                            * prog)))


class AdamW:
    def __init__(self, masters: dict, opt: dict):
        self.w, self.opt = masters, opt
        self.m = {k: torch.zeros_like(v) for k, v in masters.items()}
        self.v = {k: torch.zeros_like(v) for k, v in masters.items()}
        self.count = 0

    def decays(self, name: str) -> bool:
        return not any(s in name for s in self.opt["decay_excludes"])

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """One update; returns each leaf's norm of the clipped gradient
        it applied."""
        o = self.opt
        self.count += 1
        n = self.count
        lr = lr_at(o, n)
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(o["grad_clip"] / (gnorm + 1e-9), max=1.0)
        b1c, b2c = 1.0 - o["b1"] ** n, 1.0 - o["b2"] ** n
        used = {}
        for k, w in self.w.items():
            g = grads[k] * scale
            used[k] = torch.linalg.vector_norm(g)
            self.m[k].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            self.v[k].mul_(o["b2"]).add_(g * g, alpha=1 - o["b2"])
            upd = (self.m[k] / b1c) / (torch.sqrt(self.v[k] / b2c) + o["eps"])
            if self.decays(k):
                upd = upd + o["weight_decay"] * w
            w.sub_(lr * upd)
        return used
