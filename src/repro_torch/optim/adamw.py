"""AdamW with fp32 master weights over mixed-precision parameter storage
(twin of ``repro.optim.adamw``).

The parameters live in the tile-heterogeneous layouts (fp32/bf16/fp8
buffers); the optimizer keeps fp32 master weights and moments and, after
each step, re-quantizes every master weight into its storage buffer by
the storage cast (``core.layout.storage_cast``: the convert kernel on the
card).  The port updates in place: each storage buffer, moment and master
tensor keeps its memory (``copy_``), so the ksplit kernel's argument
cache, keyed by buffer address, keeps hitting across steps.

Leaves are walked in the reference's order under its key paths
(:mod:`repro_torch.tree`), so the decay rule sees the reference's names.
The step's scalars (learning rate, bias corrections, clip scale) are
fp32 host numbers computed as the reference's fp32 arithmetic computes
them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import tree as TR
from repro_torch.core.layout import storage_cast


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_weights: bool = True
    #: bf16 moments halve the optimizer state; updates stay fp32
    moment_dtype: str = "float32"


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    master: Any          # fp32 master copy of the params tree, or None
    count: torch.Tensor  # int32 scalar on the host


def _f32(v) -> np.float32:
    return np.float32(v)


def lr_schedule(cfg: AdamWConfig, step) -> float:
    """Linear warmup → cosine decay to 10%, in fp32 (a host float)."""
    s = _f32(int(step))
    warm = min(s / _f32(max(cfg.warmup_steps, 1)), _f32(1.0))
    prog = np.clip((s - _f32(cfg.warmup_steps))
                   / _f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   _f32(0.0), _f32(1.0))
    cos = _f32(0.1) + _f32(0.45) * (_f32(1.0) + np.cos(_f32(np.pi) * prog))
    return float(_f32(cfg.lr_peak) * _f32(warm) * cos)


def _is_decayable(name: str) -> bool:
    """Weight decay on matmul weights only (not norms/biases); ``name``
    is the reference's key-path string (``tree.Leaf.name``)."""
    return not any(s in name for s in ("norm", "b_", "bias", "b'"))


def _moment_dtype(cfg: AdamWConfig) -> torch.dtype:
    return getattr(torch, cfg.moment_dtype)


def init(params, cfg: AdamWConfig) -> AdamWState:
    mdt = _moment_dtype(cfg)
    mu = TR.map_tensors(lambda p: torch.zeros(p.shape, dtype=mdt,
                                              device=p.device), params)
    nu = TR.map_tensors(lambda p: torch.zeros(p.shape, dtype=mdt,
                                              device=p.device), params)
    master = (TR.map_tensors(lambda p: p.float().clone(), params)
              if cfg.master_weights else None)
    return AdamWState(mu, nu, master, torch.zeros((), dtype=torch.int32))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares (a 0-d fp32
    tensor on the leaves' device)."""
    total = None
    for t in TR.tensors(tree):
        sq = torch.sum(torch.square(t.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(params, grads, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step.  Returns ``(params, state, metrics)``; ``params``
    and the state's tensors are updated in place (the same objects come
    back), ``metrics`` holds the fp32 ``lr`` and the 0-d ``grad_norm``."""
    count = state.count + 1
    lr = lr_schedule(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    n = _f32(int(count))
    b1c = float(_f32(1.0) - _f32(cfg.b1) ** n)
    b2c = float(_f32(1.0) - _f32(cfg.b2) ** n)
    mdt = _moment_dtype(cfg)
    src = state.master if cfg.master_weights else params
    leaves = zip(TR.walk(params), TR.walk(grads), TR.walk(state.mu),
                 TR.walk(state.nu), TR.walk(src))
    for lp, lg, lmu, lnu, lm in leaves:
        decay = _is_decayable(lp.name)
        for p, g, mu, nu, m in zip(lp.parts, lg.parts, lmu.parts,
                                   lnu.parts, lm.parts):
            g32 = g.float() * scale
            mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
            nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g32 * g32
            upd = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
            m32 = m.float()
            if decay:
                upd = upd + cfg.weight_decay * m32
            m_new = m32 - lr * upd
            p.copy_(storage_cast(m_new, p.dtype))  # re-quantize
            mu.copy_(mu32.to(mdt))
            nu.copy_(nu32.to(mdt))
            if cfg.master_weights:
                m.copy_(m_new)
    state = AdamWState(state.mu, state.nu, state.master, count)
    return params, state, {"lr": lr, "grad_norm": gnorm}
