"""Gradient compression with error feedback (twin of
``repro.optim.grad_compress``).

Microbatch accumulation keeps the gradient accumulator in bf16 with an
fp32 error-feedback residual, halving the accumulator's memory while the
accumulated sum stays unbiased.  The reference's second use, the
cross-pod hierarchical all-reduce (``cross_pod_mean``: bf16 with error
feedback before the pod-axis sum), needs data-parallel training across
ranks and is not ported here (``ROADMAP.md`` queue 1, item 6b).
"""
from __future__ import annotations

import torch

from repro_torch import tree as TR


def ef_init(tree):
    """fp32 error-feedback residuals, zeros like the gradient tree."""
    return TR.map_tensors(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                device=g.device), tree)


def _split(pairs, tree):
    new = {id(t): p for t, p in zip(TR.tensors(tree), pairs)}
    return (TR.replace_tensors(tree, {k: v[0] for k, v in new.items()}),
            TR.replace_tensors(tree, {k: v[1] for k, v in new.items()}))


def compress(grads, err):
    """(grads, err) → (bf16 grads, new err): ``g_c = bf16(g + e)``,
    ``e' = (g + e) - g_c``."""
    def one(g, e):
        g32 = g.float() + e
        gc = g32.to(torch.bfloat16)
        return gc, g32 - gc.float()
    return _split([one(g, e) for g, e in zip(TR.tensors(grads),
                                             TR.tensors(err))], grads)


def accumulate(acc, grads, err):
    """Add ``grads`` into a bf16 accumulator with error feedback; every
    cast explicit (an fp8 buffer's gradient arrives as fp8)."""
    def one(a, g, e):
        s = a.float() + g.float() + e
        a2 = s.to(torch.bfloat16)
        return a2, s - a2.float()
    return _split([one(a, g, e) for a, g, e in zip(
        TR.tensors(acc), TR.tensors(grads), TR.tensors(err))], acc)
