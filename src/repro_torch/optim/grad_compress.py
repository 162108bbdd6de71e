"""Gradient compression with error feedback (twin of
``repro.optim.grad_compress``).

Two uses:

1. **Microbatch accumulation** keeps the gradient accumulator in bf16
   with an fp32 error-feedback residual, halving the accumulator's memory
   while the accumulated sum stays unbiased.
2. **Cross-pod hierarchical mean** (:func:`cross_pod_mean`): each pod's
   gradients are cast to bf16 with error feedback applied locally before
   the sum over the "pod" axis, which adds the bf16 values widened to
   fp32, as the reference's ``psum`` does.

The reference's ``cross_pod_mean`` is a single-controller ``shard_map``
whose every pod holds the same gradient tree, so its result equals the
compressed tree.  Here each pod's ranks hold their own gradients, and the
result is the mean over pods of the compressed trees.
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


def cross_pod_mean(grads, err, mesh, axis: str = "pod"):
    """Hierarchical data parallelism: the mean over ``axis`` of the
    (already pod-locally reduced) gradients, compressed to bf16 with
    error feedback.  ``compress`` first; then each bf16 tensor is summed in
    fp32 over ``axis`` (``launch.mesh.psum`` of its fp32 widening: one
    all-reduce), divided by the pod count and rounded to bf16.  Returns
    ``(mean tree, err)``, ``err`` being ``compress``'s residual."""
    from repro_torch.launch import mesh as MS
    npods = mesh.shape[axis]
    gc, err = compress(grads, err)
    new = {id(t): (MS.psum(mesh, t.float(), axis, "cross_pod") / npods
                   ).to(torch.bfloat16) for t in TR.tensors(gc)}
    return TR.replace_tensors(gc, new), err
