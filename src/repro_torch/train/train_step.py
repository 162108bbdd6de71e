"""Training step: microbatched gradient accumulation + AdamW (twin of
``repro.train.train_step``).

``make_train_step(cfg, ocfg, microbatches)`` resolves every KSplit
linear's plan once at setup, at the per-microbatch token count, and
returns the step.  Gradients come from ``torch.autograd`` over the
parameter tensors; each KSplit linear's forward is its dispatched path
(the ksplit kernel on the card) and its backward the gathering path's
VJP (``tune.dispatch._KSplitLinear``).  Microbatches split the batch
along its batch dim and run in turn, so peak activation memory is one
microbatch's; their gradients accumulate in bf16 with fp32 error
feedback (``optim.grad_compress``), or in fp32.

Spans (``obs``, no-ops unless tracing): ``train.step`` around a step;
inside it ``train.accumulate`` around the microbatch loop (more than one
microbatch), the model's ``model.forward``, ``train.backward`` around
``torch.autograd.grad`` (autograd's own thread launches the backward's
kernels while it is open) and ``train.optimizer`` around AdamW.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch import tree as TR
from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as GC
from repro_torch.tune import dispatch


def loss_and_grads(params, cfg: ArchConfig, batch: dict):
    """``(loss, metrics, grads)`` of :func:`~repro_torch.models.
    transformer.forward_train`; ``grads`` has ``params``' structure, each
    tensor in its parameter's dtype (zeros where a parameter is unused,
    as an empty buffer is)."""
    leaves = TR.tensors(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, metrics = T.forward_train(params, cfg, batch)
        with obs.span("train.backward", "train"):
            got = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = TR.replace_tensors(params, {
        id(t): torch.zeros_like(t) if g is None else g
        for t, g in zip(leaves, got)})
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def make_train_step(cfg: ArchConfig, ocfg: adamw.AdamWConfig,
                    microbatches: int = 1, compress_accum: bool = True,
                    tune_params=None, tune_tokens: int | None = None):
    """The step ``(params, opt_state, batch) → (params, opt_state,
    metrics)``.  ``tune_params``: a parameter tree whose every KSplit
    linear gets its plan resolved now, at ``tune_tokens`` rows, so the
    steps do no fresh resolution."""
    if tune_params is not None:
        with obs.span("train.tune_setup", "train",
                      m_hint=tune_tokens or 4096):
            dispatch.warm_registry()
            dispatch.tune_linear_params(tune_params,
                                        m_hint=tune_tokens or 4096)
    if obs.is_enabled():
        obs.event("train.step_config", "train", microbatches=microbatches,
                  compress_accum=compress_accum,
                  tuned=tune_params is not None)

    def accumulate(params, batch):
        """(loss, metrics, grads) over ``microbatches`` slices of the
        batch, in turn."""
        b = next(iter(batch.values())).shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{microbatches} microbatches")
        mb = b // microbatches
        acc = TR.map_tensors(lambda p: torch.zeros(
            p.shape, device=p.device,
            dtype=torch.bfloat16 if compress_accum else torch.float32),
            params)
        err = GC.ef_init(params) if compress_accum else None
        loss_sum = None
        for i in range(microbatches):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, _, grads = loss_and_grads(params, cfg, micro)
            if compress_accum:
                acc, err = GC.accumulate(acc, grads, err)
            else:
                acc = TR.map_tensors(lambda a, g: a + g.to(a.dtype),
                                     acc, grads)
            del grads
            loss_sum = loss if loss_sum is None else loss_sum + loss
        grads = TR.map_tensors(lambda a: a.float() / microbatches, acc)
        del acc, err
        loss = loss_sum / microbatches
        return loss, {"ce": loss,
                      "aux": torch.zeros((), device=loss.device)}, grads

    def train_step(params, opt_state, batch):
        with obs.span("train.step", "train"):
            if microbatches == 1:
                loss, metrics, grads = loss_and_grads(params, cfg, batch)
            else:
                with obs.span("train.accumulate", "train",
                              microbatches=microbatches):
                    loss, metrics, grads = accumulate(params, batch)
            with obs.span("train.optimizer", "train"):
                params, opt_state, opt_metrics = adamw.update(
                    params, grads, opt_state, ocfg)
        return params, opt_state, dict(metrics, **opt_metrics, loss=loss)

    return train_step
