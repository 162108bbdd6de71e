"""Dense decoder: init, KV caches, the training forward, prefill and
one-token decode (twin of the dense family of
``repro.models.transformer``).

Parameters are a plain dict::

    {"embed": bf16[V, d], "final_norm": f32[d], "lm_head": MPLinear,
     "layers": [{"norm1", "attn": {wq, wk, wv, wo}, "norm2",
                 "mlp": {up, gate, down}}, ...]}

Layers run in a Python loop (the reference's ``scan`` over stacked
layers has no counterpart that an eager decode step needs).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.formats import FormatSet
from repro_torch.core.linear import init_mp_linear
from repro_torch.models import common as C
from repro_torch.models.common import ACT_DTYPE


def dims_of(cfg: ArchConfig) -> C.AttnDims:
    return C.attn_dims(cfg.n_heads, cfg.n_kv_heads, cfg.d_model, cfg.tp,
                       cfg.head_dim, cfg.kv_dup_to_tp)


def _check_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r}: only dense decoders are ported")


def init_model(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random weights from a seeded generator, on the generator's device
    (``torch.Generator(device="cuda").manual_seed(s)`` for the card)."""
    _check_dense(cfg)
    dev = gen.device
    fs = FormatSet.from_key(cfg.mp_formats)
    dims = dims_of(cfg)
    params: dict[str, Any] = {
        "embed": C.init_embedding(gen, cfg.vocab, cfg.d_model, dev),
        "final_norm": C.init_rms_norm(cfg.d_model, dev),
        "lm_head": init_mp_linear(gen, cfg.d_model, cfg.vocab,
                                  cfg.mp_policy, split="ksplit",
                                  tile=cfg.mp_tile, fset=fs, device=dev),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "norm1": C.init_rms_norm(cfg.d_model, dev),
            "attn": C.init_attention(gen, cfg.d_model, dims, cfg.mp_policy,
                                     cfg.mp_tile, fset=fs, device=dev),
            "norm2": C.init_rms_norm(cfg.d_model, dev),
            "mlp": C.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mp_policy,
                              cfg.mp_tile, gated=cfg.gated_mlp, fset=fs,
                              device=dev),
        })
    return params


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device="cuda") -> list[dict]:
    """One zeroed ``{"k", "v"}`` pair of [B, S, n_kv, dh] bf16 per layer."""
    dims = dims_of(cfg)
    shape = (batch, seq_len, dims.n_kv, dims.head_dim)
    return [{"k": torch.zeros(shape, dtype=ACT_DTYPE, device=device),
             "v": torch.zeros(shape, dtype=ACT_DTYPE, device=device)}
            for _ in range(cfg.n_layers)]


def _run_layers(params, cfg: ArchConfig, tokens: torch.Tensor
                ) -> torch.Tensor:
    """Embed ``tokens`` [B, S] and run every layer with causal attention
    over the full sequence; returns the residual stream [B, S, d]."""
    dims = dims_of(cfg)
    x = C.embed(params["embed"], tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    for lp in params["layers"]:
        h = C.rms_norm(x, lp["norm1"], cfg.norm_eps)
        x = x + C.attention_block(lp["attn"], h, dims, positions=positions,
                                  rope_theta=cfg.rope_theta,
                                  use_rope=cfg.use_rope)
        h2 = C.rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = (x + C.mlp_block(lp["mlp"], h2)).to(ACT_DTYPE)
    return x


def forward_train(params, cfg: ArchConfig, batch: dict):
    """Training forward: ``batch`` {"tokens", "labels"} [B, S] → (loss,
    metrics).  No remat: the reference's ``jax.checkpoint`` saves memory
    and changes no number."""
    _check_dense(cfg)
    x = _run_layers(params, cfg, batch["tokens"])
    x = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = C.cross_entropy(params["lm_head"](x), batch["labels"])
    return loss, {"ce": loss, "aux": torch.zeros((), device=loss.device)}


def forward_prefill(params, cfg: ArchConfig, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """Run the prompt [B, S] with causal attention; last-position logits
    [B, 1, V]."""
    _check_dense(cfg)
    x = _run_layers(params, cfg, tokens)
    x = C.rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return params["lm_head"](x)


def forward_decode(params, cfg: ArchConfig, tokens: torch.Tensor, caches,
                   position, *, slot=None, kv_valid=None):
    """One-token decode step.  tokens: [B, 1]; caches from
    :func:`init_cache` (updated in place).  ``position`` is an int or a
    per-row [B] tensor (then with ``slot`` and ``kv_valid``, as in
    :func:`~repro_torch.models.common.decode_attention`).  Returns
    (logits [B, 1, V] fp32, caches)."""
    _check_dense(cfg)
    dims = dims_of(cfg)
    x = C.embed(params["embed"], tokens)
    for lp, cache in zip(params["layers"], caches):
        h = C.rms_norm(x, lp["norm1"], cfg.norm_eps)
        x = x + C.decode_attention(
            lp["attn"], h, dims, cache["k"], cache["v"], position=position,
            rope_theta=cfg.rope_theta, use_rope=cfg.use_rope, slot=slot,
            kv_valid=kv_valid)
        h2 = C.rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = (x + C.mlp_block(lp["mlp"], h2)).to(ACT_DTYPE)
    x = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return params["lm_head"](x), caches
