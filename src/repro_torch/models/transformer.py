"""Model: init, caches, the training forward, prefill and one-token
decode for every family of the reference — dense and MoE decoders with
full or local/global attention, the xLSTM stack, the Mamba-attention
hybrid, the encoder-only audio model and the vision-language decoder
(twin of ``repro.models.transformer``).

Parameters are a plain dict::

    {"embed": bf16[V, d], "final_norm": f32[d], "lm_head": MPLinear,
     ["frontend_proj": MPLinear, "pos_embed": bf16[65536, d]],
     "layers": LayerList([{"norm1", "attn": {wq, wk, wv, wo}
                                    | "mamba": {...}, "norm2",
                           "mlp": {up, gate, down}
                           | "moe": {router, gate, up, down, [shared]}}
                          | {"norm1", "mlstm" | "slstm": {...}},
                          ...])}

Layer i's kinds are ``cfg.layer_kinds()[i]``: mixer ``attn_full`` or
``attn_local`` (a sliding window of ``cfg.local_window``; its cache is a
ring buffer of ``min(seq_len, local_window)`` slots), ``mamba``
(``models.mamba``) or ``mlstm`` / ``slstm`` (``models.xlstm``); a
recurrent mixer's cache is its fp32 state, replaced or updated in place
each step.  The ffn is ``mlp``, ``moe`` or ``none`` (the xLSTM cells
carry their own).  Layers run in a Python loop; the reference scans them
in segments of whole pattern periods, and
:class:`~repro_torch.tree.LayerList` carries the period so the port's
trees walk as the reference's (``repro_torch.tree``).

The frontends are stubs, as in the reference: precomputed embeddings
arrive in the batch and ``frontend_proj`` (a KSplit linear at the
default tile and format set for ``frontend_dim``) maps them to the model
width.  An audio config embeds ``frames`` alone; a vision config puts
its projected ``patch_embeds`` ahead of the embedded ``tokens``, and its
loss covers the text positions only.  An encoder-only config adds the
learned ``pos_embed`` table, attends without the causal mask and has no
decode step.

Each model step's forward is a ``model.forward`` span; in the training
and bulk prefill forwards it holds each layer's mixer and FFN
(``model.attention`` and the like, ``layer=i``, norm included) and
``model.head`` (``obs``; no-ops unless tracing).

Under a mesh with a "model" axis (``models.shard_hints.hints_enabled``)
an MoE FFN runs ``moe.moe_block_sharded`` on the rank's expert slices,
as the reference's does; everything else runs whole on every rank.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.core.formats import FormatSet
from repro_torch.core.linear import init_mp_linear
from repro_torch.models import common as C
from repro_torch.models import mamba as M
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X
from repro_torch.models.common import ACT_DTYPE
from repro_torch.models.shard_hints import active_mesh
from repro_torch.tree import LayerList

#: rows of an encoder's learned position table (the reference's)
POS_TABLE = 65536

#: every family the reference registers
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def dims_of(cfg: ArchConfig) -> C.AttnDims:
    return C.attn_dims(cfg.n_heads, cfg.n_kv_heads, cfg.d_model, cfg.tp,
                       cfg.head_dim, cfg.kv_dup_to_tp)


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not one of the reference's "
            f"{PORTED_FAMILIES}")


#: the span of each layer kind's mixer and FFN
MIXER_SPAN = {"attn_full": "model.attention", "attn_local": "model.attention",
              "mamba": "model.mamba", "mlstm": "model.mlstm",
              "slstm": "model.slstm"}
FFN_SPAN = {"mlp": "model.mlp", "moe": "model.moe"}


def _window(cfg: ArchConfig, mixer: str):
    return cfg.local_window if mixer == "attn_local" else None


def _init_layer(gen, cfg: ArchConfig, mixer: str, ffn: str) -> dict:
    dev = gen.device
    fs = FormatSet.from_key(cfg.mp_formats)
    p: dict[str, Any] = {"norm1": C.init_rms_norm(cfg.d_model, dev)}
    if mixer == "mlstm":
        p["mlstm"] = X.init_mlstm(gen, cfg.d_model, cfg.n_heads,
                                  cfg.mp_policy, tile=cfg.mp_tile)
    elif mixer == "slstm":
        p["slstm"] = X.init_slstm(gen, cfg.d_model, cfg.n_heads,
                                  cfg.mp_policy, tile=cfg.mp_tile)
    elif mixer == "mamba":
        p["mamba"] = M.init_mamba(gen, cfg.d_model, cfg.mp_policy,
                                  expand=cfg.mamba_expand,
                                  d_state=cfg.mamba_d_state,
                                  tile=cfg.mp_tile)
    else:
        p["attn"] = C.init_attention(gen, cfg.d_model, dims_of(cfg),
                                     cfg.mp_policy, cfg.mp_tile, fset=fs,
                                     device=dev)
    if ffn != "none":
        p["norm2"] = C.init_rms_norm(cfg.d_model, dev)
    if ffn == "mlp":
        p["mlp"] = C.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mp_policy,
                              cfg.mp_tile, gated=cfg.gated_mlp, fset=fs,
                              device=dev)
    elif ffn == "moe":
        p["moe"] = MOE.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                cfg.top_k, cfg.mp_policy,
                                n_shared=cfg.n_shared,
                                shared_d_ff=cfg.shared_d_ff or None,
                                tile=cfg.mp_tile, ep=cfg.moe_ep)
    return p


def init_model(gen: torch.Generator, cfg: ArchConfig) -> dict:
    """Random weights from a seeded generator, on the generator's device
    (``torch.Generator(device="cuda").manual_seed(s)`` for the card)."""
    check_family(cfg)
    dev = gen.device
    fs = FormatSet.from_key(cfg.mp_formats)
    params: dict[str, Any] = {
        "embed": C.init_embedding(gen, cfg.vocab, cfg.d_model, dev),
        "final_norm": C.init_rms_norm(cfg.d_model, dev),
        "lm_head": init_mp_linear(gen, cfg.d_model, cfg.vocab,
                                  cfg.mp_policy, split="ksplit",
                                  tile=cfg.mp_tile, fset=fs, device=dev),
    }
    if cfg.frontend != "none":
        # the reference's default tile and format set, not the config's
        params["frontend_proj"] = init_mp_linear(
            gen, cfg.frontend_dim, cfg.d_model, cfg.mp_policy,
            split="ksplit", tile=None, device=dev)
    if cfg.encoder_only:
        params["pos_embed"] = (torch.randn(
            (POS_TABLE, cfg.d_model), generator=gen, device=dev,
            dtype=torch.float32) * 0.02).to(ACT_DTYPE)
    params["layers"] = LayerList(
        [_init_layer(gen, cfg, mixer, ffn)
         for mixer, ffn in cfg.layer_kinds()],
        cfg.pattern_period())
    return params


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device="cuda") -> list[dict]:
    """One zeroed cache per layer: a ``{"k", "v"}`` pair of [B, S, n_kv,
    dh] bf16 for attention (a local layer's S is ``min(seq_len,
    local_window)``), the fp32 recurrent state for a Mamba mixer or an
    xLSTM cell."""
    dims = dims_of(cfg)
    out = []
    for mixer, _ in cfg.layer_kinds():
        if mixer == "mlstm":
            out.append(X.init_mlstm_state(batch, cfg.d_model, cfg.n_heads,
                                          device=device))
            continue
        if mixer == "slstm":
            out.append(X.init_slstm_state(batch, cfg.d_model, cfg.n_heads,
                                          device=device))
            continue
        if mixer == "mamba":
            out.append(M.init_mamba_state(batch, cfg.d_model,
                                          expand=cfg.mamba_expand,
                                          d_state=cfg.mamba_d_state,
                                          device=device))
            continue
        s = min(seq_len, cfg.local_window) if mixer == "attn_local" \
            else seq_len
        shape = (batch, s, dims.n_kv, dims.head_dim)
        out.append({"k": torch.zeros(shape, dtype=ACT_DTYPE, device=device),
                    "v": torch.zeros(shape, dtype=ACT_DTYPE, device=device)})
    return out


def _ffn(lp, cfg: ArchConfig, ffn: str, h, aux: bool = False,
         drops: list | None = None):
    """(ffn output, the MoE aux loss when ``aux``, else None)."""
    if ffn == "mlp":
        return C.mlp_block(lp["mlp"], h), None
    mesh = active_mesh()
    if mesh is not None and "model" in mesh.axis_names:
        out, a = MOE.moe_block_sharded(
            lp["moe"], h, top_k=cfg.top_k, mesh=mesh, ep=cfg.moe_ep,
            capacity_factor=cfg.capacity_factor, drops=drops)
        return out, (a if aux else None)
    out = MOE.moe_block(lp["moe"], h, top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor,
                        return_aux=aux, drops=drops)
    return out if aux else (out, None)


def _batch_of(cfg: ArchConfig, inputs) -> dict:
    """The reference's batch dict; a bare token tensor [B, S] stands for
    ``{"tokens": inputs}`` where the config has no frontend."""
    if isinstance(inputs, dict):
        return inputs
    if cfg.frontend != "none":
        raise ValueError(
            f"{cfg.name} has a {cfg.frontend} frontend: pass the batch dict "
            "(" + ("frames" if cfg.frontend == "audio"
                   else "patch_embeds and tokens") + "), not a token tensor")
    return {"tokens": inputs}


def _embed_inputs(params, cfg: ArchConfig, batch: dict):
    """Token or frontend embedding: (x [B, S, d] bf16, positions [B, S])."""
    if cfg.frontend == "audio":
        x = params["frontend_proj"](batch["frames"].to(ACT_DTYPE))
        x = x.to(ACT_DTYPE)
    elif cfg.frontend == "vision":
        pe = params["frontend_proj"](
            batch["patch_embeds"].to(ACT_DTYPE)).to(ACT_DTYPE)
        te = C.embed(params["embed"], batch["tokens"])
        x = torch.cat([pe, te], dim=1)
    else:
        x = C.embed(params["embed"], batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.encoder_only:
        x = x + params["pos_embed"][None, :S]
    return x, positions


def _run_layers(params, cfg: ArchConfig, inputs):
    """Embed ``inputs`` (a batch dict, or a token tensor [B, S] for a
    config without a frontend) and run every layer over the full sequence
    (causal, windowed on local layers; bidirectional in an encoder);
    returns the residual stream [B, S, d] and the summed MoE aux loss."""
    dims = dims_of(cfg)
    x, positions = _embed_inputs(params, cfg, _batch_of(cfg, inputs))
    causal = not cfg.encoder_only
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (lp, (mixer, ffn)) in enumerate(zip(params["layers"],
                                              cfg.layer_kinds())):
        with obs.span(MIXER_SPAN[mixer], "model", layer=i):
            h = C.rms_norm(x, lp["norm1"], cfg.norm_eps)
            if mixer == "mlstm":
                x = x + X.mlstm_block(lp["mlstm"], h, n_heads=cfg.n_heads)
            elif mixer == "slstm":
                x = x + X.slstm_block(lp["slstm"], h, n_heads=cfg.n_heads)
            elif mixer == "mamba":
                x = x + M.mamba_block(lp["mamba"], h)
            else:
                x = x + C.attention_block(lp["attn"], h, dims,
                                          positions=positions,
                                          causal=causal,
                                          window=_window(cfg, mixer),
                                          rope_theta=cfg.rope_theta,
                                          use_rope=cfg.use_rope)
        if ffn == "none":
            x = x.to(ACT_DTYPE)
            continue
        with obs.span(FFN_SPAN[ffn], "model", layer=i):
            h2 = C.rms_norm(x, lp["norm2"], cfg.norm_eps)
            out, a = _ffn(lp, cfg, ffn, h2, aux=True)
            x = (x + out).to(ACT_DTYPE)
        if a is not None:
            aux = aux + a
    return x, aux


def _head(params, cfg: ArchConfig, x):
    """Final norm and ``lm_head``: logits [B, S, V] fp32."""
    with obs.span("model.head", "model"):
        x = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return params["lm_head"](x)


def forward_train(params, cfg: ArchConfig, batch: dict):
    """Training forward: ``batch`` (the pipeline's dict: ``tokens``,
    ``frames`` or ``patch_embeds`` and ``tokens``, and ``labels``) →
    (loss, metrics).  A vision config's loss covers the text positions
    (the last ``labels.shape[1]``).  An MoE config's loss adds 0.01 times
    the layers' summed load-balance aux, and ``metrics["ce"]`` is that
    sum, as the reference reports it.  No remat: the reference's ``jax.checkpoint`` saves memory
    and changes no number.  Past the local window the local layers attend
    to the last w keys, as the reference's decode does; the reference's
    bulk band admits up to 2w - 1 (``ROADMAP.md`` queue 3, F8: decided
    for the decode's band)."""
    check_family(cfg)
    with obs.span("model.forward", "model", mode="train"):
        x, aux = _run_layers(params, cfg, batch)
        logits = _head(params, cfg, x)
        labels = batch["labels"]
        if cfg.frontend == "vision":
            logits = logits[:, -labels.shape[1]:]
        loss = C.cross_entropy(logits, labels)
        if cfg.n_experts:
            loss = loss + 0.01 * aux
    return loss, {"ce": loss, "aux": aux}


def forward_prefill(params, cfg: ArchConfig, batch) -> torch.Tensor:
    """Run the prompt — the reference's batch dict (``tokens``,
    ``frames``, or ``patch_embeds`` and ``tokens``), or a token tensor
    [B, S] for a config without a frontend — and return the
    last-position logits [B, 1, V].  Causal (bidirectional in an
    encoder), windowed on local layers: past the window they attend to
    the last w keys, as the reference's decode does, not to its bulk
    band of up to 2w - 1 (``ROADMAP.md`` queue 3, F8)."""
    check_family(cfg)
    with obs.span("model.forward", "model", mode="prefill"):
        x, _ = _run_layers(params, cfg, batch)
        return _head(params, cfg, x[:, -1:])


def forward_decode(params, cfg: ArchConfig, tokens: torch.Tensor, caches,
                   position, *, slot=None, kv_valid=None,
                   moe_drops: list | None = None):
    """One-token decode step.  tokens: [B, 1]; caches from
    :func:`init_cache` (updated in place).  ``position`` is an int or a
    per-row [B] tensor (then with ``slot`` and ``kv_valid``, as in
    :func:`~repro_torch.models.common.decode_attention`; full attention
    only).  ``moe_drops``, when given, collects each MoE layer's count of
    dropped (token, expert) pairs (device scalars).  A recurrent layer's
    state dict takes the step's new state (mLSTM's C and Mamba's h in
    place, the rest replaced); it needs no position.  Returns (logits
    [B, 1, V] fp32, caches).  An encoder-only config has no decode step:
    ValueError, as in the reference."""
    check_family(cfg)
    if cfg.encoder_only:
        raise ValueError("encoder-only arch has no decode step")
    dims = dims_of(cfg)
    # one span a step and none inside: a served burst is hundreds of
    # steps of ~2,500 kernels each, and portbench/devtrace.py's idle_gaps
    # walks every span for every gap between two kernels
    with obs.span("model.forward", "model", mode="decode"):
        x = C.embed(params["embed"], tokens)
        for lp, cache, (mixer, ffn) in zip(params["layers"], caches,
                                           cfg.layer_kinds()):
            h = C.rms_norm(x, lp["norm1"], cfg.norm_eps)
            if mixer in ("mlstm", "slstm"):
                block = X.mlstm_block if mixer == "mlstm" else X.slstm_block
                out, new = block(lp[mixer], h, n_heads=cfg.n_heads,
                                 state=cache)
                cache.update(new)
                x = (x + out).to(ACT_DTYPE)
                continue
            if mixer == "mamba":
                out, new = M.mamba_block(lp["mamba"], h, state=cache)
                cache.update(new)
                x = x + out
            else:
                x = x + C.decode_attention(
                    lp["attn"], h, dims, cache["k"], cache["v"],
                    position=position, rope_theta=cfg.rope_theta,
                    window=_window(cfg, mixer), use_rope=cfg.use_rope,
                    slot=slot, kv_valid=kv_valid)
            h2 = C.rms_norm(x, lp["norm2"], cfg.norm_eps)
            out, _ = _ffn(lp, cfg, ffn, h2, drops=moe_drops)
            x = (x + out).to(ACT_DTYPE)
        x = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return params["lm_head"](x), caches
