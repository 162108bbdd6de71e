"""Shared model components: RMSNorm, RoPE, GQA attention (causal,
bidirectional or sliding-window prefill; one-token decode with a
``kv_valid`` mask and per-row positions/slots, or a ring buffer for a
window), the gated or GELU MLP and the embedding (twin of
``repro.models.common``).

Every large matmul is an :class:`~repro_torch.core.linear.MPLinear`:
wq/wk/wv/up/gate are KSplit (the ksplit kernel on the card), wo/down are
NSplit (a library matmul).  Activations travel in bf16 (``ACT_DTYPE``);
norms, RoPE, softmax and the attention dots run in fp32.  Decode
attention over the cache is the kernel of
:mod:`repro_torch.kernels.decode_attention` (its plain version on CPU
tensors).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.formats import DEFAULT_FORMATS, FormatSet
from repro_torch.core.layout import fp32_matmul
from repro_torch.core.linear import init_mp_linear
from repro_torch.core.precision import Policy
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels.decode_attention import MASKED

ACT_DTYPE = torch.bfloat16


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(ACT_DTYPE)


def init_rms_norm(d: int, device) -> torch.Tensor:
    return torch.zeros((d,), dtype=torch.float32, device=device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """Rotary embedding.  x: [..., S, H, dh], positions: [..., S]."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnDims:
    n_q: int
    n_kv: int
    head_dim: int
    n_q_orig: int
    n_kv_orig: int

    @property
    def group(self) -> int:
        return self.n_q // self.n_kv


def attn_dims(n_heads: int, n_kv_heads: int, d_model: int,
              model_axis: int = 1, head_dim: int | None = None,
              kv_dup_to_tp: bool = False) -> AttnDims:
    """Post-padding attention geometry (q heads padded to a multiple of
    the model axis; kv heads duplicated, never dropped)."""
    dh = head_dim or d_model // n_heads
    nq = n_heads
    if nq % model_axis:
        nq = int(np.ceil(nq / model_axis) * model_axis)
    group_orig = max(1, n_heads // n_kv_heads)
    candidates = [g for g in range(1, group_orig + 1) if nq % g == 0]
    if kv_dup_to_tp:
        sharded = [g for g in candidates if (nq // g) % model_axis == 0]
        if sharded:
            candidates = sharded
    group = max(candidates)
    return AttnDims(nq, nq // group, dh, n_heads, n_kv_heads)


def init_attention(gen, d_model: int, dims: AttnDims, policy: Policy | None,
                   tile: int | None = None, fset: FormatSet = DEFAULT_FORMATS,
                   device="cuda") -> dict:
    nq, nkv, dh = dims.n_q, dims.n_kv, dims.head_dim
    kw = dict(tile=tile, fset=fset, device=device)
    return {
        "wq": init_mp_linear(gen, d_model, nq * dh, policy, split="ksplit",
                             **kw),
        "wk": init_mp_linear(gen, d_model, nkv * dh, policy, split="ksplit",
                             **kw),
        "wv": init_mp_linear(gen, d_model, nkv * dh, policy, split="ksplit",
                             **kw),
        "wo": init_mp_linear(gen, nq * dh, d_model, policy, split="nsplit",
                             **kw),
    }


def _qkv(params, x, dims: AttnDims, positions, rope_theta, use_rope=True):
    B, S, _ = x.shape
    nq, nkv, dh = dims.n_q, dims.n_kv, dims.head_dim
    q = params["wq"](x).reshape(B, S, nq, dh)
    k = params["wk"](x).reshape(B, S, nkv, dh)
    v = params["wv"](x).reshape(B, S, nkv, dh)
    if use_rope:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q.to(ACT_DTYPE), k.to(ACT_DTYPE), v.to(ACT_DTYPE)


def _repeat_kv(k: torch.Tensor, group: int) -> torch.Tensor:
    """[B, S, n_kv, dh] → [B, S, n_q, dh]."""
    return k if group == 1 else k.repeat_interleave(group, dim=2)


def _attend(q, k, v, valid) -> torch.Tensor:
    """softmax(q·kᵀ/√dh, masked by ``valid``)·v in fp32.
    q: [B, Sq, H, dh]; k/v: [B, Skv, H, dh]; valid broadcasts to
    [B, 1, Sq, Skv].  Returns [B, Sq, H, dh] fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qh = (q.float() * scale).transpose(1, 2)          # [B, H, Sq, dh]
    kh = k.float().permute(0, 2, 3, 1)                # [B, H, dh, Skv]
    s = fp32_matmul(qh, kh)                           # [B, H, Sq, Skv]
    s = torch.where(valid, s, torch.full_like(s, MASKED))
    p = torch.softmax(s, dim=-1)
    out = fp32_matmul(p, v.float().transpose(1, 2))  # [B, H, Sq, dh]
    return out.transpose(1, 2)


def sliding_window_attention(q, k, v, *, window: int) -> torch.Tensor:
    """Banded causal attention with window ``w``: block i of queries
    attends kv blocks (i-1, i) of width w, each query the last w keys
    (itself included) — the keys the decode ring buffer holds.
    q, k, v: [B, S, H, dh]; S % w == 0 when S > w.  Returns [B, S, H, dh]
    fp32.

    The reference's band mask (``repro.models.common``, ``kj > qi - w``)
    admits the whole previous block, up to 2w - 1 keys, so past the window
    its bulk forward disagrees with its own decode; the port keeps the
    w-key window of decode (``ROADMAP.md`` queue 3, F8)."""
    B, S, H, dh = q.shape
    w = window
    dev = q.device
    if S <= w:
        causal = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
        return _attend(q, k, v, causal[None, None])
    assert S % w == 0, (S, w)
    nb = S // w
    scale = 1.0 / math.sqrt(dh)

    def blocks(t):                                    # [B, H, nb, w, dh]
        return t.transpose(1, 2).reshape(B, H, nb, w, dh)

    qb = blocks(q.float() * scale)
    kb, vb = blocks(k), blocks(v)

    def band(t):                       # (previous block, this block)
        prev = torch.cat([torch.zeros_like(t[:, :, :1]), t[:, :, :-1]], 2)
        return torch.cat([prev, t], 3).float()       # [B, H, nb, 2w, dh]

    s = fp32_matmul(qb, band(kb).transpose(-1, -2))  # [B, H, nb, w, 2w]
    qi = torch.arange(w, device=dev)[:, None]
    kj = torch.arange(2 * w, device=dev)[None, :]
    valid = (kj - w <= qi) & (kj > qi)                # causal + window
    first = torch.arange(nb, device=dev)[:, None, None] == 0
    valid = valid[None] & (~first | (kj[None] >= w))
    s = torch.where(valid[None, None], s, torch.full_like(s, MASKED))
    p = torch.softmax(s, dim=-1)
    out = fp32_matmul(p, band(vb))                    # [B, H, nb, w, dh]
    return out.reshape(B, H, S, dh).transpose(1, 2)


def attention_block(params, x, dims: AttnDims, *, positions, causal=True,
                    window: int | None = None, rope_theta=10000.0,
                    use_rope=True) -> torch.Tensor:
    """Prefill attention.  x: [B, S, d].  As in the reference: banded
    when ``window`` is set and ``causal``, otherwise over every key, with
    the causal mask or (an encoder) without one.  The reference runs a
    chunked online softmax over 1024-key chunks; the port's one-pass
    softmax differs from it by fp32 summation order only."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, dims, positions, rope_theta, use_rope)
    k = _repeat_kv(k, dims.group)
    v = _repeat_kv(v, dims.group)
    if window is not None and causal:
        out = sliding_window_attention(q, k, v, window=window)
    else:
        valid = torch.ones((S, S), dtype=torch.bool, device=x.device)
        if causal:
            valid = valid.tril()
        out = _attend(q, k, v, valid[None, None])
    out = out.to(ACT_DTYPE).reshape(B, S, dims.n_q * dims.head_dim)
    return params["wo"](out).to(ACT_DTYPE)


def decode_attention(params, x, dims: AttnDims, cache_k, cache_v, *,
                     position, rope_theta=10000.0,
                     window: int | None = None, use_rope: bool = True,
                     slot: Optional[torch.Tensor] = None,
                     kv_valid: Optional[torch.Tensor] = None):
    """One-token decode.  x: [B, 1, d]; cache_k/v: [B, S_max, n_kv, dh],
    updated in place (the port's caches are mutable buffers).  Returns
    out [B, 1, d].

    ``position`` is an int (shared) or a [B] tensor (per-row, RoPE); a
    per-row position needs the cache ``slot`` ([B] tensor or int) and a
    [B, S_max] ``kv_valid`` visibility mask, as in the reference.  With a
    ``window`` the cache is a ring buffer of the last S_max positions:
    slot ``position % S_max``, every filled slot visible; a window refuses
    ``kv_valid`` and a per-row slot, as the reference does."""
    B = x.shape[0]
    S_max = cache_k.shape[1]
    batched = torch.is_tensor(position) and position.ndim != 0
    if batched and (slot is None or kv_valid is None):
        raise ValueError("per-request position needs explicit slot+kv_valid")
    if kv_valid is not None and window is not None:
        raise ValueError("kv_valid masking is full-attention only")
    if batched:
        pos = position.reshape(B, 1)
    else:
        pos = torch.full((B, 1), int(position), dtype=torch.int64,
                         device=x.device)
    q, k, v = _qkv(params, x, dims, pos, rope_theta, use_rope)
    if slot is None:
        slot = position
    rows = torch.arange(B, device=x.device)
    if torch.is_tensor(slot) and slot.ndim != 0:
        if window is not None:
            raise ValueError("per-row slot vector is full-attention only")
        idx = slot.reshape(B)
        cache_k[rows, idx] = k[:, 0].to(cache_k.dtype)
        cache_v[rows, idx] = v[:, 0].to(cache_v.dtype)
    else:
        at = int(slot) % S_max if window is not None else int(slot)
        cache_k[:, at] = k[:, 0].to(cache_k.dtype)
        cache_v[:, at] = v[:, 0].to(cache_v.dtype)
    if kv_valid is None:
        kv_pos = torch.arange(S_max, device=x.device)
        if window is not None:
            # in a ring buffer every slot is within the window once full
            seen = kv_pos < min(int(position) + 1, S_max)
        else:
            seen = kv_pos <= int(position)
        kv_valid = seen[None, :].expand(B, S_max)
    out = DA.decode_attention(q, cache_k, cache_v, kv_valid)
    return params["wo"](out).to(ACT_DTYPE)


# ---------------------------------------------------------------------------
# MLP / embedding
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, policy: Policy | None,
             tile: int | None = None, gated: bool = True,
             fset: FormatSet = DEFAULT_FORMATS, device="cuda") -> dict:
    kw = dict(tile=tile, fset=fset, device=device)
    p = {"up": init_mp_linear(gen, d_model, d_ff, policy, split="ksplit",
                              **kw),
         "down": init_mp_linear(gen, d_ff, d_model, policy, split="nsplit",
                                **kw)}
    if gated:
        p["gate"] = init_mp_linear(gen, d_model, d_ff, policy,
                                   split="ksplit", **kw)
    return p


def mlp_block(params, x) -> torch.Tensor:
    h = params["up"](x)
    if "gate" in params:
        h = F.silu(params["gate"](x)) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return params["down"](h.to(ACT_DTYPE)).to(ACT_DTYPE)


def init_embedding(gen, vocab: int, d_model: int, device) -> torch.Tensor:
    return (torch.randn((vocab, d_model), generator=gen, device=device,
                        dtype=torch.float32) * 0.02).to(ACT_DTYPE)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens].to(ACT_DTYPE)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean CE over all positions plus ``z_loss``·mean(lse²), in fp32;
    logits [..., V]."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = (lse - ll).mean()
    if z_loss:
        loss = loss + z_loss * (lse ** 2).mean()
    return loss
