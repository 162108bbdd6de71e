"""Plain fp32 reference of a dense GQA decoder (InternLM2-1.8B's layer
equations), with TF32 off.

Per layer: RMS norm (scale ``1 + g``), causal grouped-query attention
with rotary embeddings (half-split rotation, base ``rope_theta``), a
residual add, RMS norm, the SiLU-gated MLP and a residual add; then the
final RMS norm and the output head.  The loss is the mean cross-entropy
plus 1e-4 times the mean squared log-sum-exp (the z-loss the port's
training states).

Every activation and sum is fp32.  Each weight is the dense tensor of
:mod:`portbench.inputs`, rounded as the configuration stores it
(:mod:`portbench.reference.rounding`): the stated precision of the
configuration is its weights' storage, and the program's bf16
activations are what the comparison measures.  Imports neither
``repro_torch`` nor ``repro`` nor ``jax``.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench import inputs
from portbench.reference import rounding as R

Z_LOSS = 1e-4


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    scale: float
    kind: str        # ksplit | nsplit | embed | norm


def dims(c: dict) -> dict:
    d, nq = c["hidden_size"], c["num_attention_heads"]
    return dict(d=d, nq=nq, nkv=c["num_key_value_heads"], dh=d // nq,
                f=c["intermediate_size"], V=c["vocab_size"],
                L=c["num_hidden_layers"])


def leaves(c: dict) -> list[Leaf]:
    """Every weight of the model: name, shape, init scale and storage."""
    g = dims(c)
    d, dh, f = g["d"], g["dh"], g["f"]
    out = [Leaf("embed", (g["V"], d), 0.02, "embed"),
           Leaf("final_norm", (d,), 0.1, "norm"),
           Leaf("lm_head", (d, g["V"]), d ** -0.5, "ksplit")]
    for i in range(g["L"]):
        p = f"layers.{i}."
        out += [Leaf(p + "norm1", (d,), 0.1, "norm"),
                Leaf(p + "attn.wq", (d, g["nq"] * dh), d ** -0.5, "ksplit"),
                Leaf(p + "attn.wk", (d, g["nkv"] * dh), d ** -0.5,
                     "ksplit"),
                Leaf(p + "attn.wv", (d, g["nkv"] * dh), d ** -0.5,
                     "ksplit"),
                Leaf(p + "attn.wo", (g["nq"] * dh, d),
                     (g["nq"] * dh) ** -0.5, "nsplit"),
                Leaf(p + "norm2", (d,), 0.1, "norm"),
                Leaf(p + "mlp.up", (d, f), d ** -0.5, "ksplit"),
                Leaf(p + "mlp.gate", (d, f), d ** -0.5, "ksplit"),
                Leaf(p + "mlp.down", (f, d), f ** -0.5, "nsplit")]
    return out


def dense(seed: int, leaf: Leaf, device) -> torch.Tensor:
    """The dense fp32 tensor of ``leaf`` in run ``seed``."""
    return inputs.normal(seed, leaf.name, leaf.shape, leaf.scale, device)


def stored(c: dict, leaf: Leaf, w: torch.Tensor, demote: bool = False
           ) -> torch.Tensor:
    """``w`` as the configuration stores it (fp32 values); ``demote``
    stores every class one precision lower (the control)."""
    if leaf.kind == "norm":
        return w.float()
    if leaf.kind == "embed":
        fmt = c["activations"]
        return R.round_to(w, R.ONE_STEP_DOWN[fmt] if demote else fmt)
    t = c["mp_tile"]
    dim = 0 if leaf.kind == "ksplit" else 1
    fmts = R.block_formats(leaf.shape[dim] // t, c["mp_formats"],
                           c["mp_policy"])
    return R.round_blocks(w, fmts, t, dim, demote)


def weights(c: dict, seed: int, device, demote: bool = False) -> dict:
    """name -> stored weight, for a forward pass without gradients."""
    return {lf.name: stored(c, lf, dense(seed, lf, device), demote)
            for lf in leaves(c)}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def rms_norm(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + g)


def rope(x, pos, theta):
    """x: [B, S, H, dh]; half-split rotation by position ``pos`` [S]."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = pos.float()[:, None] * freqs                  # [S, half]
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def layer(get, c: dict, i: int, x: torch.Tensor) -> torch.Tensor:
    g = dims(c)
    B, S, _ = x.shape
    nq, nkv, dh = g["nq"], g["nkv"], g["dh"]
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    p = f"layers.{i}."
    pos = torch.arange(S, device=x.device)
    h = rms_norm(x, get(p + "norm1"), eps)
    q = rope((h @ get(p + "attn.wq")).view(B, S, nq, dh), pos, theta)
    k = rope((h @ get(p + "attn.wk")).view(B, S, nkv, dh), pos, theta)
    v = (h @ get(p + "attn.wv")).view(B, S, nkv, dh)
    k = k.repeat_interleave(nq // nkv, dim=2)
    v = v.repeat_interleave(nq // nkv, dim=2)
    s = (q.transpose(1, 2) / math.sqrt(dh)) @ k.permute(0, 2, 3, 1)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    a = (torch.softmax(s, dim=-1) @ v.transpose(1, 2)).transpose(1, 2)
    x = x + a.reshape(B, S, nq * dh) @ get(p + "attn.wo")
    h = rms_norm(x, get(p + "norm2"), eps)
    mlp = F.silu(h @ get(p + "mlp.gate")) * (h @ get(p + "mlp.up"))
    return x + mlp @ get(p + "mlp.down")


def logits(get, c: dict, tokens: torch.Tensor, remat: bool = False
           ) -> torch.Tensor:
    """fp32 logits [B, S, V] of ``tokens`` [B, S] (every row from
    position 0); ``remat`` recomputes each layer in the backward."""
    x = get("embed")[tokens]
    for i in range(c["num_hidden_layers"]):
        if remat:
            x = checkpoint(layer, get, c, i, x, use_reentrant=False)
        else:
            x = layer(get, c, i, x)
    x = rms_norm(x, get("final_norm"), c["rms_norm_eps"])
    return x @ get("lm_head")


def loss(lg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels[..., None])[..., 0]
    return (lse - ll).mean() + Z_LOSS * (lse ** 2).mean()
