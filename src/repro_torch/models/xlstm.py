"""xLSTM blocks, sLSTM and mLSTM (twin of ``repro.models.xlstm``).

mLSTM: the matrix-memory cell with exponential gating, run as the
reference runs it: chunked, log-space stabilised, quadratic inside a
chunk and recurrent across chunks through the state C [B, nh, dh, dh].
Decode is the same function at ``chunk=1`` (as in the reference), so a
cached step and a bulk chunk differ only in summation order.  Training
runs the bulk scan under autograd; the carry C is then a new tensor each
chunk (the decode step alone updates it in place).

sLSTM: the scalar-memory cell with a block-diagonal recurrence, a
sequential loop over time (out of place, so autograd trains through it),
then a gelu FFN.

Projections are :class:`~repro_torch.core.linear.MPLinear`: ``up_proj``
and ``ff_up`` K-split (the ksplit kernel on the card), ``down_proj`` and
``ff_down`` N-split (a library matmul).  Every other product is an fp32
matmul with TF32 off (``layout.fp32_matmul``); the reference's einsums
are written as explicit matmuls, in its contraction order.  Activations
travel in bf16 (``ACT_DTYPE``); the recurrent state is fp32.

Layouts here are head-major ([B, nh, S, ...]) where the reference's are
[B, S, nh, ...]; only the order of elementwise work changes, not a
rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.layout import fp32_matmul
from repro_torch.core.linear import init_mp_linear
from repro_torch.core.precision import Policy
from repro_torch.models.common import ACT_DTYPE
from repro_torch.models.mamba import _conv1d_causal, _silu


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: −softplus(−x), softplus as ``logaddexp(x,
    0)`` = max(x, 0) + log1p(exp(−|x|))."""
    y = -x
    return -(torch.clamp(y, min=0.0) + torch.log1p(torch.exp(-y.abs())))


def _gelu_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form) on a bf16 array, op by op in bf16 as
    the reference computes it: each constant is a bf16 value and each
    step rounds to bf16."""
    def c(v):
        return torch.tensor(v, dtype=torch.bfloat16, device=x.device)
    cube = x * x * x
    inner = c(float(np.sqrt(2 / np.pi))) * (x + c(0.044715) * cube)
    cdf = c(0.5) * (c(1.0) + torch.tanh(inner))
    return x * cdf


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, d_model: int, n_heads: int,
               policy: Policy | None, *, expand: int = 2, d_conv: int = 4,
               tile: int | None = None) -> dict:
    """Random weights on ``gen``'s device; the linears on the default
    format set, as in the reference."""
    d_in = expand * d_model
    dh = d_in // n_heads
    dev = gen.device
    kw = dict(tile=tile, device=dev)

    def heads():
        # headwise block-diagonal projections (xLSTM official): [nh, dh, dh]
        return _normal(gen, (n_heads, dh, dh), 1.0 / np.sqrt(dh)).to(
            torch.bfloat16)

    return {
        "up_proj": init_mp_linear(gen, d_model, 2 * d_in, policy,
                                  split="ksplit", **kw),
        "conv_w": _normal(gen, (d_conv, d_in), 1.0 / np.sqrt(d_conv)),
        "conv_b": torch.zeros((d_in,), dtype=torch.float32, device=dev),
        "wq": heads(),
        "wk": heads(),
        "wv": heads(),
        "w_if": _normal(gen, (d_in, 2 * n_heads), 0.01),
        "b_if": torch.cat([torch.zeros(n_heads), torch.full((n_heads,), 3.0)]
                          ).to(dev),
        "skip": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "down_proj": init_mp_linear(gen, d_in, d_model, policy,
                                    split="nsplit", **kw),
    }


def _mlstm_chunk(q, k, v, li, lf, state, *, chunk: int):
    """Chunked stabilised mLSTM scan.

    q/k/v: [B, S, nh, dh]; li/lf: [B, S, nh] (log input/forget gates);
    state: (C [B, nh, dh, dh], n [B, nh, dh], m [B, nh]).  Returns
    (h [B, S, nh, dh], state').  ``chunk`` becomes ``min(chunk, S)`` and
    must then divide S, as in the reference.  Where no graph is recorded
    the carry's C is updated in place (a decode step writes its cache's C
    without a copy); under autograd it is a new tensor each chunk, since
    the chunk's ``h_inter`` product saved the old one.  n and m are new
    tensors.
    """
    B, S, nh, dh = q.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(
            f"mLSTM scan: S = {S} is not a multiple of the chunk {chunk} "
            "(the rule: chunk = min(chunk, S), then S % chunk == 0)")
    scale = 1.0 / np.sqrt(dh)
    # head-major: [B, nh, S, ...]
    qh, kh, vh = (t.transpose(1, 2).float() for t in (q, k, v))
    lih, lfh = li.transpose(1, 2), lf.transpose(1, 2)
    tril = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=q.device).tril()
    C, n, m = state
    hs = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        qb, kb, vb = qh[:, :, sl], kh[:, :, sl], vh[:, :, sl]
        lib, lfb = lih[:, :, sl], lfh[:, :, sl]
        lf_cum = torch.cumsum(lfb, dim=-1)            # Σ_{s≤t} log f_s
        lf_tot = lf_cum[..., -1]
        # [B, nh, t, s]: log decay from s to t plus the input gate at s
        logd = lf_cum[..., :, None] - lf_cum[..., None, :] + lib[..., None, :]
        intra_max = torch.where(tril, logd, -torch.inf).amax(dim=-1)
        m_in_c = m[..., None] + lf_cum                # inter-chunk part
        m_t = torch.maximum(m_in_c, intra_max)
        D = torch.where(tril, torch.exp(logd - m_t[..., None]), 0.0)
        s = fp32_matmul(qb, kb.transpose(-1, -2)) * scale
        h_intra = fp32_matmul(s * D, vb)
        n_intra = fp32_matmul(D, kb)
        w_in = torch.exp(m_in_c - m_t)                # [B, nh, t]
        h_inter = fp32_matmul(qb * scale, C) * w_in[..., None]
        n_inter = n[..., None, :] * w_in[..., None]
        h_num = h_intra + h_inter
        n_t = n_intra + n_inter
        qn = fp32_matmul((qb * scale)[..., None, :], n_t[..., :, None])
        denom = torch.maximum(qn[..., 0, 0].abs(), torch.exp(-m_t))
        hs.append(h_num / denom[..., None])
        # carry update
        m_next = torch.maximum(
            m + lf_tot,
            (lib + lf_tot[..., None] - lf_cum).amax(dim=-1))
        w_keep = torch.exp(m + lf_tot - m_next)       # [B, nh]
        w_new = torch.exp(lib + lf_tot[..., None] - lf_cum
                          - m_next[..., None])        # [B, nh, s]
        # Σ_s k_s ⊗ (v_s · w_s): the reference's einsum scales v first
        upd = fp32_matmul(kb.transpose(-1, -2), vb * w_new[..., None])
        if upd.requires_grad or C.requires_grad:
            # autograd saved C for h_inter's backward: a new tensor
            C = C * w_keep[..., None, None] + upd
        else:
            C = C.mul_(w_keep[..., None, None]).add_(upd)
        n = n * w_keep[..., None] + fp32_matmul(w_new[..., None, :],
                                                kb)[..., 0, :]
        m = m_next
    return torch.cat(hs, dim=2).transpose(1, 2), (C, n, m)


def _head_proj(x: torch.Tensor, w: torch.Tensor, n_heads: int
               ) -> torch.Tensor:
    """einsum("bsnd,nde->bsne") of fp32 ``x`` [B, S, nh·dh] with the
    bf16 head weights [nh, dh, dh], in fp32; rounded to bf16."""
    B, S, _ = x.shape
    xh = x.reshape(B * S, n_heads, -1).transpose(0, 1)   # [nh, B·S, dh]
    y = fp32_matmul(xh, w.float())
    return y.transpose(0, 1).reshape(B, S, n_heads, -1).to(ACT_DTYPE)


def mlstm_block(params, x, *, n_heads: int, chunk: int = 256, state=None):
    """x: [B, S, d] → [B, S, d] bf16.  With ``state`` (a dict from
    :func:`init_mlstm_state`, the decode path) the step runs the scan at
    ``chunk=1`` and returns (out, new state): C is the given one, updated
    in place; n, m and conv are new tensors."""
    B, S, d = x.shape
    d_in = params["conv_w"].shape[1]
    xz = params["up_proj"](x)
    xs, z = xz[..., :d_in], xz[..., d_in:]
    conv_state = None if state is None else state["conv"]
    xc, new_conv = _conv1d_causal(xs.float(), params["conv_w"],
                                  params["conv_b"], conv_state)
    xc = _silu(xc).to(ACT_DTYPE)

    xcf = xc.float()
    q = _head_proj(xcf, params["wq"], n_heads)
    k = _head_proj(xcf, params["wk"], n_heads)
    v = _head_proj(xs.float(), params["wv"], n_heads)
    gates = fp32_matmul(xcf, params["w_if"]) + params["b_if"]
    li = gates[..., :n_heads]                       # log input gate
    lf = _log_sigmoid(gates[..., n_heads:])         # log forget gate

    if state is None:
        s0 = init_mlstm_state(B, d, n_heads, expand=d_in // d,
                              device=x.device)
        h, _ = _mlstm_chunk(q, k, v, li, lf, (s0["C"], s0["n"], s0["m"]),
                            chunk=chunk)
    else:
        st = (state["C"], state["n"], state["m"])
        h, st = _mlstm_chunk(q, k, v, li, lf, st, chunk=1)
    h = h.reshape(B, S, d_in)
    h = h + params["skip"][None, None] * xcf
    out = params["down_proj"]((h * _silu(z.float())).to(ACT_DTYPE))
    if state is None:
        return out.to(ACT_DTYPE)
    return out.to(ACT_DTYPE), {"C": st[0], "n": st[1], "m": st[2],
                               "conv": new_conv}


def init_mlstm_state(B: int, d_model: int, n_heads: int, *,
                     expand: int = 2, d_conv: int = 4,
                     device="cuda") -> dict:
    """Zeroed fp32 decode state: C [B, nh, dh, dh], n [B, nh, dh],
    m [B, nh], conv [B, d_conv - 1, d_in]."""
    d_in = expand * d_model
    dh = d_in // n_heads

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"C": z(B, n_heads, dh, dh), "n": z(B, n_heads, dh),
            "m": z(B, n_heads), "conv": z(B, d_conv - 1, d_in)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, d_model: int, n_heads: int,
               policy: Policy | None, *, ff_factor: float = 4.0 / 3.0,
               tile: int | None = None) -> dict:
    """Random weights on ``gen``'s device; the linears on the default
    format set, as in the reference."""
    dh = d_model // n_heads
    dev = gen.device
    kw = dict(tile=tile, device=dev)
    d_ff = int(ff_factor * d_model)
    d_ff = max(64, (d_ff // 64) * 64)
    return {
        "w_in": _normal(gen, (d_model, 4 * d_model),
                        1.0 / np.sqrt(d_model)).to(torch.bfloat16),
        "b_in": torch.cat([torch.zeros(2 * d_model),
                           torch.full((d_model,), 3.0),
                           torch.zeros(d_model)]).to(dev),
        "r": _normal(gen, (n_heads, 4, dh, dh), 0.5 / np.sqrt(dh)),
        "ff_up": init_mp_linear(gen, d_model, d_ff, policy, split="ksplit",
                                **kw),
        "ff_down": init_mp_linear(gen, d_ff, d_model, policy,
                                  split="nsplit", **kw),
    }


def slstm_block(params, x, *, n_heads: int, state=None):
    """Sequential sLSTM + gelu FFN.  x: [B, S, d] → [B, S, d] bf16; with
    ``state`` (from :func:`init_slstm_state`) returns (out, new state)."""
    B, S, d = x.shape
    dh = d // n_heads
    # x @ w_in: bf16 operands, fp32 sums, one rounding to bf16 (the
    # reference's bf16 dot)
    pre = fp32_matmul(x.float(), params["w_in"].float()).to(ACT_DTYPE)
    pre = (pre.float() + params["b_in"]).reshape(B, S, 4, n_heads, dh)
    if state is None:
        c0 = torch.zeros((B, n_heads, dh), dtype=torch.float32,
                         device=x.device)
        c, n, m, h = c0, c0, c0 - 10.0, c0
    else:
        c, n, m, h = state["c"], state["n"], state["m"], state["h"]
    r = params["r"]                                 # [nh, 4, dh, dh]
    hs = []
    for t in range(S):
        # einsum("bhd,hgde->bghe"): per head h_b · r[h, g]
        rec = fp32_matmul(h.transpose(0, 1)[:, None], r)   # [nh, 4, B, dh]
        zifo = pre[:, t] + rec.permute(2, 1, 0, 3)
        z_t = torch.tanh(zifo[:, 0])
        i_log = zifo[:, 1]
        f_log = _log_sigmoid(zifo[:, 2])
        o_t = torch.sigmoid(zifo[:, 3])
        m_new = torch.maximum(f_log + m, i_log)
        i_p = torch.exp(i_log - m_new)
        f_p = torch.exp(f_log + m - m_new)
        c = f_p * c + i_p * z_t
        n = f_p * n + i_p
        h = o_t * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(h)
    hseq = torch.stack(hs, dim=1).reshape(B, S, d).to(ACT_DTYPE)
    ff = params["ff_down"](_gelu_bf16(
        params["ff_up"](hseq).to(ACT_DTYPE))).to(ACT_DTYPE)
    out = hseq + ff
    if state is None:
        return out
    return out, {"c": c, "n": n, "m": m, "h": h}


def init_slstm_state(B: int, d_model: int, n_heads: int,
                     device="cuda") -> dict:
    """Zeroed fp32 decode state c, n, h [B, nh, dh] and m = −10."""
    dh = d_model // n_heads

    def z():
        return torch.zeros((B, n_heads, dh), dtype=torch.float32,
                           device=device)

    return {"c": z(), "n": z(), "m": z() - 10.0, "h": z()}
