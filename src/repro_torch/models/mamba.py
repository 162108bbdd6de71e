"""Mamba (selective SSM) block: the chunked selective scan, the block and
its decode state (twin of ``repro.models.mamba``).

The scan runs as the reference runs it: time is cut into chunks, each
chunk's decay and input tensors [B, chunk, d_in, d_state] are built for
that chunk alone, an associative scan runs inside the chunk and a Python
loop carries the state h [B, d_in, d_state] across chunks.  The
associative scan is ``lax.associative_scan``'s odd/even recursion with
the reference's ``combine``: the same tree of products and sums, in
log2(chunk) levels of whole-tensor ops, so a chunk rounds as the
reference's does.  Decode is the same function at ``chunk=1`` (as in the
reference); there the state is updated in place.  Training runs the bulk
scan under autograd as written: the interleaving slice writes record
their backward, and every recursion level l keeps its [B, chunk/2^l,
d_in, d_state] operands for it, for each chunk of the sequence.

Projections are :class:`~repro_torch.core.linear.MPLinear`: ``in_proj``
K-split (the ksplit kernel on the card), ``out_proj`` N-split (a library
matmul).  ``x_proj`` is a bf16 product (fp32 sums, one rounding to
bf16); ``dt_proj`` and the scan's contraction over d_state are fp32
matmuls with TF32 off (``layout.fp32_matmul``).  The state is fp32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.layout import fp32_matmul
from repro_torch.core.linear import init_mp_linear
from repro_torch.core.precision import Policy
from repro_torch.models.common import ACT_DTYPE


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x · sigmoid(x)."""
    return x * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)`` = max(x, 0) +
    log1p(exp(−|x|)); ``torch.nn.functional.softplus`` would switch to
    the identity above its threshold."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-x.abs()))


def init_mamba(gen: torch.Generator, d_model: int, policy: Policy | None, *,
               expand: int = 2, d_state: int = 16, d_conv: int = 4,
               tile: int | None = None) -> dict:
    """Random weights on ``gen``'s device; the linears on the default
    format set, as in the reference."""
    d_in = expand * d_model
    dt_rank = max(1, int(np.ceil(d_model / 16)))
    dev = gen.device
    kw = dict(tile=tile, device=dev)

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * scale

    a = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=dev).repeat(d_in, 1)
    return {
        "in_proj": init_mp_linear(gen, d_model, 2 * d_in, policy,
                                  split="ksplit", **kw),
        "conv_w": normal((d_conv, d_in), 1.0 / np.sqrt(d_conv)),
        "conv_b": torch.zeros((d_in,), dtype=torch.float32, device=dev),
        "x_proj": normal((d_in, dt_rank + 2 * d_state),
                         1.0 / np.sqrt(d_in)).to(torch.bfloat16),
        "dt_proj": normal((dt_rank, d_in), 1.0 / np.sqrt(dt_rank)),
        "dt_bias": torch.full((d_in,), -4.6, dtype=torch.float32,
                              device=dev),              # softplus ≈ 0.01
        "A_log": torch.log(a),
        "D": torch.ones((d_in,), dtype=torch.float32, device=dev),
        "out_proj": init_mp_linear(gen, d_in, d_model, policy,
                                   split="nsplit", **kw),
    }


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: torch.Tensor | None = None):
    """Depthwise causal conv.  x: [B, S, d]; w: [K, d].  Returns (y, new
    state [B, K-1, d]) for decode continuation.  The taps add in the
    reference's order (``sum`` from 0, tap 0 first), so a bulk call and
    the same positions stepped through the state give the same bits."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(K))
    new_state = xp[:, -(K - 1):, :]
    return y + b[None, None, :], new_state


def _combine(left, right):
    """The reference's ``combine``: (a_l·a_r, b_l·a_r + b_r)."""
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """``lax.associative_scan(combine, (a, b), axis=1)``: combine adjacent
    pairs, scan the pairs by recursion (the odd positions), then combine
    each odd result with the next element (the even positions) and
    interleave."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = _associative_scan(*_combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                                      (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    out = []
    for x, e, o in zip((a, b), even, odd):
        e = torch.cat([x[:, :1], e], dim=1)
        y = torch.empty_like(x)
        y[:, 0::2] = e
        y[:, 1::2] = o
        out.append(y)
    return out[0], out[1]


def _ssm_chunked(u, dt, B_t, C_t, A, D, h0, chunk: int):
    """Selective scan.  u/dt: [B, S, d]; B_t/C_t: [B, S, n]; A: [d, n];
    h0: [B, d, n].  Returns (y [B, S, d], h_final).  ``chunk`` becomes
    ``min(chunk, S)`` and must then divide S, as in the reference.  At
    ``chunk == 1`` (decode) ``h0`` is updated in place and returned."""
    S = u.shape[1]
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(
            f"Mamba scan: S = {S} is not a multiple of the chunk {chunk} "
            "(the rule: chunk = min(chunk, S), then S % chunk == 0)")
    h = h0
    ys = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        ub, dtb, bb, cc = u[:, sl], dt[:, sl], B_t[:, sl], C_t[:, sl]
        # the [B, chunk, d, n] decay/input tensors, built per chunk
        ac = torch.exp(dtb[..., None] * A[None, None])
        bc = (dtb * ub)[..., None] * bb[:, :, None, :]
        a_cum, h_in = _associative_scan(ac, bc)
        if chunk == 1:
            h = h.mul_(a_cum[:, 0]).add_(h_in[:, 0])
            h_all = h[:, None]
        else:
            h_all = h_in + a_cum * h[:, None]
            h = h_all[:, -1]
        # einsum("btdn,btn->btd"): a batched product over n
        ys.append(fp32_matmul(h_all, cc[..., None])[..., 0])
    return torch.cat(ys, dim=1) + u * D[None, None], h


def mamba_block(params, x, *, chunk: int = 128, state=None):
    """x: [B, S, d] → [B, S, d] bf16.  With ``state`` (a dict from
    :func:`init_mamba_state`, the decode path) the step runs the scan at
    ``chunk=1`` and returns (out, new state): h is the given one, updated
    in place; conv is a new tensor."""
    B = x.shape[0]
    d_in, n = params["A_log"].shape
    dt_rank = params["dt_proj"].shape[0]

    xz = params["in_proj"](x)                              # [B, S, 2·d_in]
    xs, z = xz[..., :d_in], xz[..., d_in:]
    conv_state = None if state is None else state["conv"]
    xs, new_conv = _conv1d_causal(xs.float(), params["conv_w"],
                                  params["conv_b"], conv_state)
    xs = _silu(xs)

    # xs.astype(bf16) @ x_proj: bf16 operands, fp32 sums, one rounding
    proj = fp32_matmul(xs.to(ACT_DTYPE).float(),
                       params["x_proj"].float()).to(ACT_DTYPE).float()
    dt = _softplus(fp32_matmul(proj[..., :dt_rank], params["dt_proj"])
                   + params["dt_bias"])
    B_t = proj[..., dt_rank:dt_rank + n]
    C_t = proj[..., dt_rank + n:]
    A = -torch.exp(params["A_log"])

    h0 = (torch.zeros((B, d_in, n), dtype=torch.float32, device=x.device)
          if state is None else state["h"])
    y, h_fin = _ssm_chunked(xs, dt, B_t, C_t, A, params["D"], h0,
                            chunk=chunk if state is None else 1)
    out = params["out_proj"]((y * _silu(z.float())).to(ACT_DTYPE)
                             ).to(ACT_DTYPE)
    if state is None:
        return out
    return out, {"h": h_fin, "conv": new_conv}


def init_mamba_state(B: int, d_model: int, *, expand: int = 2,
                     d_state: int = 16, d_conv: int = 4,
                     device="cuda") -> dict:
    """Zeroed fp32 decode state: h [B, d_in, d_state], conv [B, d_conv −
    1, d_in]."""
    d_in = expand * d_model
    return {"h": torch.zeros((B, d_in, d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((B, d_conv - 1, d_in), dtype=torch.float32,
                                device=device)}
