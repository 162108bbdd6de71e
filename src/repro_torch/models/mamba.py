"""Mamba (selective SSM) pieces (twin of ``repro.models.mamba``).

Only the depthwise causal convolution is ported so far: the mLSTM block
runs it too.  The selective scan, ``mamba_block`` and its state wait in
``ROADMAP.md`` queue 1, item 7 (the Mamba-hybrid slice).
"""
from __future__ import annotations

import torch


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
