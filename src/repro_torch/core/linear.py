"""MPLinear — the tile-centric mixed-precision GEMM as an LM layer (twin of
``repro.core.linear``).

* ``ksplit`` — class map varies along K, constant along N
  (column-parallel matmuls: wq/wk/wv, up/gate, lm_head); the matmul goes
  through ``tune.dispatch.linear_matmul`` (the ksplit kernel on the card).
* ``nsplit`` — class map varies along N (row-parallel matmuls: wo,
  down); a plain library matmul.
* ``dense``  — one low-format weight, the 0D:100S endpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.formats import DEFAULT_FORMATS, FormatSet
from repro_torch.core.layout import (KSplitWeight, NSplitWeight,
                                     fp32_matmul, nsplit_matmul)
from repro_torch.core.precision import Policy, role_class_vector

_TILE_PREFS = (128, 64, 32, 16, 8, 4, 2, 1)


def choose_tile(dim: int, prefer: int = 128) -> int:
    if dim % prefer == 0:
        return prefer
    for t in _TILE_PREFS:
        if dim % t == 0:
            return t
    return 1


def split_cls(nblocks: int, policy: Policy,
              block_norms: np.ndarray | None = None,
              fset: FormatSet = DEFAULT_FORMATS) -> np.ndarray:
    """Per-block class vector: ratio policies are class-sorted (HIGH
    first); norm_topk marks the largest-norm blocks HIGH in place."""
    if policy.kind == "uniform_high":
        return np.full(nblocks, fset.high, np.int8)
    if policy.kind == "uniform_low":
        return np.full(nblocks, fset.low, np.int8)
    if policy.kind == "uniform_low8":
        if fset.low8 is None:
            raise ValueError(f"format set {fset.names} has no low8 role")
        return np.full(nblocks, fset.low8, np.int8)
    n_hi = int(round(policy.ratio_high * nblocks))
    n_lo8 = int(round(policy.ratio_low8 * nblocks))
    if n_lo8 and fset.low8 is None:
        raise ValueError(f"format set {fset.names} has no low8 role")
    n_lo = nblocks - n_hi - n_lo8
    if n_lo < 0:
        raise ValueError(f"policy {policy} over-assigns {nblocks} blocks")
    if policy.kind == "ratio":
        return role_class_vector(n_hi, n_lo, n_lo8, fset)
    if policy.kind == "norm_topk":
        if block_norms is None:
            raise ValueError("norm_topk needs block norms")
        cls = np.full(nblocks, fset.low, np.int8)
        order = np.argsort(-block_norms)
        cls[order[:n_hi]] = fset.high
        if n_lo8:
            cls[order[-n_lo8:]] = fset.low8
        return cls
    raise ValueError(f"unsupported policy kind {policy.kind!r}")


@dataclasses.dataclass
class MPLinear:
    """y = x @ W (+ b), fp32 out.  ``w`` is a KSplitWeight, an
    NSplitWeight, or a plain low-format tensor; ``b`` optional fp32."""

    w: object
    b: Optional[torch.Tensor] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.w, KSplitWeight):
            # tune sits above core: import lazily
            from repro_torch.tune.dispatch import linear_matmul
            y = linear_matmul(x, self.w)
        elif isinstance(self.w, NSplitWeight):
            y = nsplit_matmul(x, self.w)
        else:
            y = fp32_matmul(x.to(self.w.dtype), self.w)
        if self.b is not None:
            y = y + self.b
        return y


def init_mp_linear(gen: torch.Generator, in_dim: int, out_dim: int,
                   policy: Policy | None, *, split: str = "ksplit",
                   tile: int | None = None, use_bias: bool = False,
                   scale: float | None = None,
                   fset: FormatSet = DEFAULT_FORMATS,
                   device: torch.device | str = "cuda") -> MPLinear:
    """Initialize an MPLinear from a seeded ``torch.Generator`` (which
    must live on ``device``).  ``split`` ∈ {ksplit, nsplit, dense}."""
    scale = scale if scale is not None else 1.0 / np.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=device,
                    dtype=torch.float32) * scale
    b = (torch.zeros((out_dim,), dtype=torch.float32, device=device)
         if use_bias else None)
    if policy is None or split == "dense" or policy.kind == "uniform_low":
        return MPLinear(w.to(fset.storage_dtype(fset.low)), b)
    if split == "ksplit":
        t = tile or choose_tile(in_dim)
        kt = in_dim // t
        norms = None
        if policy.kind == "norm_topk":
            norms = torch.linalg.vector_norm(
                w.reshape(kt, t, out_dim), dim=(1, 2)).cpu().numpy()
        cls = split_cls(kt, policy, norms, fset)
        return MPLinear(KSplitWeight.from_dense(w, cls, t, fset), b)
    if split == "nsplit":
        t = tile or choose_tile(out_dim)
        nt = out_dim // t
        if policy.kind == "norm_topk":
            norms = torch.linalg.vector_norm(
                w.reshape(in_dim, nt, t), dim=(0, 2)).cpu().numpy()
            cls = split_cls(nt, policy, norms, fset)
            order = np.argsort(-cls, kind="stable")
            colperm = (order[:, None] * t + np.arange(t)[None, :]).reshape(-1)
            w = w[:, torch.from_numpy(colperm).to(w.device)]
            cls = cls[order]
        else:
            cls = split_cls(nt, policy, fset=fset)
        return MPLinear(NSplitWeight.from_dense(w, cls, t, fset), b)
    raise ValueError(f"unknown split {split!r}")
