"""Everything a run makes from ``--seed``: one seeded stream per tensor
or per draw, so the reference can remake any one tensor alone.

Imports torch and numpy only: both the program's side and the plain
reference read their tensors from here.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def stream(seed: int, name: str) -> int:
    """A 63-bit generator seed for the stream ``name`` of run ``seed``
    (any whole number, of any size)."""
    digest = hashlib.sha256(f"{int(seed)}/{name}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, name))


def rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(stream(seed, name))


def normal(seed: int, name: str, shape, scale: float, device
           ) -> torch.Tensor:
    """``scale * N(0, 1)`` of ``shape`` in fp32 on ``device``: the dense
    tensor ``name`` of run ``seed``."""
    g = generator(seed, name, device)
    return torch.randn(tuple(shape), generator=g, device=device,
                       dtype=torch.float32) * scale


def zipf_probs(vocab: int, a: float) -> np.ndarray:
    """p(rank k) ∝ k^-a over token ids 0 .. vocab-1 (id 0 commonest)."""
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -float(a)
    return p / p.sum()


def zipf_tokens(gen: np.random.Generator, probs: np.ndarray, n: int
                ) -> np.ndarray:
    return gen.choice(len(probs), size=int(n), p=probs).astype(np.int64)
