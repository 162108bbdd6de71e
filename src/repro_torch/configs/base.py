"""Architecture configuration schema + registry (the dense part of
``repro.configs.base``).

The port runs on one card, so there is no tensor parallelism: ``tp`` is
1 by default and attention keeps the published kv-head count (the JAX
package pads/duplicates heads for a 16-way model axis).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.core.precision import Policy

REGISTRY: dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # only "dense" is ported so far
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 500000.0
    use_rope: bool = True
    # --- mixed-precision policy (the paper's technique) ------------------
    mp_policy: Policy = Policy(kind="ratio", ratio_high=0.5)
    mp_tile: int = 128
    mp_formats: str = "fp8_e4m3+bf16+fp32"
    #: padded-prompt-length buckets of the serve scheduler (None → the
    #: serve defaults)
    serve_buckets: Optional[tuple] = None
    #: P×Q grid of the SUMMA self-check the train launcher and the serve
    #: engine run at setup (``--summa PxQ`` overrides from the CLI)
    summa_grid: Optional[tuple] = None
    norm_eps: float = 1e-6
    tp: int = 1
    gated_mlp: bool = True
    kv_dup_to_tp: bool = False


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


_ARCH_MODULES = ["internlm2_1_8b"]


def load_all() -> dict[str, ArchConfig]:
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    return REGISTRY


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        load_all()
    return REGISTRY[name]


def reduced(cfg: ArchConfig, tp: int = 2) -> ArchConfig:
    """Tiny same-family variant for CPU tests — the same shrink as the
    reference's ``reduced`` for a dense config."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(4, cfg.n_kv_heads)),
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=128,
        head_dim=16,
        mp_tile=16,
        tp=tp,
        serve_buckets=(4, 8, 16, 32),
    )
    return dataclasses.replace(cfg, **kw)
