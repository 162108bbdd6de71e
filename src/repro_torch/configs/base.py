"""Architecture configuration schema + registry (twin of
``repro.configs.base``): every config the reference registers — dense
and MoE decoders with full or local/global attention, the xLSTM
recurrent stack, the Mamba-attention hybrid, the encoder-only audio
model and the vision-language decoder.

The port runs on one card, so there is no tensor parallelism.  ``tp``
is the model-axis size whose head padding the attention geometry keeps
(``models.transformer.dims_of``): 1 by default, so attention keeps the
published head counts (the JAX package pads q heads and duplicates kv
heads for its 16-way axis), and :data:`REFERENCE_TP` for LLaVA-NeXT-34B
and Llama-3-405B, whose padded q heads and duplicated kv heads are real
weights in the reference (56 → 64 q heads with 16 kv, and 128 q heads
with 8 → 16 kv).  One decision of the reference's model axis changes
numbers, not only placement: an MoE config whose expert count divides
the axis stores its down projection K-split, otherwise N-split
(``repro.models.moe.init_moe``).  ``ep_axis`` keeps that decision at
:data:`REFERENCE_TP`; :func:`reduced` sets both to the reduced ``tp``,
as the reference's reduced configs decide at their own ``tp``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

from repro_torch.core.precision import Policy

REGISTRY: dict[str, "ArchConfig"] = {}

#: model-parallel axis size of the reference's production mesh (16x16
#: pod), at which it decides expert parallelism (``moe_ep``)
REFERENCE_TP = 16


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # --- attention pattern ---------------------------------------------
    attn_pattern: str = "full"   # full | local_global
    local_window: int = 1024
    global_every: int = 6        # 5 local : 1 global
    rope_theta: float = 500000.0
    use_rope: bool = True
    encoder_only: bool = False
    # --- modality frontend (a projection of precomputed embeddings) -----
    frontend: str = "none"       # none | audio | vision
    frontend_dim: int = 0        # width of the embeddings the stub delivers
    n_patches: int = 0           # vision tokens in the prompt
    # --- MoE --------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    shared_d_ff: int = 0
    moe_every: int = 1       # apply MoE at layers i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    #: model-axis size at which ``moe_ep`` is decided (see module doc)
    ep_axis: int = REFERENCE_TP
    #: shard large params over "data" too (ZeRO-3 / FSDP): read by
    #: ``launch.sharding``'s rules only
    fsdp: bool = False
    # --- hybrid / ssm ------------------------------------------------------
    block_type: str = "attn"     # attn | mamba_hybrid | xlstm
    attn_every: int = 0          # hybrid: layer i % attn_every == attn_offset
    attn_offset: int = 0
    slstm_every: int = 8         # xlstm: i % slstm_every == 0 → sLSTM
    mamba_d_state: int = 16
    mamba_expand: int = 2
    # --- mixed-precision policy (the paper's technique) ------------------
    mp_policy: Policy = Policy(kind="ratio", ratio_high=0.5)
    mp_tile: int = 128
    #: governs the dense stack (attention / MLP / lm_head); the MoE
    #: experts and the shared expert stay on the default set, as in the
    #: reference
    mp_formats: str = "fp8_e4m3+bf16+fp32"
    #: padded-prompt-length buckets of the serve scheduler (None → the
    #: serve defaults)
    serve_buckets: Optional[tuple] = None
    #: P×Q grid of the SUMMA self-check the train launcher and the serve
    #: engine run at setup (``--summa PxQ`` overrides from the CLI)
    summa_grid: Optional[tuple] = None
    norm_eps: float = 1e-6
    #: model-axis size of the attention head padding (see module doc)
    tp: int = 1
    gated_mlp: bool = True
    kv_dup_to_tp: bool = False
    notes: str = ""

    # ---------------------------------------------------------------------
    def layer_kinds(self) -> list[tuple[str, str]]:
        """[(mixer, ffn)] per layer: mixer ∈ {attn_full, attn_local,
        mamba, mlstm, slstm}, ffn ∈ {mlp, moe, none}."""
        kinds = []
        for i in range(self.n_layers):
            if self.block_type == "xlstm":
                mixer = "slstm" if (self.slstm_every
                                    and i % self.slstm_every == 0) else "mlstm"
                ffn = "none"   # cells carry their own FFN/projections
            elif self.block_type == "mamba_hybrid":
                mixer = ("attn_full" if self.attn_every
                         and i % self.attn_every == self.attn_offset
                         else "mamba")
                ffn = ("moe" if self.n_experts
                       and i % self.moe_every == self.moe_offset else "mlp")
            else:
                if self.attn_pattern == "local_global":
                    mixer = ("attn_full"
                             if i % self.global_every == self.global_every - 1
                             else "attn_local")
                else:
                    mixer = "attn_full"
                ffn = "moe" if self.n_experts else "mlp"
            kinds.append((mixer, ffn))
        return kinds

    def pattern_period(self) -> int:
        kinds = self.layer_kinds()
        for p in range(1, len(kinds) + 1):
            if all(kinds[i] == kinds[i % p] for i in range(len(kinds))):
                return p
        return len(kinds)

    def segments(self) -> list[tuple[list[tuple[str, str]], int]]:
        """[(pattern, repeats)]: the reference's scan schedule, whole
        pattern periods then a tail.  The port runs its layers as a list;
        this is where each layer sits in the reference's parameter tree
        (``repro_torch.tree``)."""
        kinds = self.layer_kinds()
        p = self.pattern_period()
        main = len(kinds) // p
        segs = []
        if main:
            segs.append((kinds[:p], main))
        tail = kinds[main * p:]
        if tail:
            segs.append((tail, 1))
        return segs

    @property
    def moe_ep(self) -> bool:
        """Expert parallel in the reference (E divides its model axis):
        the down projection is K-split; otherwise N-split."""
        return self.n_experts > 0 and self.n_experts % self.ep_axis == 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), as the
        reference counts it."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        dh = self.head_dim or d // self.n_heads
        total = v * d * 2  # embed + head
        for mixer, ffn in self.layer_kinds():
            if mixer.startswith("attn"):
                total += d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
            elif mixer == "mamba":
                din = self.mamba_expand * d
                total += d * 2 * din + din * d + din * (
                    d // 16 + 2 * self.mamba_d_state)
            elif mixer == "mlstm":
                din = 2 * d
                total += (d * 2 * din + 3 * din * din // self.n_heads
                          + din * d)
            elif mixer == "slstm":
                total += 4 * d * d + int(4 / 3 * d) * d * 2
            if ffn == "mlp":
                total += 3 * d * f
            elif ffn == "moe":
                total += self.n_experts * 3 * d * f
                if self.n_shared:
                    total += 3 * d * self.shared_d_ff
        return total


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


_ARCH_MODULES = ["jamba_v01_52b", "hubert_xlarge", "llama3_8b",
                 "internlm2_1_8b", "gemma3_4b", "llama3_405b",
                 "qwen2_moe_a2_7b", "phi35_moe", "llava_next_34b",
                 "xlstm_1_3b"]


def load_all() -> dict[str, ArchConfig]:
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    return REGISTRY


def get(name: str) -> ArchConfig:
    if name not in REGISTRY:
        load_all()
    return REGISTRY[name]


#: the dry run's cell shapes (``launch.dryrun``), as the reference's
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

#: archs allowed to run long_500k (sub-quadratic path exists)
LONG_OK = {"jamba-v0.1-52b", "gemma3-4b", "xlstm-1.3b"}


def cells(arch: str) -> list[str]:
    """Dry-run cells for an arch, applying the documented skips."""
    cfg = get(arch)
    out = ["train_4k", "prefill_32k"]
    if not cfg.encoder_only:
        out.append("decode_32k")
        if arch in LONG_OK:
            out.append("long_500k")
    return out


def reduced(cfg: ArchConfig, tp: int = 2) -> ArchConfig:
    """Tiny same-family variant for CPU tests — the reference's shrink:
    keeps the block pattern, shrinks every dimension."""
    period = cfg.pattern_period()
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=max(2, min(2 * period, 8)),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(4, cfg.n_kv_heads)),
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab=128,
        head_dim=16,
        local_window=8,
        n_experts=min(4, cfg.n_experts) if cfg.n_experts else 0,
        top_k=min(2, cfg.top_k) if cfg.top_k else 0,
        n_shared=min(1, cfg.n_shared),
        shared_d_ff=64 if cfg.n_shared else 0,
        frontend_dim=32 if cfg.frontend != "none" else 0,
        n_patches=8 if cfg.frontend == "vision" else 0,
        mp_tile=16,
        tp=tp,
        ep_axis=tp,
        mamba_d_state=4,
        serve_buckets=(4, 8, 16, 32),
    )
    return dataclasses.replace(cfg, **kw)
