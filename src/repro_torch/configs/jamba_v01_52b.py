"""Jamba-v0.1-52B [arXiv:2403.19887; hf] — hybrid Mamba+attention 1:7
interleave, MoE every other layer (16 experts, top-2).

``fsdp=True`` as in the reference (read by ``launch.sharding``); its
``remat_group=2`` has no counterpart.  ``kv_dup_to_tp`` only duplicates kv heads for the reference's
16-way model axis; at the port's ``tp=1`` the 8 kv heads stay as
published.  At full depth (51.6e9 parameters) it does not fit one card;
the port serves it reduced on the CPU and one pattern period (8 of 32
layers, every published width) on the card (``chip_smoke.py`` phase 11).
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    block_type="mamba_hybrid",
    attn_every=8,       # 1 attention : 7 mamba
    attn_offset=4,
    n_experts=16,
    top_k=2,
    moe_every=2,        # MoE on odd layers
    moe_offset=1,
    rope_theta=10000.0,
    use_rope=False,     # Jamba uses no positional encoding in attn layers
    notes="Mamba d_state=16, expand=2; EP over model axis (16 experts).",
    kv_dup_to_tp=True,
    fsdp=True,
))
