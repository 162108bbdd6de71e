"""Phi-3.5-MoE (42B total / 6.6B active)
[hf:microsoft/Phi-3.5-MoE-instruct] — 16 experts, top-2.

``fsdp=True`` as in the reference (read by ``launch.sharding``); its
``remat_group=4`` has no counterpart.  At full width (~42B parameters) it does not fit one card; the
port runs it reduced."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    top_k=2,
    rope_theta=10000.0,
    kv_dup_to_tp=True,
    fsdp=True,
))
