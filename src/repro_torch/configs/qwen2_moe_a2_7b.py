"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed experts
top-4 + 4 shared experts (shared intermediate 5632)."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,          # per routed expert
    vocab=151936,
    n_experts=60,
    top_k=4,
    n_shared=4,
    shared_d_ff=5632,
    rope_theta=1000000.0,
    notes="60 % 16 != 0 → experts replicated, expert d_ff TP-sharded "
          "(1408/16 = 88); shared expert is a standard TP MLP.",
))
