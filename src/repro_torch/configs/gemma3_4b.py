"""Gemma-3-4B [hf:google/gemma-3-*-pt] — 5:1 local:global attention
(sliding window 1024), 262k vocab."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    attn_pattern="local_global",
    local_window=1024,
    global_every=6,     # layers 5, 11, 17, 23, 29 global
    rope_theta=1000000.0,
    notes="8 q-heads padded to 16 for TP; long_500k allowed: local layers "
          "cache only the 1024 window, globals sequence-shard the cache.",
    kv_dup_to_tp=True,
))
