"""Llama-3-8B [arXiv:2407.21783] — dense GQA decoder, 128k vocab."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    rope_theta=500000.0,
    kv_dup_to_tp=True,
))
