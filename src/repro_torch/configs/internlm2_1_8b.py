"""InternLM2-1.8B [arXiv:2403.17297; hf] — dense GQA decoder."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92544,
    rope_theta=1000000.0,
    kv_dup_to_tp=True,
))
