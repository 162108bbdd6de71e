"""Llama-3-405B [arXiv:2407.21783] — the scale stress test.

``tp`` is the reference's 16 and ``kv_dup_to_tp`` duplicates its 8 kv
heads to 16 (group 8), as the reference's cache does; the duplicated
heads are real weights there.  ``fsdp=True`` as in the
reference (read by ``launch.sharding``); its ``remat_group=6`` has no
counterpart.  At full depth (126 layers, ~1.2 TB at ratio_high 0.5) it runs
reduced on the CPU and its first layers at published widths on the
card (``chip_smoke.py`` phase 12).
"""
from repro_torch.configs.base import REFERENCE_TP, ArchConfig, register

register(ArchConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    rope_theta=500000.0,
    tp=REFERENCE_TP,
    kv_dup_to_tp=True,
    fsdp=True,
))
