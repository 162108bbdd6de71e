"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6-*] — VLM; the anyres vision
tiling is a stub, as in the reference: 2880 precomputed 1024-d patch
embeddings (5 tiles x 576) arrive in the batch (``patch_embeds``) and a
KSplit projection (``frontend_proj``) maps them to the model width
ahead of the text tokens.

``tp`` is the reference's 16: its 56 q heads are padded to 64 and its 8
kv heads duplicated to 16 (group 4), and the padded heads are real
weights there, so the port keeps that geometry.  ``fsdp=True`` as in
the reference (read by ``launch.sharding``); its ``remat_group=4`` has
no counterpart.  At full depth (60
layers, ~108 GB at ratio_high 0.5) it does not fit one card; the card
runs its first layers at every published width (``chip_smoke.py``
phase 12).
"""
from repro_torch.configs.base import REFERENCE_TP, ArchConfig, register

register(ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    frontend="vision",
    frontend_dim=1024,   # CLIP ViT-L hidden size
    n_patches=2880,      # anyres 5 tiles x 576 patches
    rope_theta=5000000.0,
    tp=REFERENCE_TP,
    notes="56 q-heads padded to 64 for TP=16 (kv 8 duplicated to 16).",
    fsdp=True,
))
