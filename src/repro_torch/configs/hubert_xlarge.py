"""HuBERT X-Large [arXiv:2106.07447] — encoder-only audio transformer;
the conv waveform frontend is a stub, as in the reference: precomputed
512-d frame embeddings arrive in the batch (``frames``) and a KSplit
projection (``frontend_proj``) maps them to the model width.  Attention
is bidirectional and positions come from a learned table
(``pos_embed``); there is no decode step.  Its 16 heads need no padding
at the reference's 16-way axis, so ``tp`` stays 1.
"""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,          # k-means cluster targets
    encoder_only=True,
    frontend="audio",
    frontend_dim=512,
    use_rope=False,
    gated_mlp=False,    # GELU FFN
    notes="Encoder-only: decode shapes skipped; vocab 504 not TP-divisible "
          "so the head/embedding replicate over model.",
))
