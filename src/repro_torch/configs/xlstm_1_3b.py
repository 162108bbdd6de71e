"""xLSTM-1.3B [arXiv:2405.04517] — sLSTM + mLSTM blocks (1:7)."""
from repro_torch.configs.base import ArchConfig, register

register(ArchConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,              # cells carry their own projections/FFN
    vocab=50304,
    block_type="xlstm",
    slstm_every=8,
    use_rope=False,
    notes="Recurrent state only → long_500k runs with O(1) decode state.",
))
