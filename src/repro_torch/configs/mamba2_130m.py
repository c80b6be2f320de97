"""mamba2-130m [ssm]: 24L d_model=768 (attn-free) d_ff=0 vocab=50280,
ssm_state=128 -- SSD (state-space duality). [arXiv:2405.21060]

Sub-quadratic: runs long_500k.  Tiny model => dp_only sharding profile
(model axis folds into batch; TP would shard a 768-wide matmul 16 ways)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=24, n_kv=24, d_ff=0,
    vocab=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    sub_quadratic=True, sharding_profile="dp_only",
    source="arXiv:2405.21060; unverified",
)
