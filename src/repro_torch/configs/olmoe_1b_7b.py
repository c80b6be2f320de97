"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16 MHA) d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv=16, d_ff=1024,
    vocab=50304, act="swiglu", rope_theta=1e4,
    n_experts=64, top_k=8,
    source="arXiv:2409.02060; hf",
)
