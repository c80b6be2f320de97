"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 -- qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]

The same config as the JAX package's: ``head_dim`` is left unset, so the
head width is d_model / n_heads = 64 (the public Qwen3-0.6B uses 128)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv=8, d_ff=3072,
    vocab=151936, act="swiglu", qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B; hf",
)
