"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 -- pixtral-ViT + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

Backbone only; the vision frontend is a STUB (input_specs provides
precomputed patch embeddings [B, 256, d_model] prepended to the token
sequence)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv=8, d_ff=14336,
    vocab=131072, act="swiglu", rope_theta=1e6,
    frontend="vision", frontend_len=256,
    source="hf:mistralai/Pixtral-12B-2409; unverified",
)
