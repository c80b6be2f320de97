"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (kv=16 MHA)
d_ff=8192 vocab=256206 -- enc-dec, multimodal. [arXiv:2308.11596; hf]

Backbone only; the audio frontend is a STUB (input_specs provides
precomputed frame embeddings, 1 frame per 4 decoder tokens).  The 24
layers split 12 encoder + 12 decoder (DESIGN.md section 6)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv=16, d_ff=8192,
    vocab=256206, act="gelu", enc_layers=12, dec_layers=12,
    frontend="audio",
    source="arXiv:2308.11596; hf",
)
