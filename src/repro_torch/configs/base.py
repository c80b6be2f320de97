"""ArchConfig: declarative architecture description + input shapes.

The fields are those of the JAX package's config, with torch dtypes.  The
port runs the ``dense``, ``moe``, ``ssm`` and ``encdec`` families; a
config of another family can be described here, and the model code
refuses it by name.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    act: str = "swiglu"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    head_dim: Optional[int] = None
    # moe
    n_experts: int = 0
    top_k: int = 0
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    # hybrid (recurrentgemma): layer pattern [rec]*(group-1) + [attn]
    hybrid_group: int = 3
    window: int = 0             # sliding-window size for local attention
    # modality frontend stub: precomputed embeddings prepended / encoded
    frontend: Optional[str] = None        # None | "vision" | "audio"
    frontend_len: int = 0                 # prefix length (vision)
    # encdec
    enc_layers: int = 0
    dec_layers: int = 0
    # engineering knobs
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: str = "full"                   # none | full | dots
    scan_layers: bool = True
    sharding_profile: str = "tp_fsdp"
    # ring = sequence-parallel ring attention (needs a mesh; without one
    # it falls through as the reference does); pallas = the CUDA kernels
    attn_impl: str = "ring"               # ring | blockwise | einsum | pallas
    sub_quadratic: bool = False           # can run long_500k
    source: str = ""                      # provenance note

    # ------------------------------------------------------------------ derived

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        return (self.vocab + 127) // 128 * 128

    def reduced(self, **over) -> "ArchConfig":
        """Smoke-test config: same family/topology, tiny dims."""
        kw: Dict[str, Any] = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 * self.hybrid_group
                         if self.family == "hybrid" else 2),
            d_model=128,
            n_heads=4, n_kv=min(self.n_kv, 2) or 1,
            d_ff=256, vocab=512,
            head_dim=None,
            n_experts=min(self.n_experts, 4), top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            frontend_len=8 if self.frontend == "vision" else 0,
            enc_layers=min(self.enc_layers, 1),
            dec_layers=min(self.dec_layers, 1),
            window=min(self.window, 16) if self.window else 0,
            remat="none", scan_layers=self.scan_layers,
            param_dtype=torch.float32, compute_dtype=torch.float32,
            attn_impl="einsum",
        )
        kw.update(over)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}



def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Cell applicability per the assignment rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention architecture; O(L^2) "
                       "attention with a materialised 500K KV cache is "
                       "architecture-infeasible (DESIGN.md section 6)")
    return True, ""
