"""Uniform model facade on an explicit device::

    m = Model(cfg)                            # device="cuda" by default
    params = m.init(seed)                     # or m.params_from_numpy(tree)
    loss, metrics = m.loss(params, batch)
    logits, aux = m.forward(params, batch)
    logits, caches = m.prefill(params, batch, cache_len=...)
    logits, caches = m.decode_step(params, tokens, caches, length)

The dense family only; the entry points take no gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.shardings import ShardingCtx, null_ctx
from repro_torch.models import param as PM
from repro_torch.models import transformer as TF


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device; the LM path runs on "
                           "the GPU unless the caller passes device='cpu'")
    return dev


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        TF.require_dense(self.cfg)
        self.device = resolve_device(self.device)

    @property
    def spec(self) -> Dict:
        return TF.lm_spec(self.cfg)

    def init(self, seed: Union[int, torch.Generator] = 0) -> Dict:
        """Parameters drawn from ``seed`` (or a generator on this
        model's device)."""
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return PM.init_params(self.spec, gen, self.device)

    def params_from_numpy(self, tree) -> Dict:
        """The JAX package's parameters (as numpy arrays) on this device."""
        return PM.params_from_numpy(tree, self.spec, device=self.device)

    def n_params(self) -> int:
        return PM.count_params(self.spec)

    # -- entry points ---------------------------------------------------------

    @torch.no_grad()
    def loss(self, params, batch, sc: Optional[ShardingCtx] = None):
        return TF.lm_loss(self.cfg, params, batch, sc or null_ctx())

    @torch.no_grad()
    def forward(self, params, batch, sc: Optional[ShardingCtx] = None):
        return TF.forward(self.cfg, params, batch, sc or null_ctx())

    @torch.no_grad()
    def prefill(self, params, batch, sc=None, cache_len: int = None):
        if cache_len is None:
            cache_len = batch["tokens"].shape[1]
        return TF.prefill(self.cfg, params, batch, sc or null_ctx(),
                          cache_len)

    @torch.no_grad()
    def decode_step(self, params, tokens, caches, length, sc=None):
        return TF.decode_step(self.cfg, params, tokens, caches, length,
                              sc or null_ctx())

    def cache_spec(self, batch: int, cache_len: int) -> Dict:
        return TF.cache_spec(self.cfg, batch, cache_len)

    def init_caches(self, batch: int, cache_len: int) -> Dict:
        return PM.tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                  device=self.device),
            self.cache_spec(batch, cache_len))
