"""Step functions: the train step (forward, backward, AdamW) and the
serving steps (prefill, decode).

The JAX package compiles each step into one XLA program; PyTorch runs
the same function eagerly.  The train step is the whole of the JAX
package's: the loss, its gradient over every parameter leaf
(``torch.autograd.grad``), the global-norm clip and the AdamW update,
with the same metrics.  Like the donated XLA step, it updates the state's
tensors in place (``optim/adamw.py``).  The sharding glue
(:func:`train_state_pspecs`, :func:`batch_pspecs`, :func:`cache_pspecs`)
maps each tensor of a cell onto a mesh's axes, as tuples of
``PartitionSpec`` entries.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.shardings import ShardingCtx, null_ctx
from repro_torch.models import param as PM
from repro_torch.models.modeling import Model, input_specs
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def batch_to(batch: Dict, device) -> Dict:
    """A batch of numpy arrays (the data pipeline's) or tensors on
    ``device``."""
    return {k: v.to(device) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def loss_and_grads(model: Model, params, batch: Dict,
                   sc: Optional[ShardingCtx] = None
                   ) -> Tuple[torch.Tensor, Dict, Dict]:
    """(loss, metrics, grads): the loss of ``batch`` and its gradient
    with respect to every leaf of ``params`` (a tree of the parameters'
    shapes and dtypes; a leaf the loss does not reach gets zeros).  The
    returned tensors are detached; ``params`` is not touched."""
    sc = sc or null_ctx()
    named = PM.tree_items(params)
    leaves: List[torch.Tensor] = [p.detach().requires_grad_(True)
                                  for _, p in named]
    with torch.enable_grad():
        loss, metrics = model.loss(
            PM.tree_unflatten(zip([p for p, _ in named], leaves)),
            batch_to(batch, model.device), sc)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            PM.tree_unflatten(zip([p for p, _ in named], grads)))


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    sc: Optional[ShardingCtx] = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` with metrics
    ``loss``, ``nll``, ``aux``, ``tokens``, ``grad_norm`` and ``lr`` (0-d
    tensors on the model's device).  ``state`` is updated in place and
    returned."""
    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        loss, metrics, grads = loss_and_grads(model, state["params"], batch,
                                              sc)
        new_params, new_opt, opt_metrics = adamw_update(
            grads, state["opt"], state["params"], opt_cfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_train_state(model: Model, seed=0) -> Dict:
    """Parameters from ``seed`` (or a generator) and a fresh AdamW state,
    on the model's device."""
    params = model.init(seed)
    return {"params": params, "opt": adamw_init(params)}


def abstract_train_state(model: Model) -> Dict:
    """The train state's tree as ``meta`` tensors (no storage)."""
    params = model.abstract_params()
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {"params": params,
            "opt": {"m": PM.tree_map(f32, params),
                    "v": PM.tree_map(f32, params),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def train_state_pspecs(model: Model, sc: ShardingCtx) -> Dict:
    pspecs = model.param_pspecs(sc.rules, sc.mesh_shape)
    return {"params": pspecs,
            "opt": {"m": pspecs, "v": pspecs, "step": ()}}


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------


def make_prefill_step(model: Model, sc: ShardingCtx,
                      cache_len: int) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch, sc, cache_len)

    return prefill_step


def make_decode_step(model: Model, sc: ShardingCtx) -> Callable:
    def decode_step(params, tokens, caches, length):
        return model.decode_step(params, tokens, caches, length, sc)

    return decode_step


# ---------------------------------------------------------------------------
# sharding glue for a full (arch x shape x mesh) cell
# ---------------------------------------------------------------------------


def batch_pspecs(cfg: ArchConfig, shape: ShapeConfig,
                 sc: ShardingCtx) -> Dict:
    specs, axes = input_specs(cfg, shape)
    return {name: sc.pspec(*axes[name], shape=specs[name].shape)
            for name in specs}


def cache_pspecs(model: Model, batch: int, cache_len: int,
                 sc: ShardingCtx) -> Any:
    spec = model.cache_spec(batch, cache_len)
    return PM.param_pspecs(spec, sc.rules, sc.mesh_shape)
