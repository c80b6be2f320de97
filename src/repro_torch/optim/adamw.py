"""AdamW with decoupled weight decay and global-norm clipping.

The arithmetic of the JAX package's ``optim/adamw.py``: clip first, bias
corrections from the f32 step, decay on every leaf (the norms' scales
too), ``m`` and ``v`` in f32.  Trees are the nested dicts of
``repro_torch.models.param``.

The JAX train step donates its state, so XLA updates the buffers in
place.  The eager counterpart here does the same explicitly:
:func:`adamw_update` writes the new parameters, ``m`` and ``v`` into the
tensors it was given, under ``torch.no_grad()``, and returns those same
tensors.  At qwen3-0.6b's full width that saves a second copy of the
f32 parameters, ``m`` and ``v`` (about 8 GB) and of the gradients' f32
copies; a caller that needs the old values must clone them first.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.models.param import tree_items, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=F32, device=step.device)


def adamw_init(params) -> Dict[str, Any]:
    """Zero moments in f32 and a 0-d int32 step, on the parameters'
    device."""
    zeros = lambda p: torch.zeros(p.shape, dtype=F32, device=p.device)
    leaves = [l for _, l in tree_items(params)]
    dev = leaves[0].device if leaves else torch.device("cpu")
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    leaves = [l for _, l in tree_items(tree)]
    return torch.sqrt(sum(torch.sum(l.to(F32) ** 2) for l in leaves))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before clipping).  Returns new tensors; ``grads`` is not touched."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(grads, opt_state, params, cfg: AdamWConfig
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Updates ``params``, ``opt_state["m"]`` and
    ``opt_state["v"]`` in place (see the module docstring) and returns
    ``(params, opt_state, {"grad_norm", "lr"})``; the step counter is a
    new tensor."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = opt_state["step"] + 1
    lr = cfg.lr_at(step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(F32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)

    def upd(p, g, m, v):
        gf = g.to(F32)
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.to(F32)
        p.copy_((p.to(F32) - lr * delta).to(p.dtype))

    flat_p = tree_items(params)
    trees = [dict(tree_items(t)) for t in
             (grads, opt_state["m"], opt_state["v"])]
    for t in trees:
        if t.keys() != dict(flat_p).keys():
            raise ValueError("adamw_update: grads, m and v must have the "
                             "parameters' leaves")
    for path, p in flat_p:
        upd(p, *(t[path] for t in trees))
    new_opt = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
    return params, new_opt, {"grad_norm": gnorm, "lr": lr}
