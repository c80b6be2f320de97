"""Gradient compression: int8 quantized all-reduce with error feedback.

The JAX package's ``optim/compression.py``: data-parallel gradient
all-reduce traffic drops 4x (f32 -> int8 + one f32 scale per tensor), and
error feedback (Seide et al. / EF-SGD) folds the quantization residual
into the next step, which keeps convergence unchanged to first order.

* :func:`quantize` / :func:`dequantize` -- the building blocks,
* :func:`compressed_psum` -- the collective over a ``torch.distributed``
  process group: the counterpart of the JAX package's ``shard_map``
  collective (``pmax`` of the scale, ``psum`` of the payload).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.param import tree_items, tree_map, tree_unflatten

F32 = torch.float32


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization -> (q, scale)."""
    amax = torch.max(torch.abs(x.to(F32)))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(F32) / scale), -127, 127
                    ).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Returns (q, scale, new_error): error feedback fold-in."""
    corrected = grad.to(F32) + error
    q, scale = quantize(corrected)
    new_error = corrected - dequantize(q, scale)
    return q, scale, new_error


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-payload all-reduce over a ``torch.distributed`` process group
    (``None``: the default group).

    Two phases: (1) an ``all_reduce`` MAX of one scalar agrees on a
    COMMON quantization scale, (2) the payload quantized with that scale
    is summed as int32 (no overflow up to 2^23 participants).  Returns
    the dequantized sum; ``x`` is not touched."""
    import torch.distributed as dist

    amax = torch.max(torch.abs(x.to(F32))).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp_min(amax[0], 1e-12) / 127.0
    q = torch.clamp(torch.round(x.to(F32) / scale), -127, 127
                    ).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.to(F32) * scale


def tree_compress_grads(grads, errors):
    """Error-feedback compression leaf by leaf; returns (dequantized
    grads, new errors) -- the accumulation-loop variant."""
    err = dict(tree_items(errors))
    outs = [(path, compress_with_feedback(g, err[path]))
            for path, g in tree_items(grads)]
    deq = tree_unflatten([(p, dequantize(q, s)) for p, (q, s, _) in outs])
    new_e = tree_unflatten([(p, e) for p, (_, _, e) in outs])
    return deq, new_e


def zeros_like_errors(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)
