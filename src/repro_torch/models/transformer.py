"""Decoder-only LM assembly: the dense, moe and ssm families.

One parameter tree + entry points per model:

* ``spec(cfg)`` -- the parameter tree's specs,
* ``forward(cfg, params, batch, sc)``  -- full-sequence logits,
* ``lm_loss(cfg, params, batch, sc)``  -- forward + masked CE; the train
  step (``launch/steps.py``) differentiates it,
* ``prefill(cfg, params, batch, sc, cache_len)`` -- full-sequence forward
  emitting per-layer caches + last-position logits,
* ``decode_step(cfg, params, tokens, caches, length, sc)`` -- one token.

The parameter tree is the JAX package's: per-layer leaves are stacked on
a leading ``layers`` axis, and the layers run as a Python loop over that
axis (the JAX package's ``scan_layers`` shapes its traced program and
has no effect here).  ``remat`` applies, as in the JAX package, to each
layer of a forward that autograd records (:func:`_remat`): ``"full"``
keeps only each layer's input for the backward pass and recomputes the
rest, ``"dots"`` also keeps the outputs of the products without batch
dimensions, ``"none"`` keeps everything.  A moe layer's aux loss sums
over the layers into ``forward``'s second output, and ``lm_loss`` adds
0.01 of it.  An ssm layer is a Mamba2 mixer (``models/ssm.py``) behind
one RMSNorm, with no attention and no MLP; its caches are the SSD state
``[B, H, P, N]`` and the conv inputs of the last K-1 positions, both
f32, and decoding takes no ``length``.  Other families raise "not yet
ported" here:
``modeling.Model`` sends encdec to ``models/encdec.py``, which builds
it from this module's pieces.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as CK

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.shardings import ShardingCtx
from repro_torch.models import layers as L
from repro_torch.models import param as PM
from repro_torch.models import ssm as SSM
from repro_torch.models.param import ArraySpec, tree_map

F32 = torch.float32


#: The families this module assembles.
FAMILIES = ("dense", "moe", "ssm")


def require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not yet ported to "
            f"repro_torch (ported: {', '.join(FAMILIES)})")


def stack_specs(tree, n: int):
    return tree_map(
        lambda s: ArraySpec((n,) + s.shape, s.dtype, ("layers",) + s.axes,
                            s.init, s.scale), tree)


def layer_params(stacked, i: int):
    """Layer ``i``'s slice of a stacked tree (views, no copy)."""
    return tree_map(lambda a: a[i], stacked)


def depth(stacked) -> int:
    """The layers of a stacked tree (its leaves' leading extent)."""
    return PM.tree_items(stacked)[0][1].shape[0]


def positions_of(x: torch.Tensor) -> torch.Tensor:
    """RoPE positions 0..S-1 for each row of ``x`` [B, S, ...]."""
    b, s = x.shape[0], x.shape[1]
    return torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)


def _attn_cfg(cfg: ArchConfig, window: Optional[int] = None) -> L.AttnConfig:
    return L.AttnConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv=cfg.n_kv,
        head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
        qk_norm=cfg.qk_norm, causal=True, window=window,
        impl=cfg.attn_impl)


def _moe_cfg(cfg: ArchConfig) -> L.MoEConfig:
    return L.MoEConfig(n_experts=cfg.n_experts, top_k=cfg.top_k,
                       d_model=cfg.d_model, d_ff=cfg.d_ff, act=cfg.act)


def _ssm_cfg(cfg: ArchConfig) -> SSM.SSMConfig:
    return SSM.SSMConfig(
        d_model=cfg.d_model, d_inner=cfg.ssm_expand * cfg.d_model,
        head_dim=cfg.ssm_head_dim, n_groups=1, d_state=cfg.ssm_state,
        chunk=cfg.ssm_chunk)


# ---------------------------------------------------------------------------
# layer specs
# ---------------------------------------------------------------------------


def _layer_spec(cfg: ArchConfig) -> Dict:
    require_ported(cfg)
    dt = cfg.param_dtype
    if cfg.family == "ssm":
        return {"ln": L.rms_norm_spec(cfg.d_model),
                "mixer": SSM.mamba2_spec(_ssm_cfg(cfg), dt)}
    spec = {"ln1": L.rms_norm_spec(cfg.d_model),
            "attn": L.attention_spec(_attn_cfg(cfg), dt),
            "ln2": L.rms_norm_spec(cfg.d_model)}
    if cfg.family == "moe":
        spec["moe"] = L.moe_spec(_moe_cfg(cfg), dt)
    else:
        spec["mlp"] = L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, dt)
    return spec


def spec(cfg: ArchConfig) -> Dict:
    require_ported(cfg)
    dt = cfg.param_dtype
    return {
        "embed": ArraySpec((cfg.padded_vocab, cfg.d_model), dt,
                           ("vocab", "embed"), init="normal"),
        "final_norm": L.rms_norm_spec(cfg.d_model),
        "head": ArraySpec((cfg.d_model, cfg.padded_vocab), dt,
                          ("embed", "vocab"), init="fan_in"),
        "layers": stack_specs(_layer_spec(cfg), cfg.n_layers),
    }


# ---------------------------------------------------------------------------
# forward (scoring)
# ---------------------------------------------------------------------------


def _ffn(cfg, p, x, sc):
    """The layer's second residual branch and its aux loss: the MLP (aux
    0) or the MoE layer."""
    h = L.rms_norm(p["ln2"], x)
    if cfg.family == "moe":
        return L.moe(p["moe"], _moe_cfg(cfg), h, sc)
    return (L.mlp(p["mlp"], h, cfg.act, sc),
            torch.zeros((), dtype=F32, device=x.device))


def _block(cfg, p, x, positions, sc):
    if cfg.family == "ssm":
        x = x + SSM.mamba2_block(p["mixer"], _ssm_cfg(cfg),
                                 L.rms_norm(p["ln"], x), sc)
        return x, torch.zeros((), dtype=F32, device=x.device)
    x = x + L.attention(p["attn"], _attn_cfg(cfg),
                        L.rms_norm(p["ln1"], x), positions, sc)
    y, aux = _ffn(cfg, p, x, sc)
    x = sc.constrain(x + y, "batch", "seq", "act_embed")
    return x, aux


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of products without batch dimensions (the JAX
    package's ``dots_with_no_batch_dims_saveable``); recompute the rest.
    torch's einsum lowers such a product to ``bmm`` with a batch extent
    of 1 (the projections, the MLP, the head), and a product with batch
    dimensions (attention's) to ``bmm`` over them."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CK.CheckpointPolicy.MUST_SAVE
    return CK.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: ArchConfig, fn: Callable) -> Callable:
    """``fn`` under the config's activation checkpointing -- only when
    autograd records (scoring and serving run ``fn`` as it is)."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            CK.create_selective_checkpoint_contexts, _dots_policy)
    return lambda *args: CK.checkpoint(fn, *args, use_reentrant=False, **kw)


def _embed_tokens(cfg, params, tokens, sc: ShardingCtx):
    x = params["embed"][tokens].to(cfg.compute_dtype)
    return sc.constrain(x, "batch", "seq", "act_embed")


def _head(cfg, params, x):
    return torch.einsum("bsd,dv->bsv", x,
                        params["head"].to(cfg.compute_dtype))


def forward(cfg: ArchConfig, params, batch: Dict, sc: ShardingCtx
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B,S_total,V] in the compute dtype, aux_loss: the
    moe layers' summed, 0 for dense)."""
    require_ported(cfg)
    # the embedding stays in its own dtype: the gather reads the master
    # weights and casts what it read, the same values as a gather from
    # the cast copy, but the gather's backward then sums each token's
    # gradients in the parameter's dtype (f32), not in bf16
    params = dict(PM.cast_compute({k: v for k, v in params.items()
                                   if k != "embed"}, cfg.compute_dtype),
                  embed=params["embed"])
    x = _embed_tokens(cfg, params, batch["tokens"], sc)
    prefix = batch.get("prefix")          # vision stub: [B,P,d]
    if prefix is not None:
        x = torch.cat([prefix.to(cfg.compute_dtype), x], dim=1)
    positions = positions_of(x)
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    for i in range(depth(params["layers"])):
        lp = layer_params(params["layers"], i)
        x, a = _remat(cfg, lambda xx, lp=lp: _block(
            cfg, lp, xx, positions, sc))(x)
        aux_total = aux_total + a
    x = L.rms_norm(params["final_norm"], x)
    logits = sc.constrain(_head(cfg, params, x), "batch", "seq", "act_mlp")
    return logits, aux_total


def lm_loss(cfg: ArchConfig, params, batch: Dict, sc: ShardingCtx
            ) -> Tuple[torch.Tensor, Dict]:
    logits, aux = forward(cfg, params, batch, sc)
    return loss_of(logits, aux, batch)


def loss_of(logits: torch.Tensor, aux: torch.Tensor, batch: Dict
            ) -> Tuple[torch.Tensor, Dict]:
    """Masked CE of ``logits`` against ``batch["labels"]`` (a vision
    prefix's positions cut off) plus 0.01 of the aux loss."""
    labels = batch["labels"]
    prefix = batch.get("prefix")
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:]
    logits = logits.float()
    mask = (labels >= 0).to(F32)
    safe = torch.clamp_min(labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    # the gold logit by gather: the same value as the reference's one-hot
    # contraction (which it uses to keep a vocab-sharded axis local)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = nll.sum() / denom + 0.01 * aux
    return loss, {"nll": nll.sum() / denom, "aux": aux,
                  "tokens": mask.sum()}


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def cache_spec(cfg: ArchConfig, batch: int, cache_len: int,
               enc_len: int = 0) -> Dict:
    """Each layer's K/V cache of ``cache_len`` positions; an ssm layer's
    state and conv tail (``cache_len`` unused).  ``enc_len`` is unused
    (no encoder): it keeps the signature of ``encdec.cache_spec``, which
    ``modeling.Model`` dispatches alike."""
    require_ported(cfg)
    if cfg.family == "ssm":
        one = SSM.mamba2_cache_spec(_ssm_cfg(cfg), batch)
    else:
        one = L.attention_cache_spec(_attn_cfg(cfg), batch, cache_len,
                                     cfg.compute_dtype)
    return {"layers": stack_specs(one, cfg.n_layers)}


def prefill(cfg: ArchConfig, params, batch: Dict, sc: ShardingCtx,
            cache_len: int):
    """Full-sequence prefill -> (last-token logits [B,V] f32, caches)."""
    require_ported(cfg)
    params = PM.cast_compute(params, cfg.compute_dtype)
    x = _embed_tokens(cfg, params, batch["tokens"], sc)
    prefix = batch.get("prefix")
    if prefix is not None:
        x = torch.cat([prefix.to(cfg.compute_dtype), x], dim=1)
    if cfg.family == "ssm":
        x, caches = _ssm_prefill(cfg, params, x, sc)
    else:
        x, caches = _attn_prefill(cfg, params, x, sc, cache_len)
    x = L.rms_norm(params["final_norm"], x[:, -1:])
    return _head(cfg, params, x)[:, 0].to(F32), caches


def _attn_prefill(cfg: ArchConfig, params, x, sc: ShardingCtx,
                  cache_len: int):
    positions = positions_of(x)
    acfg = _attn_cfg(cfg)
    ks, vs = [], []
    for i in range(depth(params["layers"])):
        lp = layer_params(params["layers"], i)
        a, cache = L.attention_prefill(lp["attn"], acfg,
                                       L.rms_norm(lp["ln1"], x), positions,
                                       sc, cache_len)
        x = x + a
        x = x + _ffn(cfg, lp, x, sc)[0]
        ks.append(cache["k"])
        vs.append(cache["v"])
    return x, {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def _ssm_prefill(cfg: ArchConfig, params, x, sc: ShardingCtx):
    """Each layer's final SSD state and :func:`SSM_conv_tail`."""
    scfg = _ssm_cfg(cfg)
    states, convs = [], []
    for i in range(depth(params["layers"])):
        lp = layer_params(params["layers"], i)
        h = L.rms_norm(lp["ln"], x)
        y, state = SSM.mamba2_block(lp["mixer"], scfg, h, sc,
                                    return_state=True)
        states.append(state)
        convs.append(SSM_conv_tail(lp["mixer"], scfg, h))
        x = x + y
        del h, y
    return x, {"layers": {"state": torch.stack(states),
                          "conv": torch.stack(convs)}}


def SSM_conv_tail(p, scfg: SSM.SSMConfig, h):
    """Decode conv state after prefill: the last K-1 positions' conv
    inputs (after the in-projection), f32."""
    zxbcdt = h[:, -(scfg.conv_kernel - 1):] @ p["in_proj"]
    return SSM._split_proj(scfg, zxbcdt)[1].to(F32)


def decode_step(cfg: ArchConfig, params, tokens: torch.Tensor,
                caches: Dict, length, sc: ShardingCtx):
    """tokens: [B] int; length: tokens already cached (unused by ssm).
    Returns (logits [B,V] f32, caches) -- the caches updated in place."""
    require_ported(cfg)
    params = PM.cast_compute(params, cfg.compute_dtype)
    x = params["embed"][tokens[:, None]].to(cfg.compute_dtype)
    layers = _ssm_decode if cfg.family == "ssm" else _attn_decode
    x = layers(cfg, params, x, caches["layers"], length, sc)
    x = L.rms_norm(params["final_norm"], x)
    return _head(cfg, params, x)[:, 0].to(F32), caches


def _attn_decode(cfg: ArchConfig, params, x, caches, length,
                 sc: ShardingCtx):
    acfg = _attn_cfg(cfg)
    for i in range(depth(params["layers"])):
        lp = layer_params(params["layers"], i)
        a, _ = L.attention_decode(lp["attn"], acfg,
                                  L.rms_norm(lp["ln1"], x),
                                  {"k": caches["k"][i], "v": caches["v"][i]},
                                  length, sc)
        x = x + a
        x = x + _ffn(cfg, lp, x, sc)[0]
    return x


def _ssm_decode(cfg: ArchConfig, params, x, caches, length,
                sc: ShardingCtx):
    scfg = _ssm_cfg(cfg)
    for i in range(depth(params["layers"])):
        lp = layer_params(params["layers"], i)
        y, new = SSM.mamba2_step(lp["mixer"], scfg, L.rms_norm(lp["ln"], x),
                                 layer_params(caches, i), sc)
        for k, t in new.items():
            caches[k][i].copy_(t)
        x = x + y
    return x
