"""Encoder-decoder model (the seamless-m4t family).

The audio frontend is a stub, as in the JAX package: the batch carries
precomputed frame embeddings ``enc_embeds`` [B, S_enc, d_model]
(``modeling.enc_len_of``: one frame per four decoder tokens), and the
model is the transformer backbone -- a bidirectional encoder over the
frames and a causal decoder whose layers attend to the encoder's output.

Self attention, in the encoder and the decoder, goes through
``layers.attention`` / ``attention_prefill`` / ``attention_decode``: under
``attn_impl="pallas"`` the encoder takes the flash kernel non-causally,
the decoder flash in prefill and ``decode_attention`` in decode.  Cross
attention is the JAX package's einsum path (``layers._einsum_attention``
over K/V in the cache layout ``[B, K, S_enc, D]``), outside any kernel
in both packages.  The layers run as a Python loop over the stacked
trees, as in ``models/transformer.py``, whose pieces this module reuses.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.shardings import ShardingCtx
from repro_torch.models import layers as L
from repro_torch.models import param as PM
from repro_torch.models.param import ArraySpec
from repro_torch.models.transformer import (_attn_cfg, _embed_tokens, _head,
                                            _remat, depth, layer_params,
                                            loss_of, positions_of,
                                            stack_specs)

F32 = torch.float32


def _cross_spec(cfg: ArchConfig, dtype) -> Dict:
    c = _attn_cfg(cfg)
    return {
        "wq": ArraySpec((c.d_model, c.n_heads, c.head_dim), dtype,
                        ("embed", "heads", None), init="fan_in"),
        "wk": ArraySpec((c.d_model, c.n_kv, c.head_dim), dtype,
                        ("embed", "kv", None), init="fan_in"),
        "wv": ArraySpec((c.d_model, c.n_kv, c.head_dim), dtype,
                        ("embed", "kv", None), init="fan_in"),
        "wo": ArraySpec((c.n_heads, c.head_dim, c.d_model), dtype,
                        ("heads", None, "embed"), init="fan_in"),
    }


def _cross_kv(p, cfg: ArchConfig, memory):
    """The encoder output's K and V, in the ``[B, K, S_enc, D]`` cache
    layout."""
    k = torch.einsum("bsd,dhk->bhsk", memory, p["wk"])
    v = torch.einsum("bsd,dhk->bhsk", memory, p["wv"])
    return k, v


def _cross_attend(p, cfg: ArchConfig, x, k, v):
    c = dataclasses.replace(_attn_cfg(cfg), causal=False, window=None)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    o = L._einsum_attention(q, k, v, c, kv_format="bksd")
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def spec(cfg: ArchConfig) -> Dict:
    """The parameter tree's specs (the JAX package's ``encdec_spec``)."""
    dt = cfg.param_dtype
    enc_layer = {"ln1": L.rms_norm_spec(cfg.d_model),
                 "attn": L.attention_spec(_attn_cfg(cfg), dt),
                 "ln2": L.rms_norm_spec(cfg.d_model),
                 "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, dt)}
    dec_layer = {"ln1": L.rms_norm_spec(cfg.d_model),
                 "self": L.attention_spec(_attn_cfg(cfg), dt),
                 "ln_x": L.rms_norm_spec(cfg.d_model),
                 "cross": _cross_spec(cfg, dt),
                 "ln2": L.rms_norm_spec(cfg.d_model),
                 "mlp": L.mlp_spec(cfg.d_model, cfg.d_ff, cfg.act, dt)}
    return {
        "embed": ArraySpec((cfg.padded_vocab, cfg.d_model), dt,
                           ("vocab", "embed"), init="normal"),
        "enc_layers": stack_specs(enc_layer, cfg.enc_layers),
        "enc_norm": L.rms_norm_spec(cfg.d_model),
        "dec_layers": stack_specs(dec_layer, cfg.dec_layers),
        "final_norm": L.rms_norm_spec(cfg.d_model),
        "head": ArraySpec((cfg.d_model, cfg.padded_vocab), dt,
                          ("embed", "vocab"), init="fan_in"),
    }


def _enc_block(cfg, acfg, lp, x, positions, sc):
    x = x + L.attention(lp["attn"], acfg, L.rms_norm(lp["ln1"], x),
                        positions, sc)
    return x + L.mlp(lp["mlp"], L.rms_norm(lp["ln2"], x), cfg.act, sc)


def encode(cfg: ArchConfig, params, enc_embeds, sc: ShardingCtx):
    """The encoder over ``enc_embeds`` [B, S_enc, d]: bidirectional self
    attention at RoPE positions 0..S_enc-1, then ``enc_norm``."""
    params = PM.cast_compute({k: params[k] for k in ("enc_layers",
                                                     "enc_norm")},
                             cfg.compute_dtype)
    x = enc_embeds.to(cfg.compute_dtype)
    x = sc.constrain(x, "batch", "seq", "act_embed")
    positions = positions_of(x)
    acfg = dataclasses.replace(_attn_cfg(cfg), causal=False)
    for i in range(depth(params["enc_layers"])):
        lp = layer_params(params["enc_layers"], i)
        x = _remat(cfg, lambda xx, lp=lp: _enc_block(
            cfg, acfg, lp, xx, positions, sc))(x)
    return L.rms_norm(params["enc_norm"], x)


def _dec_block(cfg, acfg, lp, x, positions, memory, sc):
    x = x + L.attention(lp["self"], acfg, L.rms_norm(lp["ln1"], x),
                        positions, sc)
    k, v = _cross_kv(lp["cross"], cfg, memory)
    x = x + _cross_attend(lp["cross"], cfg, L.rms_norm(lp["ln_x"], x), k, v)
    return x + L.mlp(lp["mlp"], L.rms_norm(lp["ln2"], x), cfg.act, sc)


def forward(cfg: ArchConfig, params, batch: Dict, sc: ShardingCtx
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """batch: enc_embeds [B,S_enc,d], tokens [B,S_dec] -> (logits
    [B,S_dec,V] in the compute dtype, aux 0)."""
    memory = encode(cfg, params, batch["enc_embeds"], sc)
    # the embedding stays in its own dtype, as in transformer.forward
    params = dict(PM.cast_compute({k: v for k, v in params.items()
                                   if k != "embed"}, cfg.compute_dtype),
                  embed=params["embed"])
    x = _embed_tokens(cfg, params, batch["tokens"], sc)
    positions = positions_of(x)
    acfg = _attn_cfg(cfg)
    for i in range(depth(params["dec_layers"])):
        lp = layer_params(params["dec_layers"], i)
        x = _remat(cfg, lambda xx, lp=lp: _dec_block(
            cfg, acfg, lp, xx, positions, memory, sc))(x)
    x = L.rms_norm(params["final_norm"], x)
    return _head(cfg, params, x), torch.zeros((), dtype=F32,
                                              device=x.device)


def lm_loss(cfg: ArchConfig, params, batch: Dict, sc: ShardingCtx
            ) -> Tuple[torch.Tensor, Dict]:
    logits, aux = forward(cfg, params, batch, sc)
    return loss_of(logits, aux, batch)


def cache_spec(cfg: ArchConfig, batch: int, cache_len: int,
               enc_len: int) -> Dict:
    cdtype = cfg.compute_dtype
    self_spec = L.attention_cache_spec(_attn_cfg(cfg), batch, cache_len,
                                       cdtype)
    cross_shape = (batch, cfg.n_kv, enc_len, cfg.head_dim_)
    cross = {"k": ArraySpec(cross_shape, cdtype,
                            ("batch", None, None, None), init="zeros"),
             "v": ArraySpec(cross_shape, cdtype,
                            ("batch", None, None, None), init="zeros")}
    one = {"self": self_spec, "cross": cross}
    return {"layers": stack_specs(one, cfg.dec_layers)}


def prefill(cfg: ArchConfig, params, batch: Dict, sc: ShardingCtx,
            cache_len: int):
    """Encode + decoder prefill -> (last-token logits [B,V] f32, caches:
    each decoder layer's self-attention K/V at [0, S_dec) of cache_len
    positions, and the cross K/V of the encoder's own length)."""
    params = PM.cast_compute(params, cfg.compute_dtype)
    memory = encode(cfg, params, batch["enc_embeds"], sc)
    x = _embed_tokens(cfg, params, batch["tokens"], sc)
    positions = positions_of(x)
    acfg = _attn_cfg(cfg)
    kv = {"self": {"k": [], "v": []}, "cross": {"k": [], "v": []}}
    for i in range(depth(params["dec_layers"])):
        lp = layer_params(params["dec_layers"], i)
        a, cache = L.attention_prefill(lp["self"], acfg,
                                       L.rms_norm(lp["ln1"], x), positions,
                                       sc, cache_len)
        x = x + a
        ck, cv = _cross_kv(lp["cross"], cfg, memory)
        x = x + _cross_attend(lp["cross"], cfg, L.rms_norm(lp["ln_x"], x),
                              ck, cv)
        x = x + L.mlp(lp["mlp"], L.rms_norm(lp["ln2"], x), cfg.act, sc)
        for part, (k, v) in (("self", (cache["k"], cache["v"])),
                             ("cross", (ck, cv))):
            kv[part]["k"].append(k.to(cfg.compute_dtype))
            kv[part]["v"].append(v.to(cfg.compute_dtype))
    caches = {"layers": PM.tree_map(torch.stack, kv)}
    x = L.rms_norm(params["final_norm"], x[:, -1:])
    return _head(cfg, params, x)[:, 0].to(F32), caches


def decode_step(cfg: ArchConfig, params, tokens: torch.Tensor,
                caches: Dict, length, sc: ShardingCtx):
    """tokens: [B] int; length: decoder tokens already cached.  Returns
    (logits [B,V] f32, caches) -- the self-attention caches updated in
    place; the cross K/V are read at their own length."""
    params = PM.cast_compute(params, cfg.compute_dtype)
    x = params["embed"][tokens[:, None]].to(cfg.compute_dtype)
    acfg = _attn_cfg(cfg)
    own, cross = caches["layers"]["self"], caches["layers"]["cross"]
    for i in range(depth(params["dec_layers"])):
        lp = layer_params(params["dec_layers"], i)
        a, _ = L.attention_decode(lp["self"], acfg,
                                  L.rms_norm(lp["ln1"], x),
                                  {"k": own["k"][i], "v": own["v"][i]},
                                  length, sc)
        x = x + a
        x = x + _cross_attend(lp["cross"], cfg, L.rms_norm(lp["ln_x"], x),
                              cross["k"][i], cross["v"][i])
        x = x + L.mlp(lp["mlp"], L.rms_norm(lp["ln2"], x), cfg.act, sc)
    x = L.rms_norm(params["final_norm"], x)
    return _head(cfg, params, x)[:, 0].to(F32), caches
