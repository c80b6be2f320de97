"""Shared neural layers: RMSNorm, RoPE, GQA attention, MLP, MoE.

All layers are plain functions over nested dicts of tensors (the
parameter trees of ``repro_torch.models.param``), as in the JAX package.
Attention has three execution paths:

* ``blockwise`` -- online-softmax attention in plain PyTorch, a Python
  loop over Q blocks and K blocks (O(S * block) live),
* ``einsum``    -- direct attention for short sequences / decode,
* ``pallas``    -- the hand-written CUDA kernels: ``flash_attention`` for
  full sequences, and (a port extension: the JAX package's prefill and
  decode never reach a kernel) ``flash_attention`` in prefill and
  ``decode_attention`` in decode.  On CPU tensors they run their plain
  versions.

Products that the JAX package asks for with
``preferred_element_type=f32`` are taken here on f32 copies of their
operands: a product of two bf16 values is exact in f32, so the sums are
the same f32 sums.  MoE is the JAX package's mesh-less path (a
capacity-bounded scatter into ``[E, C, d]`` and batched expert products);
its expert-parallel ``moe_shardmap``, ring attention and window caches
are not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.shardings import ShardingCtx
from repro_torch.kernels.decode_attention import kernel as DA
from repro_torch.kernels.flash_attention import kernel as FL
from repro_torch.models.param import ArraySpec

F32 = torch.float32
NEG_INF = -1e30

IMPLS = ("ring", "blockwise", "einsum", "pallas")

# ---------------------------------------------------------------------------
# normalisation + rope
# ---------------------------------------------------------------------------


def rms_norm_spec(dim: int) -> Dict:
    return {"scale": ArraySpec((dim,), F32, (None,), init="ones")}


def rms_norm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device)
                      / half)
    angles = positions[..., :, None, None].to(F32) * freqs
    # angles: [..., S, 1, half] (broadcast over heads)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    causal: bool = True
    window: Optional[int] = None      # sliding-window (local) attention
    impl: str = "blockwise"           # blockwise | einsum | pallas | ring
    block_q: int = 512
    block_k: int = 1024


def attention_spec(c: AttnConfig, dtype=torch.bfloat16) -> Dict:
    p = {
        "wq": ArraySpec((c.d_model, c.n_heads, c.head_dim), dtype,
                        ("embed", "heads", None), init="fan_in"),
        "wk": ArraySpec((c.d_model, c.n_kv, c.head_dim), dtype,
                        ("embed", "kv", None), init="fan_in"),
        "wv": ArraySpec((c.d_model, c.n_kv, c.head_dim), dtype,
                        ("embed", "kv", None), init="fan_in"),
        "wo": ArraySpec((c.n_heads, c.head_dim, c.d_model), dtype,
                        ("heads", None, "embed"), init="fan_in"),
    }
    if c.qk_norm:
        p["q_norm"] = rms_norm_spec(c.head_dim)
        p["k_norm"] = rms_norm_spec(c.head_dim)
    return p


def _check_impl(c: AttnConfig) -> None:
    if c.impl not in IMPLS:
        raise NotImplementedError(f"attention impl {c.impl!r} is not ported; "
                                  f"known: {IMPLS}")


def _qkv(p, c: AttnConfig, x, positions, sc: ShardingCtx):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = sc.constrain(q, "batch", "seq", "act_heads", None)
    k = sc.constrain(k, "batch", "seq", "act_heads", None)
    if c.qk_norm:
        q = rms_norm(p["q_norm"], q)
        k = rms_norm(p["k_norm"], k)
    q = rope(q, positions, c.rope_theta)
    k = rope(k, positions, c.rope_theta)
    return q, k, v


def _mask(c: AttnConfig, q_pos: torch.Tensor,
          k_pos: torch.Tensor) -> torch.Tensor:
    mask = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool,
                      device=q_pos.device)
    if c.causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if c.window is not None:
        mask &= q_pos[:, None] - k_pos[None, :] < c.window
    return mask


def _einsum_attention(q, k, v, c: AttnConfig, q_offset: int = 0,
                      kv_valid: Optional[torch.Tensor] = None,
                      kv_format: str = "bskd"):
    """q: [B,Sq,H,D]; k/v: [B,Sk,K,D] ("bskd") or [B,K,Sk,D] ("bksd").

    The "bksd" layout is the KV cache's storage order.  Logits and the
    P.V product accumulate in f32; p is rounded to v's dtype first, as in
    the reference."""
    b, sq, h, d = q.shape
    if kv_format == "bskd":
        sk, kheads = k.shape[1], k.shape[2]
    else:
        sk, kheads = k.shape[2], k.shape[1]
    sub = kv_format
    group = h // kheads
    qg = q.reshape(b, sq, kheads, group, d)
    logits = torch.einsum(f"bqkgd,{sub}->bkgqs", qg.float(),
                          k.float()) * (d ** -0.5)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(sk, device=q.device)
    mask = _mask(c, q_pos, k_pos)
    if kv_valid is not None:  # [B, Sk]
        mask = mask[None] & kv_valid[:, None, :]
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
    else:
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum(f"bkgqs,{sub}->bqkgd", p.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _blockwise_attention(q, k, v, c: AttnConfig):
    """Flash-style attention in plain PyTorch: loop over Q blocks, and for
    each over K blocks with the online-softmax state in f32."""
    b, s, h, d = q.shape
    kheads = k.shape[2]
    group = h // kheads
    bq = min(c.block_q, s)
    while s % bq:
        bq //= 2
    bk = min(c.block_k, s)
    while s % bk:
        bk //= 2
    nq, nk = s // bq, s // bk
    qg = q.reshape(b, nq, bq, kheads, group, d)
    kb = k.reshape(b, nk, bk, kheads, d)
    vb = v.reshape(b, nk, bk, kheads, d)
    scale = d ** -0.5
    blocks = []
    for qi in range(nq):
        qblk = qg[:, qi].float()  # [b, bq, kh, g, d]
        acc = torch.zeros(b, kheads, group, bq, d, dtype=F32,
                          device=q.device)
        m = torch.full((b, kheads, group, bq, 1), NEG_INF, dtype=F32,
                       device=q.device)
        l = torch.zeros(b, kheads, group, bq, 1, dtype=F32, device=q.device)
        q_pos = qi * bq + torch.arange(bq, device=q.device)
        for ki in range(nk):
            kblk, vblk = kb[:, ki], vb[:, ki]
            s_ = torch.einsum("bqkgd,bskd->bkgqs", qblk,
                              kblk.float()) * scale
            k_pos = ki * bk + torch.arange(bk, device=q.device)
            s_ = torch.where(_mask(c, q_pos, k_pos)[None, None, None], s_,
                             NEG_INF)
            m_new = torch.maximum(m, s_.amax(-1, keepdim=True))
            pexp = torch.exp(s_ - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + pexp.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bkgqs,bskd->bkgqd", pexp.to(vblk.dtype).float(),
                vblk.float())
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)
        blocks.append(out.permute(0, 3, 1, 2, 4))  # [b,bq,kh,g,d]
    out = torch.stack(blocks, dim=1).reshape(b, s, h, d)
    return out.to(q.dtype)


def _flash(q, k, v, c: AttnConfig):
    """The flash kernel on [B,S,H,D] / [B,S,K,D] tensors."""
    o = FL.flash_attention(q.transpose(1, 2).contiguous(),
                           k.transpose(1, 2).contiguous(),
                           v.transpose(1, 2).contiguous(), causal=c.causal)
    return o.transpose(1, 2)


def attention(p: Dict, c: AttnConfig, x: torch.Tensor,
              positions: torch.Tensor, sc: ShardingCtx) -> torch.Tensor:
    """Full-sequence attention (training / prefill). x: [B,S,d]."""
    _check_impl(c)
    q, k, v = _qkv(p, c, x, positions, sc)
    # impl "ring" is never applicable without a mesh: it falls through
    # to einsum / blockwise exactly as the reference does
    if c.impl == "pallas":
        if c.window is None:
            o = _flash(q, k, v, c)
        else:  # window masking not in the kernel
            o = _blockwise_attention(q, k, v, c)
    elif c.impl == "einsum" or x.shape[1] <= max(c.block_q, c.block_k):
        o = _einsum_attention(q, k, v, c)
    else:
        o = _blockwise_attention(q, k, v, c)
    o = sc.constrain(o, "batch", "seq", "act_heads", None)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


def attention_prefill(p, c: AttnConfig, x, positions, sc: ShardingCtx,
                      cache_len: int):
    """Prefill: returns (out, cache) with K/V written at [0, S) of a
    ``[B, K, cache_len, D]`` cache."""
    _check_impl(c)
    b, s = x.shape[0], x.shape[1]
    if cache_len < s:
        raise NotImplementedError(
            f"attention_prefill: a cache of {cache_len} < {s} positions (a "
            f"window ring cache) is not yet ported")
    q, k, v = _qkv(p, c, x, positions, sc)
    if c.impl == "pallas" and c.window is None:
        out = _flash(q, k, v, c)
    elif s > max(c.block_q, c.block_k):
        out = _blockwise_attention(q, k, v, c)
    else:
        out = _einsum_attention(q, k, v, c)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    # cache storage is [B, K, S, D]: the decode step reads it directly
    shape = (b, k.shape[2], cache_len, k.shape[3])
    kc = torch.zeros(shape, dtype=k.dtype, device=k.device)
    vc = torch.zeros(shape, dtype=v.dtype, device=v.device)
    kc[:, :, :s] = k.transpose(1, 2)
    vc[:, :, :s] = v.transpose(1, 2)
    kc = sc.constrain(kc, "batch", None, "kv_seq", None)
    vc = sc.constrain(vc, "batch", None, "kv_seq", None)
    return out, {"k": kc, "v": vc}


def attention_decode(p, c: AttnConfig, x: torch.Tensor, cache: Dict,
                     length, sc: ShardingCtx
                     ) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  x: [B,1,d]; cache k/v: [B,K,S,D]; length: tokens
    already in the cache.  Returns (out [B,1,d], cache).

    The new key and value are written into ``cache`` in place (the
    reference returns an updated copy; in place saves a cache's worth of
    device memory per layer and step)."""
    _check_impl(c)
    length = int(length)
    k, v = cache["k"], cache["v"]
    s_max = k.shape[2]
    if not 0 <= length < s_max:
        raise ValueError(f"attention_decode: position {length} outside a "
                         f"cache of {s_max}")
    positions = torch.full((x.shape[0], 1), length, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _qkv(p, c, x, positions, sc)
    k[:, :, length:length + 1] = k_new.transpose(1, 2).to(k.dtype)
    v[:, :, length:length + 1] = v_new.transpose(1, 2).to(v.dtype)
    if c.impl == "pallas" and c.window is None:
        lengths = torch.full((x.shape[0],), length + 1, dtype=torch.int32,
                             device=x.device)
        o = DA.decode_attention(q[:, 0].contiguous(), k, v, lengths)
        o = o[:, None]
    else:
        kv_pos = torch.arange(s_max, device=x.device)
        valid = kv_pos[None, :] <= length
        if c.window is not None:
            valid &= kv_pos[None, :] > length - c.window
        cw = dataclasses.replace(c, causal=False)  # mask via `valid`
        o = _einsum_attention(q, k, v, cw, kv_valid=valid, kv_format="bksd")
    o = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return o, {"k": k, "v": v}


def attention_cache_spec(c: AttnConfig, batch: int, cache_len: int,
                         dtype=torch.bfloat16) -> Dict:
    shape = (batch, c.n_kv, cache_len, c.head_dim)
    axes = ("batch", None, "kv_seq", None)
    return {"k": ArraySpec(shape, dtype, axes, init="zeros"),
            "v": ArraySpec(shape, dtype, axes, init="zeros")}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_spec(d_model: int, d_ff: int, act: str, dtype=torch.bfloat16) -> Dict:
    p = {
        "w_in": ArraySpec((d_model, d_ff), dtype, ("embed", "mlp"),
                          init="fan_in"),
        "w_out": ArraySpec((d_ff, d_model), dtype, ("mlp", "embed"),
                           init="fan_in"),
    }
    if act == "swiglu":
        p["w_gate"] = ArraySpec((d_model, d_ff), dtype, ("embed", "mlp"),
                                init="fan_in")
    return p


def mlp(p: Dict, x: torch.Tensor, act: str, sc: ShardingCtx) -> torch.Tensor:
    h = torch.einsum("bsd,df->bsf", x, p["w_in"])
    h = sc.constrain(h, "batch", "seq", "act_mlp")
    if act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"])
        h = F.silu(g) * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    else:
        raise ValueError(act)
    return torch.einsum("bsf,fd->bsd", h, p["w_out"])


# ---------------------------------------------------------------------------
# MoE (top-k routing, capacity-bounded scatter dispatch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    act: str = "swiglu"
    capacity_factor: float = 1.25


def moe_spec(c: MoEConfig, dtype=torch.bfloat16) -> Dict:
    p = {
        "router": ArraySpec((c.d_model, c.n_experts), F32,
                            ("embed", None), init="fan_in"),
        "w_in": ArraySpec((c.n_experts, c.d_model, c.d_ff), dtype,
                          ("expert", "embed", None), init="fan_in"),
        "w_out": ArraySpec((c.n_experts, c.d_ff, c.d_model), dtype,
                           ("expert", None, "embed"), init="fan_in"),
    }
    if c.act == "swiglu":
        p["w_gate"] = ArraySpec((c.n_experts, c.d_model, c.d_ff), dtype,
                                ("expert", "embed", None), init="fan_in")
    return p


def moe_capacity(c: MoEConfig, tokens: int) -> int:
    """Slots per expert: ``ceil(T k / E * capacity_factor)`` rounded up to
    a multiple of 128, at least 128."""
    cap = math.ceil(tokens * c.top_k / c.n_experts * c.capacity_factor)
    return max((cap + 127) // 128 * 128, 128)


_ROUTES: Optional[List[Dict[str, torch.Tensor]]] = None


@contextlib.contextmanager
def recording_routes() -> Iterator[List[Dict[str, torch.Tensor]]]:
    """Every :func:`moe` call inside the block appends its routing to the
    yielded list: ``experts`` ``[T, k]`` (each token's experts, by falling
    probability) and ``kept`` ``[T, k]`` (False where the slot fell at or
    past the expert's capacity and was dropped)."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = prev


def moe(p: Dict, c: MoEConfig, x: torch.Tensor, sc: ShardingCtx
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [B,S,d], aux_loss scalar f32).

    The JAX package's mesh-less path: f32 router softmax, top-k with the
    weights renormalised, the Switch aux loss ``E * mean(f_e * P_e)`` from
    the top-1 assignment; each (token, slot) takes the next free position
    of its expert in token-major order, and positions at or past the
    capacity are dropped (they add nothing); the experts run
    as batched products over ``[E, C, d]`` in x's dtype, and the outputs
    come back weighted in f32 and summed over k.  The expert-parallel
    path (``moe_shardmap``) needs a ``model`` mesh axis over several
    cards and is not ported."""
    if sc.mesh is not None:
        raise NotImplementedError("moe over a mesh (the expert-parallel "
                                  "moe_shardmap) is not yet ported")
    b, s, d = x.shape
    t = b * s
    e, k = c.n_experts, c.top_k
    xt = x.reshape(t, d)

    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1, sorted=True)      # [t,k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    assign = F.one_hot(top_e[:, 0], e).to(F32)
    aux = e * torch.mean(assign.mean(0) * probs.mean(0))

    cap = moe_capacity(c, t)
    e_idx = top_e.reshape(t * k)
    # a slot's position: the earlier slots (token-major) of its expert, the
    # exclusive cumsum of the [t*k, e] one-hot along the slots, taken as an
    # inclusive one of its transpose less one (a scan along the last,
    # contiguous axis: along the first, the card's scan kernel took most
    # of a full-width prefill)
    onehot_t = (e_idx[None, :] == torch.arange(e, device=x.device)[:, None]
                ).to(torch.int32)                                 # [e,t*k]
    pos_sel = torch.cumsum(onehot_t, dim=1, dtype=torch.int32).gather(
        0, e_idx[None, :])[0].long() - 1                          # [t*k]
    del onehot_t
    keep = pos_sel < cap
    if _ROUTES is not None:
        _ROUTES.append({"experts": top_e.detach(),
                        "kept": keep.reshape(t, k)})

    # every slot's row added into zeros: a kept slot at (e, pos), a
    # dropped one at a spare row of its own past the E x cap buffer, so no
    # two rows meet and the buffer holds each kept row exactly.  (The
    # reference adds the dropped slots' rows as zeros at (e, cap - 1):
    # the same buffer, but the many duplicate targets serialise the
    # accumulation on the card.)
    slot = torch.arange(t * k, device=x.device)
    target = torch.where(keep, e_idx * cap + pos_sel, e * cap + slot)
    buf = torch.zeros(e * cap + t * k, d, dtype=xt.dtype,
                      device=x.device).index_put(
        (target,), xt[slot // k], accumulate=True)[:e * cap]
    buf = sc.constrain(buf.view(e, cap, d), "act_expert", "act_cap", None)

    h = torch.bmm(buf, p["w_in"])
    if c.act == "swiglu":
        g = torch.bmm(buf, p["w_gate"])
        h = F.silu(g) * h
    elif c.act == "gelu":
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    else:
        raise ValueError(c.act)
    y_e = torch.bmm(h, p["w_out"])
    y_e = sc.constrain(y_e, "act_expert", "act_cap", None)

    gathered = y_e[e_idx, torch.where(keep, pos_sel, 0)]           # [t*k,d]
    weighted = torch.where(keep[:, None], gathered.float(), 0.0) \
        * top_p.reshape(t * k, 1)
    out = weighted.reshape(t, k, d).sum(dim=1)
    return out.reshape(b, s, d).to(x.dtype), aux
