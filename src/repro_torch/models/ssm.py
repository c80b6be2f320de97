"""Mamba2 (state-space duality) block: chunked SSD scan + decode step.

The chunked dual form of the SSD paper (arXiv:2405.21060), as in the JAX
package: the sequence is split into chunks of Q tokens; within a chunk
the recurrence is evaluated as a masked, decay-weighted quadratic form
(batched matrix products), while a small cross-chunk recurrence carries
the ``[H, P, N]`` state.  O(L) memory, O(L * Q) compute: the family that
runs ``long_500k``.

Layout: x ``[B, L, H, P]`` (heads x head channels), B/C ``[B, L, G, N]``
shared by the ``H / G`` heads of a group, a per-head scalar decay A.

Differences of form from the JAX package, none of arithmetic:

* B and C are not repeated to the heads: each product runs per group and
  its result is broadcast over the group's heads (head ``j`` reads group
  ``j // (H / G)``, as ``jnp.repeat`` lays them out);
* the four-operand intra-chunk product is contracted pairwise (C Bᵀ per
  group, times the decays, times x), never through a ``[B, C, Q, Q, H,
  N]`` tensor;
* the intra-chunk terms and the chunk states are computed over slabs of
  chunks (:data:`SLAB_ELEMS`), so that no ``[B, H, C, Q, Q]`` tensor
  outgrows a slab at ``long_500k``'s 2048 chunks; each chunk's terms
  depend on that chunk alone;
* the cross-chunk recurrence is a loop over the chunks, the
  ``lax.scan``'s own step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.shardings import ShardingCtx
from repro_torch.models.layers import rms_norm, rms_norm_spec
from repro_torch.models.param import ArraySpec

F32 = torch.float32

#: Elements of one ``[B, H, chunks, Q, Q]`` f32 tensor of a slab: the
#: intra-chunk terms take as many chunks at a time as fit (at least one).
#: 2^27 elements (512 MiB) keep the whole of a B 8 x 2048 or B 4 x 4096
#: sequence in one slab at H 24, Q 256, and cut B 1 x 524 288 into 25.
SLAB_ELEMS = 1 << 27


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    d_inner: int          # expand * d_model
    head_dim: int         # P
    n_groups: int         # G
    d_state: int          # N
    conv_kernel: int = 4
    chunk: int = 256

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def mamba2_spec(c: SSMConfig, dtype=torch.bfloat16) -> Dict:
    h = c.n_heads
    proj_out_dim = 2 * c.d_inner + 2 * c.n_groups * c.d_state + h
    return {
        "in_proj": ArraySpec((c.d_model, proj_out_dim), dtype,
                             ("embed", "rnn"), init="fan_in"),
        "conv_w": ArraySpec((c.conv_kernel, c.conv_dim), F32,
                            (None, "rnn"), init="fan_in"),
        "conv_b": ArraySpec((c.conv_dim,), F32, ("rnn",), init="zeros"),
        "A_log": ArraySpec((h,), F32, (None,), init="zeros"),
        "D": ArraySpec((h,), F32, (None,), init="ones"),
        "dt_bias": ArraySpec((h,), F32, (None,), init="zeros"),
        "norm": rms_norm_spec(c.d_inner),
        "out_proj": ArraySpec((c.d_inner, c.d_model), dtype,
                              ("rnn", "embed"), init="fan_in"),
    }


# ---------------------------------------------------------------------------
# chunked SSD
# ---------------------------------------------------------------------------


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., T] -> [..., T, T] with out[i, j] = sum_{k=j+1..i} x[k]
    (lower triangle; -inf above the diagonal), summed as the JAX package
    sums it: a cumulative sum over i of x[i] masked to j < i."""
    t = x.shape[-1]
    ones = torch.ones(t, t, dtype=torch.bool, device=x.device)
    xi = x[..., :, None].expand(x.shape + (t,))          # [..., i, j] = x_i
    contrib = torch.where(ones.tril(-1), xi, 0.0)
    out = torch.cumsum(contrib, dim=-2)
    return torch.where(ones.tril(0), out, -torch.inf)


def chunk_len(length: int, chunk: int) -> int:
    """The chunk of a sequence: ``chunk`` (at most ``length``) halved
    until it divides ``length`` -- 1 for an odd length above it."""
    q = min(chunk, length)
    while length % q:
        q //= 2
    return q


def _slabs(n_chunks: int, per_chunk: int):
    """``(start, stop)`` of each slab of chunks (:data:`SLAB_ELEMS`)."""
    step = max(1, SLAB_ELEMS // max(per_chunk, 1))
    return [(c0, min(c0 + step, n_chunks))
            for c0 in range(0, n_chunks, step)]


def ssd(x: torch.Tensor, a_dt: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space scan, in f32.

    x: [B,L,H,P] (dt already folded in), a_dt: [B,L,H] log-decay,
    b/c: [B,L,G,N]; returns (y [B,L,H,P], final_state [B,H,P,N])."""
    bsz, l, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = chunk_len(l, chunk)
    nc = l // q
    rep = h // g

    xc = x.reshape(bsz, nc, q, h, p).to(F32)
    bc = b.reshape(bsz, nc, q, g, n).to(F32)
    cc = c.reshape(bsz, nc, q, g, n).to(F32)
    ac = a_dt.reshape(bsz, nc, q, h).permute(0, 3, 1, 2).to(F32)  # [b,h,c,q]
    a_cs = torch.cumsum(ac, dim=-1)                                 # [b,h,c,q]
    slabs = _slabs(nc, bsz * h * q * q)

    # chunk state contributions: states[c] = sum_q exp(a_cs[-1] - a_cs[q])
    # B[q] x[q]
    states = []
    for c0, c1 in slabs:
        decay = torch.exp(a_cs[:, :, c0:c1, -1:] - a_cs[:, :, c0:c1])
        xd = xc[:, c0:c1] * decay.permute(0, 2, 3, 1)[..., None]
        states.append(torch.einsum(
            "bcqgrp,bcqgn->bcgrpn",
            xd.reshape(bsz, c1 - c0, q, g, rep, p),
            bc[:, c0:c1]).reshape(bsz, c1 - c0, h, p, n))
        del decay, xd
    states = torch.cat(states, 1) if len(states) > 1 else states[0]

    # cross-chunk recurrence: S_c = exp(sum a_c) S_{c-1} + states_c; each
    # chunk reads the state entering it
    chunk_decay = torch.exp(a_cs[..., -1])                          # [b,h,c]
    carry = (torch.zeros(bsz, h, p, n, dtype=F32, device=x.device)
             if h0 is None else h0.to(F32))
    entering = []
    for ci in range(nc):
        entering.append(carry)
        carry = carry * chunk_decay[:, :, ci, None, None] + states[:, ci]
    del states
    entering = torch.stack(entering, 1)                             # [b,c,h,p,n]

    # each chunk's output: the intra-chunk quadratic form plus the
    # entering state read through C
    ys = []
    for c0, c1 in slabs:
        cs = c1 - c0
        l_mat = torch.exp(_segsum(ac[:, :, c0:c1]))                 # [b,h,c,q,s]
        cb = torch.einsum("bcqgn,bcsgn->bgcqs", cc[:, c0:c1], bc[:, c0:c1])
        m = (l_mat.view(bsz, g, rep, cs, q, q) * cb[:, :, None]).reshape(
            bsz, h, cs, q, q)
        del l_mat, cb
        y_diag = torch.einsum("bhcqs,bcshp->bcqhp", m, xc[:, c0:c1])
        del m
        y_off = torch.einsum(
            "bcqgn,bcgrpn->bcqgrp", cc[:, c0:c1],
            entering[:, c0:c1].reshape(bsz, cs, g, rep, p, n)).reshape(
            bsz, cs, q, h, p)
        state_decay = torch.exp(a_cs[:, :, c0:c1]).permute(0, 2, 3, 1)
        ys.append(y_diag + y_off * state_decay[..., None])
        del y_diag, y_off, state_decay
    y = torch.cat(ys, 1) if len(ys) > 1 else ys[0]
    return y.reshape(bsz, l, h, p), carry


# ---------------------------------------------------------------------------
# full block
# ---------------------------------------------------------------------------


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv via K shifted adds. x: [B,L,C]; w: [K,C].
    The shifted rows' leading zeros are left out of the sums: adding
    ``0 * w`` changes no value."""
    k = w.shape[0]
    out = x * w[-1]
    for i in range(1, min(k, x.shape[1])):
        out[:, i:] += x[:, :-i] * w[k - 1 - i]
    return out + b


def _split_proj(c: SSMConfig, zxbcdt: torch.Tensor):
    di, gn = c.d_inner, c.n_groups * c.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    return z, xbc, dt


def mamba2_block(p: Dict, c: SSMConfig, u: torch.Tensor, sc: ShardingCtx,
                 h0: Optional[torch.Tensor] = None,
                 return_state: bool = False):
    """Full-sequence Mamba2 mixer. u: [B,L,d_model] -> [B,L,d_model]."""
    bsz, l, _ = u.shape
    zxbcdt = sc.constrain(u @ p["in_proj"], "batch", "seq", "act_mlp")
    z, xbc, dt = _split_proj(c, zxbcdt)
    xbc = F.silu(_causal_conv(xbc.to(F32), p["conv_w"], p["conv_b"]))
    gn = c.n_groups * c.d_state
    x = xbc[..., :c.d_inner]
    b = xbc[..., c.d_inner:c.d_inner + gn]
    cc = xbc[..., c.d_inner + gn:]
    h = c.n_heads
    dt = F.softplus(dt.to(F32) + p["dt_bias"])                      # [B,L,H]
    a = -torch.exp(p["A_log"])                                      # [H]
    xh = x.reshape(bsz, l, h, c.head_dim)
    y, state = ssd(xh * dt[..., None], a * dt,
                   b.reshape(bsz, l, c.n_groups, c.d_state),
                   cc.reshape(bsz, l, c.n_groups, c.d_state),
                   c.chunk, h0)
    y = y + xh * p["D"][:, None]
    y = y.reshape(bsz, l, c.d_inner)
    y = rms_norm(p["norm"], y * F.silu(z.to(F32)))
    out = y.to(u.dtype) @ p["out_proj"]
    if return_state:
        return out, state
    return out


def mamba2_cache_spec(c: SSMConfig, batch: int) -> Dict:
    return {
        "state": ArraySpec((batch, c.n_heads, c.head_dim, c.d_state), F32,
                           ("batch", None, None, None), init="zeros"),
        "conv": ArraySpec((batch, c.conv_kernel - 1, c.conv_dim), F32,
                          ("batch", None, None), init="zeros"),
    }


def mamba2_step(p: Dict, c: SSMConfig, u: torch.Tensor, cache: Dict,
                sc: ShardingCtx) -> Tuple[torch.Tensor, Dict]:
    """One decode step. u: [B,1,d_model] -> ([B,1,d_model], new cache)."""
    bsz = u.shape[0]
    zxbcdt = (u @ p["in_proj"])[:, 0]
    z, xbc, dt = _split_proj(c, zxbcdt)
    # conv over [cache ; new]
    conv_in = torch.cat([cache["conv"], xbc.to(F32)[:, None]], dim=1)
    # the conv weight may come in the compute dtype (a stacked leaf of
    # ``cast_compute``); the product runs in f32, as the JAX package's
    # promotion runs it
    xbc_c = F.silu(torch.einsum("bkc,kc->bc", conv_in, p["conv_w"].to(F32))
                   + p["conv_b"])
    new_conv = conv_in[:, 1:]
    gn = c.n_groups * c.d_state
    x = xbc_c[..., :c.d_inner]
    b = xbc_c[..., c.d_inner:c.d_inner + gn].reshape(
        bsz, c.n_groups, c.d_state)
    cc = xbc_c[..., c.d_inner + gn:].reshape(bsz, c.n_groups, c.d_state)
    h = c.n_heads
    rep = h // c.n_groups
    dt = F.softplus(dt.to(F32) + p["dt_bias"])                      # [B,H]
    a = -torch.exp(p["A_log"])
    decay = torch.exp(a * dt)                                       # [B,H]
    xh = x.reshape(bsz, h, c.head_dim)
    bh = b.repeat_interleave(rep, dim=1)                            # [B,H,N]
    ch = cc.repeat_interleave(rep, dim=1)
    state = (cache["state"] * decay[..., None, None]
             + torch.einsum("bhp,bhn->bhpn", xh * dt[..., None], bh))
    y = torch.einsum("bhpn,bhn->bhp", state, ch) + xh * p["D"][:, None]
    y = y.reshape(bsz, c.d_inner)
    y = rms_norm(p["norm"], y * F.silu(z.to(F32)))
    out = y.to(u.dtype) @ p["out_proj"]
    return out[:, None], {"state": state, "conv": new_conv}
