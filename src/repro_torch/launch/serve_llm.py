"""Serving CLI: batched prefill + greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve_llm --arch qwen3-0.6b \
        --batch 4 --prompt-len 32 --gen 16             # reduced config
    PYTHONPATH=src python -m repro_torch.launch.serve_llm --full \
        --attn-impl pallas --batch 8 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve_llm --full \
        --arch olmoe-1b-7b --attn-impl pallas --batch 8 --prompt-len 2048
    PYTHONPATH=src python -m repro_torch.launch.serve_llm --full \
        --arch seamless-m4t-large-v2 --attn-impl pallas --batch 8 \
        --prompt-len 2048 --gen 32

The same synthetic prompts and greedy loop as the JAX package's
``serve_llm``, for every ported ``--arch``.  The modality frontends are
stubs in both packages, and where the JAX package feeds zeros this one
feeds seeded normals at the token embeddings' scale: a vision config's
prompts follow its ``frontend_len`` patch embeddings
(:func:`vision_prefix`), and decoding starts after prefix and prompt; an
encdec config encodes ``enc_len_of(prompt_len)`` frame embeddings
(:func:`audio_frames`).  Zero frames would make the encoder's output
zero after its first RMSNorm, and with it the cross attention's values:
neither would reach the completions.  It runs on the GPU unless
``device="cpu"`` is passed.  Unlike the reference's ``--reduced``, which
cannot be turned off, ``--full`` serves the full-width config.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get
from repro_torch.data import tokenizer
from repro_torch.distributed.shardings import null_ctx
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import param as PM
from repro_torch.models.modeling import Model, enc_len_of


@dataclasses.dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    tokens: int = 0

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / max(self.decode_s, 1e-9)


def synthetic_prompts(batch: int, prompt_len: int, vocab: int) -> np.ndarray:
    """Byte-tokenizer ids of "request i: ...", clipped to the vocab and
    right-padded with 0 to ``prompt_len``."""
    prompts = np.minimum(
        np.stack([tokenizer.encode(f"request {i}: the quick brown fox")
                  [:prompt_len] for i in range(batch)]),
        vocab - 1)
    if prompts.shape[1] < prompt_len:
        prompts = np.pad(prompts,
                         ((0, 0), (0, prompt_len - prompts.shape[1])))
    return prompts


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


#: std of the seeded vision prefix: the token embeddings' init scale
PREFIX_STD = 0.02


def _seeded_embeds(cfg, batch: int, rows: int, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(batch, rows, cfg.d_model, generator=gen,
                    device=device) * PREFIX_STD
    return x.to(cfg.compute_dtype)


def vision_prefix(cfg, batch: int, seed: int, device) -> torch.Tensor:
    """A seeded stand-in for ``batch`` images' patch embeddings
    ``[B, frontend_len, d_model]`` in the compute dtype."""
    return _seeded_embeds(cfg, batch, cfg.frontend_len, seed, device)


def audio_frames(cfg, batch: int, enc_len: int, seed: int,
                 device) -> torch.Tensor:
    """A seeded stand-in for ``batch`` utterances' frame embeddings
    ``[B, enc_len, d_model]`` in the compute dtype."""
    return _seeded_embeds(cfg, batch, enc_len, seed, device)


def generate(arch: str = "qwen3-0.6b", reduced: bool = True,
             batch: int = 4, prompt_len: int = 32, gen: int = 16,
             seed: int = 0, greedy: bool = True, *, device="cuda",
             params: Optional[Dict] = None, attn_impl: Optional[str] = None,
             return_logits: bool = False, n_layers: Optional[int] = None
             ) -> Dict:
    """Prefill ``batch`` synthetic prompts and decode ``gen`` tokens
    greedily.  ``params`` (e.g. carried over from the JAX package) replace
    the weights drawn from ``seed``; ``attn_impl`` overrides the config's,
    ``n_layers`` its depth (not an encdec config's: it names neither the
    encoder's nor the decoder's).  A vision config's prompts follow
    :func:`vision_prefix` of ``seed + 1``; an encdec config encodes
    :func:`audio_frames` of ``seed + 1``.
    Returns ``completions`` [B, gen], ``stats`` and, with
    ``return_logits``, ``prefill_logits`` [B, V] and ``decode_logits``
    [B, gen, V] (f32)."""
    if not greedy:
        raise NotImplementedError("only greedy decoding is ported")
    cfg = get(arch)
    if reduced:
        cfg = cfg.reduced()
    if attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    if n_layers is not None:
        if cfg.family == "encdec":
            raise ValueError(f"{cfg.name}: n_layers names no encoder or "
                             f"decoder depth (enc_layers, dec_layers)")
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    sc = null_ctx()
    model = Model(cfg, device)
    dev = model.device
    if params is None:
        params = model.init(seed)
    # the working-precision copy once, not once per step (each step's own
    # cast is then a no-op)
    params = PM.cast_compute(params, cfg.compute_dtype)

    prompts = synthetic_prompts(batch, prompt_len, cfg.vocab)
    pf_batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64,
                                          device=dev)}
    base = prompt_len
    if cfg.frontend == "vision":
        pf_batch["prefix"] = vision_prefix(cfg, batch, seed + 1, dev)
        base += cfg.frontend_len
    if cfg.family == "encdec":
        pf_batch["enc_embeds"] = audio_frames(
            cfg, batch, enc_len_of(cfg, prompt_len), seed + 1, dev)
    cache_len = base + gen
    prefill = make_prefill_step(model, sc, cache_len)
    decode = make_decode_step(model, sc)

    stats = ServeStats()
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(params, pf_batch)
    _sync(dev)
    stats.prefill_s = time.perf_counter() - t0
    prefill_logits = logits
    out_tokens, step_logits = [], []
    tok = torch.argmax(logits, -1)
    t0 = time.perf_counter()
    for i in range(gen):
        out_tokens.append(tok)
        logits, caches = decode(params, tok, caches, base + i)
        if return_logits:
            step_logits.append(logits)
        tok = torch.argmax(logits, -1)
    _sync(dev)
    stats.decode_s = time.perf_counter() - t0
    stats.tokens = gen * batch
    out = {"completions": torch.stack(out_tokens, 1).cpu().numpy(),
           "stats": stats}
    if return_logits:
        out["prefill_logits"] = prefill_logits
        out["decode_logits"] = torch.stack(step_logits, 1)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="the reduced smoke config (the default)")
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the full-width config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn-impl", default=None,
                    help="override the config's attention impl "
                         "(einsum, blockwise, pallas)")
    args = ap.parse_args(argv)
    out = generate(args.arch, args.reduced, args.batch, args.prompt_len,
                   args.gen, device=args.device,
                   attn_impl=args.attn_impl)
    st = out["stats"]
    print(f"[serve] prefill {st.prefill_s*1e3:.1f}ms, decode "
          f"{st.decode_s*1e3:.1f}ms, {st.tokens_per_s:.1f} tok/s")
    print(f"[serve] sample completion ids: {out['completions'][0][:12]}")


if __name__ == "__main__":
    main()
