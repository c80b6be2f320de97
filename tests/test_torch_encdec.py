"""The port's encdec family against the JAX package, on the CPU.

The reduced ``seamless-m4t-large-v2`` (1 encoder and 1 decoder layer, d
128, 4 query heads over 2 KV heads, f32) through ``encode``, ``forward``,
``lm_loss``, ``prefill`` (its self and cross caches), ``decode_step`` and
greedy serving, under ``attn_impl`` ``einsum`` and ``pallas``: the JAX
package runs its flash kernel in Pallas interpret mode, the port the
kernels' plain versions (CPU tensors).  Inputs are made with numpy from
a seed; the JAX package's weights are carried over with
``params_from_numpy``.  Tolerance: rtol = atol = 1e-4 throughout (the
same f32 arithmetic, summed in another order).

The packages are imported inside the fixture, not while the file is
collected, so that collecting it allocates little.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

ARCH = "seamless-m4t-large-v2"
TOL = 1e-4
IMPLS = ["einsum", "pallas"]


@pytest.fixture(scope="module")
def pk():
    """Both packages' modules, and the JAX package's reduced weights."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get as jget
    from repro.distributed.shardings import null_ctx as jnull_ctx
    from repro.models import encdec as JED
    from repro.models.modeling import Model as JModel
    from repro_torch.configs import get
    from repro_torch.distributed import shardings as SH
    from repro_torch.distributed.shardings import null_ctx
    from repro_torch.launch import serve_llm
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import encdec as ED
    from repro_torch.models import param as PM
    from repro_torch.models.modeling import Model, enc_len_of
    jparams = JModel(jget(ARCH).reduced()).init(jax.random.PRNGKey(21))
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, jget=jget, jnull_ctx=jnull_ctx, JED=JED,
        JModel=JModel, get=get, null_ctx=null_ctx, serve_llm=serve_llm,
        ST=ST, SH=SH, Mesh=Mesh, ED=ED, PM=PM, Model=Model, enc_len_of=enc_len_of,
        jparams=jparams, tree=jax.tree.map(np.asarray, jparams))


def _models(pk, impl):
    jcfg = dataclasses.replace(pk.jget(ARCH).reduced(), attn_impl=impl)
    cfg = dataclasses.replace(pk.get(ARCH).reduced(), attn_impl=impl)
    model = pk.Model(cfg, device="cpu")
    return jcfg, cfg, pk.JModel(jcfg), model, model.params_from_numpy(
        pk.tree)


def _batch(cfg, seed, b=2, s_dec=12, s_enc=8, labels=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s_dec)).astype(np.int32),
           "enc_embeds": rng.standard_normal(
               (b, s_enc, cfg.d_model)).astype(np.float32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (b, s_dec)).astype(
            np.int32)
        out["labels"][:, -2:] = -1
    return out


def _j(pk, batch):
    return {k: pk.jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close(got, want, msg=""):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL, err_msg=msg)


def _close_trees(pk, got, want):
    want = dict(pk.PM.tree_items(pk.jax.tree.map(np.asarray, want)))
    got = dict(pk.PM.tree_items(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        _close(got[path], w, "/".join(path))


@pytest.mark.parametrize("s_enc", [8, 9, 17])
@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_jax(pk, impl, s_enc):
    jcfg, cfg, _, _, params = _models(pk, impl)
    enc = _batch(cfg, 30 + s_enc, s_enc=s_enc)["enc_embeds"]
    want = pk.JED.encode(jcfg, pk.jparams, pk.jnp.asarray(enc),
                         pk.jnull_ctx())
    got = pk.ED.encode(cfg, params, torch.as_tensor(enc), pk.null_ctx())
    assert tuple(got.shape) == (2, s_enc, cfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("s_enc", [8, 9, 17])
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_loss_match_jax(pk, impl, s_enc):
    _, cfg, jm, model, params = _models(pk, impl)
    batch = _batch(cfg, 40 + s_enc, s_enc=s_enc, labels=True)
    want, jaux = jm.forward(pk.jparams, _j(pk, batch))
    got, aux = model.forward(params, _t(batch))
    assert tuple(got.shape) == (2, 12, cfg.padded_vocab)
    assert float(aux) == float(jaux) == 0.0
    _close(got, want)
    jloss, jmet = jm.loss(pk.jparams, _j(pk, batch))
    with torch.no_grad():
        loss, met = model.loss(params, _t(batch))
    _close(loss, jloss)
    for key in ("nll", "aux", "tokens"):
        _close(met[key], jmet[key], key)


@pytest.mark.parametrize("s_enc", [8, 9, 17])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode_match_jax(pk, impl, s_enc):
    """Prefill's logits and caches (self K/V over cache_len positions,
    cross K/V at the encoder's own length), then three decode steps'
    logits and caches."""
    _, cfg, jm, model, params = _models(pk, impl)
    batch = _batch(cfg, 50 + s_enc, s_enc=s_enc)
    s_dec, gen = 12, 3
    cache_len = s_dec + gen
    jlogits, jcaches = jm.prefill(pk.jparams, _j(pk, batch),
                                  cache_len=cache_len)
    logits, caches = model.prefill(params, _t(batch), cache_len=cache_len)
    _close(logits, jlogits)
    _close_trees(pk, caches, jcaches)
    cross = caches["layers"]["cross"]["k"]
    assert tuple(cross.shape) == (cfg.dec_layers, 2, cfg.n_kv, s_enc,
                                  cfg.head_dim_)
    for i in range(gen):
        tok = np.asarray(pk.jnp.argmax(jlogits, -1)).astype(np.int32)
        jlogits, jcaches = jm.decode_step(pk.jparams, pk.jnp.asarray(tok),
                                          jcaches, pk.jnp.int32(s_dec + i))
        logits, caches = model.decode_step(
            params, torch.as_tensor(tok, dtype=torch.int64), caches,
            s_dec + i)
        _close(logits, jlogits, f"decode step {i}")
    _close_trees(pk, caches, jcaches)


@pytest.mark.parametrize("impl", IMPLS)
def test_generate_feeds_its_audio_frames(pk, impl):
    """Greedy serving of the reduced seamless: prefill encodes
    ``audio_frames`` of seed + 1 (``enc_len_of(prompt_len)`` frames),
    against the JAX package's steps fed the same frames (its
    ``serve_llm`` feeds zeros)."""
    _, cfg, jm, _, params = _models(pk, impl)
    prompt, gen = 40, 4
    enc_len = pk.enc_len_of(cfg, prompt)
    frames = pk.serve_llm.audio_frames(cfg, 2, enc_len, 1, "cpu")
    assert tuple(frames.shape) == (2, enc_len, cfg.d_model) == (2, 10, 128)
    out = pk.serve_llm.generate(ARCH, batch=2, prompt_len=prompt, gen=gen,
                                seed=0, device="cpu", params=params,
                                attn_impl=impl, return_logits=True)
    jb = {"tokens": pk.jnp.asarray(pk.serve_llm.synthetic_prompts(
              2, prompt, cfg.vocab)),
          "enc_embeds": pk.jnp.asarray(frames.numpy())}
    logits, caches = jm.prefill(pk.jparams, jb, cache_len=prompt + gen)
    _close(out["prefill_logits"], logits)
    want = []
    for i in range(gen):
        tok = pk.jnp.argmax(logits, -1).astype(pk.jnp.int32)
        want.append(np.asarray(tok))
        logits, caches = jm.decode_step(pk.jparams, tok, caches,
                                        pk.jnp.int32(prompt + i))
        _close(out["decode_logits"][:, i], logits, f"decode step {i}")
    np.testing.assert_array_equal(out["completions"], np.stack(want, 1))


def test_zero_and_seeded_frames_give_different_logits(pk):
    """Zero frames encode to zero (RMSNorm of 0), so the cross attention
    adds nothing; the seeded frames' logits must differ from those."""
    _, cfg, _, model, params = _models(pk, "einsum")
    batch = _t(_batch(cfg, 60))
    memory = pk.ED.encode(cfg, params, torch.zeros_like(batch["enc_embeds"]),
                          pk.null_ctx())
    assert float(memory.abs().max()) == 0.0
    seeded, _ = model.forward(params, batch)
    zero, _ = model.forward(params, dict(
        batch, enc_embeds=torch.zeros_like(batch["enc_embeds"])))
    assert float((seeded - zero).abs().max()) > 100 * TOL


def test_model_and_caches(pk):
    """``Model(cfg)`` with no device needs a card; the cache specs and
    abstract caches equal the JAX package's shapes and dtypes, the cross
    K/V at ``enc_len`` (by default ``enc_len_of(cache_len)``); the cross
    K/V's mesh axes shard only the batch; ``transformer.spec`` refuses
    an encdec config."""
    cfg, jcfg = pk.get(ARCH), pk.jget(ARCH)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pk.Model(cfg)
    model, jm = pk.Model(cfg, device="cpu"), pk.JModel(jcfg)
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for batch, cache_len, enc_len in ((8, 2080, 0), (8, 2080, 512),
                                      (1, 16, 0), (2, 40, 9)):
        want = pk.jax.tree.map(
            lambda s: (tuple(s.shape), names[np.dtype(s.dtype).name]),
            jm.abstract_caches(batch, cache_len, enc_len))
        spec = pk.PM.tree_map(lambda s: (s.shape, s.dtype),
                              model.cache_spec(batch, cache_len, enc_len))
        abstract = model.abstract_caches(batch, cache_len, enc_len)
        assert all(t.device.type == "meta"
                   for _, t in pk.PM.tree_items(abstract))
        got = pk.PM.tree_map(lambda t: (tuple(t.shape), t.dtype), abstract)
        assert dict(pk.PM.tree_items(got)) == dict(pk.PM.tree_items(want)) \
            == dict(pk.PM.tree_items(spec))
        cross = (cfg.dec_layers, batch, cfg.n_kv,
                 enc_len or pk.enc_len_of(cfg, cache_len), cfg.head_dim_)
        assert got["layers"]["cross"]["k"][0] == cross
    caches = model.init_caches(2, 40, 9)
    assert tuple(caches["layers"]["cross"]["v"].shape) == (12, 2, 16, 9, 64)
    assert float(caches["layers"]["self"]["k"].abs().sum()) == 0.0
    sc = pk.SH.make_ctx(pk.Mesh(("data", "model"), (2, 4),
                                torch.device("cpu")))
    specs = pk.ST.cache_pspecs(model, 8, 2080, sc)
    assert specs["layers"]["cross"]["k"] == (None, "data", None, None, None)
    # only ``Model`` dispatches encdec: the decoder-only module refuses it
    from repro_torch.models import transformer as TF
    with pytest.raises(NotImplementedError, match="not yet ported"):
        TF.spec(cfg)
    assert model.spec.keys() == pk.ED.spec(cfg).keys()


def test_generate_refuses_a_depth_cut(pk):
    with pytest.raises(ValueError, match="no encoder or decoder depth"):
        pk.serve_llm.generate(ARCH, batch=1, prompt_len=8, gen=1,
                              device="cpu", n_layers=1)
