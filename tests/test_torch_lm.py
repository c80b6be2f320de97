"""The port's LM path against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
model tests carry the JAX package's weights over with
``params_from_numpy``.  The JAX kernels run in Pallas interpret mode (their
ops wrappers pick it off the TPU), the port's kernel wrappers their plain
PyTorch versions (CPU tensors).

Tolerances:
* modules with no kernel on the path, f32: rtol = atol = 1e-4 (the same
  f32 arithmetic, summed in another order);
* a kernel on the path: 2e-3 in f32, and for bf16 inputs 2e-2 (flash) and
  3e-2 (decode), as the JAX package's own kernel tests hold their kernels
  against their references.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.distributed.shardings import null_ctx as jnull_ctx
from repro.kernels.decode_attention import ops as JDA
from repro.kernels.flash_attention import ops as JFL
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.models import layers as JL
from repro.models.modeling import Model as JModel
from repro_torch.configs import get
from repro_torch.data import tokenizer
from repro_torch.kernels.decode_attention import kernel as DA
from repro_torch.kernels.flash_attention import kernel as FL
from repro_torch.launch import serve_llm
from repro_torch.models import layers as L
from repro_torch.models import param as PM
from repro_torch.models.modeling import Model

MODULE_TOL = 1e-4
KERNEL_TOL = {("flash", "f32"): 2e-3, ("flash", "bf16"): 2e-2,
              ("decode", "f32"): 2e-3, ("decode", "bf16"): 3e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _t(x):
    return np.asarray(torch.as_tensor(x).float(), np.float64)


def _pair(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.as_tensor(a).to(td)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_t(got), _np(want), rtol=tol, atol=tol,
                               err_msg=msg)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,hkv,s,d", [
    (1, 2, 1, 128, 64), (2, 2, 2, 96, 32), (1, 4, 4, 64, 16),
    (1, 8, 2, 128, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_attention_matches_jax(b, h, hkv, s, d, causal, dtype):
    rng = np.random.default_rng(b * 1000 + h * 100 + s + d)
    jq, tq = _pair(rng, (b, h, s, d), dtype)
    jk, tk = _pair(rng, (b, hkv, s, d), dtype)
    jv, tv = _pair(rng, (b, hkv, s, d), dtype)
    want = JFL.flash_attention(jq, jk, jv, causal=causal)
    got = FL.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == DTYPES[dtype][1] and got.shape == tq.shape
    _close(got, want, KERNEL_TOL[("flash", dtype)])


@pytest.mark.parametrize("b,h,hkv,s,d", [
    (2, 8, 2, 1024, 64), (1, 16, 8, 512, 64), (3, 6, 3, 96, 32)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_matches_jax(b, h, hkv, s, d, dtype):
    rng = np.random.default_rng(b * 1000 + h * 100 + s + d)
    jq, tq = _pair(rng, (b, h, d), dtype)
    jk, tk = _pair(rng, (b, hkv, s, d), dtype)
    jv, tv = _pair(rng, (b, hkv, s, d), dtype)
    lens = rng.integers(1, s + 1, b).astype(np.int32)
    want = JDA.decode_attention(jq, jk, jv, jnp.asarray(lens))
    got = DA.decode_attention(tq, tk, tv, torch.as_tensor(lens))
    _close(got, want, KERNEL_TOL[("decode", dtype)])


def test_decode_attention_length_masking():
    """Cache rows at or beyond `length` must not contribute (the JAX
    package's own masking test, on the port)."""
    rng = np.random.default_rng(7)
    b, h, hkv, s, d = 1, 2, 1, 256, 32
    _, q = _pair(rng, (b, h, d), "f32")
    _, k = _pair(rng, (b, hkv, s, d), "f32")
    _, v = _pair(rng, (b, hkv, s, d), "f32")
    lens = torch.tensor([64], dtype=torch.int32)
    short = DA.decode_attention(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 64:] = 99.0
    v2[:, :, 64:] = -99.0
    torch.testing.assert_close(DA.decode_attention(q, k2, v2, lens), short,
                               rtol=1e-6, atol=0)


def test_decode_attention_length_zero_is_the_mean_of_v():
    rng = np.random.default_rng(8)
    b, h, hkv, s, d = 2, 4, 2, 96, 32
    jq, tq = _pair(rng, (b, h, d), "f32")
    jk, tk = _pair(rng, (b, hkv, s, d), "f32")
    jv, tv = _pair(rng, (b, hkv, s, d), "f32")
    lens = np.array([0, 5], np.int32)
    got = DA.decode_attention(tq, tk, tv, torch.as_tensor(lens))
    want = JDA.decode_attention(jq, jk, jv, jnp.asarray(lens))
    _close(got, want, KERNEL_TOL[("decode", "f32")])
    mean = tv[0].mean(1).repeat_interleave(h // hkv, 0)
    torch.testing.assert_close(got[0], mean, rtol=1e-5, atol=1e-5)


def test_flash_matches_model_blockwise():
    """Kernel path == the port's own blockwise path (as the JAX package's
    test_flash_matches_model_attention)."""
    rng = np.random.default_rng(9)
    b, h, hkv, s, d = 1, 4, 2, 256, 64
    _, q = _pair(rng, (b, s, h, d), "f32")
    _, k = _pair(rng, (b, s, hkv, d), "f32")
    _, v = _pair(rng, (b, s, hkv, d), "f32")
    cfg = L.AttnConfig(d_model=h * d, n_heads=h, n_kv=hkv, head_dim=d,
                       causal=True, block_q=64, block_k=64)
    lax_out = L._blockwise_attention(q, k, v, cfg)
    kern = FL.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous())
    torch.testing.assert_close(kern.transpose(1, 2), lax_out, rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 5)])
def test_blockwise_attention_small_blocks_matches_jax(causal, window):
    rng = np.random.default_rng(10)
    b, h, hkv, s, d = 2, 4, 2, 32, 16
    jq, tq = _pair(rng, (b, s, h, d), "f32")
    jk, tk = _pair(rng, (b, s, hkv, d), "f32")
    jv, tv = _pair(rng, (b, s, hkv, d), "f32")
    kw = dict(d_model=h * d, n_heads=h, n_kv=hkv, head_dim=d, causal=causal,
              window=window, block_q=8, block_k=4)
    want = JL._blockwise_attention(jq, jk, jv, JL.AttnConfig(**kw))
    got = L._blockwise_attention(tq, tk, tv, L.AttnConfig(**kw))
    _close(got, want, MODULE_TOL)
    want = JL._einsum_attention(jq, jk, jv, JL.AttnConfig(**kw))
    _close(L._einsum_attention(tq, tk, tv, L.AttnConfig(**kw)), want,
           MODULE_TOL)


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 12, 4, 32)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32) * 37, (2, 12))
    want = JL.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    got = L.rms_norm({"scale": torch.as_tensor(scale)}, torch.as_tensor(x))
    _close(got, want, MODULE_TOL)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = L.rope(torch.as_tensor(x), torch.as_tensor(pos.copy()), 1e6)
    _close(got, want, MODULE_TOL)


# ---------------------------------------------------------------------------
# the model, with the JAX package's weights carried over
# ---------------------------------------------------------------------------


def _cfgs(impl):
    jcfg = dataclasses.replace(jget("qwen3-0.6b").reduced(), attn_impl=impl)
    cfg = dataclasses.replace(get("qwen3-0.6b").reduced(), attn_impl=impl)
    return jcfg, cfg


@pytest.fixture(scope="module")
def jax_weights():
    jcfg, _ = _cfgs("einsum")
    params = JModel(jcfg).init(jax.random.PRNGKey(3))
    return params, jax.tree.map(np.asarray, params)


def _models(impl, jax_weights):
    jcfg, cfg = _cfgs(impl)
    jparams, tree = jax_weights
    model = Model(cfg, device="cpu")
    return JModel(jcfg), jparams, model, model.params_from_numpy(tree)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _model_tol(impl):
    return KERNEL_TOL[("flash", "f32")] if impl == "pallas" else MODULE_TOL


def test_carried_weights_are_the_jax_weights(jax_weights):
    _, _, model, params = _models("einsum", jax_weights)
    _, tree = jax_weights
    got = dict(PM.tree_items(params))
    for path, a in PM.tree_items(tree):
        np.testing.assert_array_equal(got[path].numpy(), a)
    assert model.n_params() == sum(a.size for _, a in PM.tree_items(tree))


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_forward_matches_jax(impl, jax_weights):
    jm, jparams, m, params = _models(impl, jax_weights)
    toks = _tokens(0, (2, 16), m.cfg.vocab)
    want, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = m.forward(params, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, 16, m.cfg.padded_vocab)
    assert float(aux) == 0.0
    _close(got, want, _model_tol(impl))


def test_forward_pallas_counts_one_flash_call_per_layer(jax_weights):
    _, _, m, params = _models("pallas", jax_weights)
    calls = []
    orig = FL.flash_attention_core_plain
    FL.flash_attention_core_plain = lambda *a, **k: calls.append(1) or \
        orig(*a, **k)
    try:
        m.forward(params, {"tokens": torch.as_tensor(
            _tokens(1, (2, 8), m.cfg.vocab))})
    finally:
        FL.flash_attention_core_plain = orig
    assert len(calls) == m.cfg.n_layers
    assert FL.launches == 0      # CPU tensors never launch the kernel


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_lm_loss_matches_jax(impl, jax_weights):
    jm, jparams, m, params = _models(impl, jax_weights)
    toks = _tokens(2, (2, 16), m.cfg.vocab)
    labels = _tokens(3, (2, 16), m.cfg.vocab)
    labels[0, :5] = -1
    want, wm = jm.loss(jparams, {"tokens": jnp.asarray(toks),
                                 "labels": jnp.asarray(labels)})
    got, gm = m.loss(params, {"tokens": torch.as_tensor(toks),
                              "labels": torch.as_tensor(labels)})
    tol = _model_tol(impl)
    _close(got, want, tol)
    _close(gm["nll"], wm["nll"], tol)
    assert float(gm["tokens"]) == float(wm["tokens"]) == 27.0


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_prefill_and_decode_steps_match_jax(impl, jax_weights):
    """Prefill 8 tokens into a 16-slot cache, then 8 decode steps: logits
    and caches after each step against the JAX package's."""
    jm, jparams, m, params = _models(impl, jax_weights)
    toks = _tokens(4, (2, 16), m.cfg.vocab)
    tol = _model_tol(impl)
    jlg, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :8])},
                         cache_len=16)
    lg, c = m.prefill(params, {"tokens": torch.as_tensor(toks[:, :8])},
                      cache_len=16)
    _close(lg, jlg, tol, "prefill logits")
    for key in ("k", "v"):
        assert c["layers"][key].shape == jc["layers"][key].shape
        _close(c["layers"][key], jc["layers"][key], tol, f"prefill {key}")
    dtol = max(tol, KERNEL_TOL[("decode", "f32")]) if impl == "pallas" \
        else tol
    for i in range(8, 16):
        jlg, jc = jm.decode_step(jparams, jnp.asarray(toks[:, i]), jc,
                                 jnp.int32(i))
        lg, c = m.decode_step(params, torch.as_tensor(toks[:, i]), c, i)
        _close(lg, jlg, dtol, f"decode logits {i}")
        for key in ("k", "v"):
            _close(c["layers"][key], jc["layers"][key], dtol,
                   f"decode {key} {i}")


def test_decode_matches_forward(jax_weights):
    """Prefill + decode over a split equals the full forward (the JAX
    package's test_decode_matches_forward, on the port with kernels)."""
    _, _, m, params = _models("pallas", jax_weights)
    toks = torch.as_tensor(_tokens(5, (2, 16), m.cfg.vocab))
    full, _ = m.forward(params, {"tokens": toks})
    lg, caches = m.prefill(params, {"tokens": toks[:, :8]}, cache_len=16)
    torch.testing.assert_close(lg, full[:, 7].float(), rtol=5e-3, atol=5e-3)
    for i in range(8, 16):
        lg, caches = m.decode_step(params, toks[:, i], caches, i)
        torch.testing.assert_close(lg, full[:, i].float(), rtol=2e-2,
                                   atol=2e-2)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _jax_greedy(jcfg, jparams, prompts, gen):
    jm = JModel(jcfg)
    sc = jnull_ctx()
    prompt_len = prompts.shape[1]
    prefill = jax.jit(jmake_prefill_step(jm, sc, prompt_len + gen))
    decode = jax.jit(jmake_decode_step(jm, sc))
    logits, caches = prefill(jparams, {"tokens": jnp.asarray(prompts)})
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    out = []
    for i in range(gen):
        out.append(np.asarray(tok))
        logits, caches = decode(jparams, tok, caches,
                                jnp.int32(prompt_len + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    return np.stack(out, 1)


def test_synthetic_prompts_are_the_reference_prompts():
    from repro.data import tokenizer as jtok
    got = serve_llm.synthetic_prompts(4, 40, 512)
    ids = [np.minimum(jtok.encode(f"request {i}: the quick brown fox"),
                      511) for i in range(4)]
    want = np.stack([np.pad(a, (0, 40 - len(a))) for a in ids])
    np.testing.assert_array_equal(got, want)
    assert (tokenizer.encode("x") == jtok.encode("x")).all()


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_generate_matches_jax_greedy(impl, jax_weights):
    jcfg, _ = _cfgs("einsum")
    jparams, tree = jax_weights
    cfg = get("qwen3-0.6b").reduced()
    params = Model(cfg, device="cpu").params_from_numpy(tree)
    out = serve_llm.generate(batch=4, prompt_len=24, gen=8, device="cpu",
                             params=params, attn_impl=impl)
    prompts = serve_llm.synthetic_prompts(4, 24, cfg.vocab)
    want = _jax_greedy(jcfg, jparams, prompts, 8)
    assert out["completions"].shape == (4, 8)
    np.testing.assert_array_equal(out["completions"], want)
    st = out["stats"]
    assert st.tokens == 32 and st.prefill_s > 0 and st.decode_s > 0


def test_generate_returns_the_step_logits(jax_weights):
    _, tree = jax_weights
    cfg = get("qwen3-0.6b").reduced()
    params = Model(cfg, device="cpu").params_from_numpy(tree)
    out = serve_llm.generate(batch=2, prompt_len=8, gen=3, device="cpu",
                             params=params, return_logits=True)
    assert out["prefill_logits"].shape == (2, cfg.padded_vocab)
    assert out["decode_logits"].shape == (2, 3, cfg.padded_vocab)
    np.testing.assert_array_equal(
        out["decode_logits"][:, :-1].argmax(-1).numpy(),
        out["completions"][:, 1:])


def test_serve_cli_full_flag_turns_reduced_off(monkeypatch):
    seen = {}
    monkeypatch.setattr(serve_llm, "generate",
                        lambda *a, **k: seen.setdefault("a", (a, k)) and
                        {"stats": serve_llm.ServeStats(1, 1, 1),
                         "completions": np.zeros((1, 1), int)})
    serve_llm.main(["--full", "--device", "cpu"])
    assert seen["a"][0][1] is False
    seen.clear()
    serve_llm.main(["--device", "cpu"])
    assert seen["a"][0][1] is True


# ---------------------------------------------------------------------------
# carry-over, registry and device policy
# ---------------------------------------------------------------------------


def test_params_from_numpy_refuses_a_tree_that_does_not_fit(jax_weights):
    _, tree = jax_weights
    m = Model(get("qwen3-0.6b").reduced(), device="cpu")
    missing = jax.tree.map(lambda a: a, tree)
    del missing["layers"]["attn"]["wq"]
    with pytest.raises(ValueError, match="missing leaves.*wq"):
        m.params_from_numpy(missing)
    extra = jax.tree.map(lambda a: a, tree)
    extra["layers"]["attn"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="left-over leaves.*bias"):
        m.params_from_numpy(extra)
    wrong = jax.tree.map(lambda a: a, tree)
    wrong["head"] = wrong["head"][:, :-1]
    with pytest.raises(ValueError, match="head has shape"):
        m.params_from_numpy(wrong)


def test_cast_compute_casts_only_matrices():
    tree = {"w": torch.ones(2, 3), "s": torch.ones(3),
            "i": torch.ones(2, 2, dtype=torch.int32)}
    out = PM.cast_compute(tree, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16
    assert out["s"].dtype == torch.float32 and out["i"].dtype == torch.int32


def test_registry_and_device_policy():
    cfg = get("qwen3-0.6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_ff,
            cfg.vocab, cfg.head_dim_) == (28, 1024, 16, 8, 3072, 151936, 64)
    assert cfg.compute_dtype == torch.bfloat16
    assert Model(cfg, device="cpu").n_params() == JModel(
        jget("qwen3-0.6b")).n_params()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        get("mamba2-130m")
    with pytest.raises(KeyError):
        get("no-such-arch")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        Model(dataclasses.replace(cfg, family="moe"), device="cpu")
    with pytest.raises(NotImplementedError):
        L.attention({}, L.AttnConfig(8, 2, 1, 4, impl="splash"),
                    torch.zeros(1, 2, 8), torch.zeros(1, 2), None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Model(cfg)


def test_params_from_numpy_takes_bf16_leaves(jax_weights):
    _, tree = jax_weights
    m = Model(get("qwen3-0.6b").reduced(), device="cpu")
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                      tree)
    params = m.params_from_numpy(bf)
    got = params["layers"]["attn"]["wq"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(bf["layers"]["attn"]["wq"], np.float32))


def test_attention_units_are_fixed_sources():
    """The attention kernels build as fixed units (one csrc file each,
    with the suite's flags) whose C entry points the wrappers call; their
    inner products fuse by calling ``fmaf``, which ``--fmad=false`` keeps."""
    from repro_torch.kernels import cuda_build as CB
    assert "--fmad=false" in CB.NVCC_FLAGS
    for name, entry in (("flash_attention.cuh", "flare_flash_attention"),
                        ("decode_attention.cuh", "flare_decode_attention")):
        src = CB.fixed_unit(name)
        assert f'extern "C" int {entry}(' in src
        assert "flare_row" not in src          # no generated body
        assert src.count("fmaf(") >= 2
        assert CB.library_path(src).parent == CB.BUILD_DIR

