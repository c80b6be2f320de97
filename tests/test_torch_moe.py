"""The port's MoE family against the JAX package, on the CPU.

``layers.moe`` (top-k routing, capacity-bounded scatter dispatch, batched
expert products) and the reduced ``olmoe-1b-7b`` (2 layers, d 128, 4
experts top-2, f32) through ``forward``, ``loss``, ``prefill``,
``decode_step``, the gradient and greedy serving.  Inputs come from a
numpy seed; the model tests carry the JAX package's weights over with
``params_from_numpy``.

Tolerances (f32 throughout):
* ``moe``'s output and aux loss: rtol 1e-5, atol 1e-6 (the same f32
  arithmetic, summed in another order); the routes are compared exactly:
  each token's experts in order, and the set of dropped (token, slot)
  pairs, which the JAX side gives through its own ``top_k`` and the
  capacity rule it states;
* gradients of ``moe``: rtol 1e-4 against ``jax.grad``, atol 1e-4 of the
  leaf's largest |g|;
* the model: rtol = atol = 1e-4 (einsum attention), 2e-3 with the
  attention kernels' plain versions (``tests/test_torch_lm.py``).

No input has tied router probabilities: ``torch.topk`` and
``jax.lax.top_k`` may order equal values differently, so each case
checks the k-th and (k+1)-th probabilities of every token differ.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.distributed.shardings import null_ctx as jnull_ctx
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.launch.steps import make_prefill_step as jmake_prefill_step
from repro.models import layers as JL
from repro.models.modeling import Model as JModel
from repro_torch.configs import get
from repro_torch.distributed.shardings import ShardingCtx, null_ctx
from repro_torch.launch import serve_llm
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.launch.train import TrainRun, train_loop
from repro_torch.models import layers as L
from repro_torch.models import param as PM
from repro_torch.models.modeling import Model
from repro_torch.optim import AdamWConfig

ARCH = "olmoe-1b-7b"
MOE_RTOL, MOE_ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4
MODEL_TOL = {"einsum": 1e-4, "pallas": 2e-3}

#: (tokens B x S, d, d_ff, experts, top-k, capacity factor): no token
#: dropped (capacity 128 >> T k / E), and T 512, E 4, k 2 at 0.5, where
#: each expert takes 128 of some 256 slots
CASES = {
    "roomy": (2, 16, 32, 64, 4, 2, 1.25),
    "capacity-pressing": (4, 128, 32, 48, 4, 2, 0.5),
    "olmoe-like": (2, 64, 64, 32, 16, 8, 1.25),
}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _weights(rng, e, d, ff, act):
    f32 = np.float32
    p = {"router": rng.standard_normal((d, e)).astype(f32) / f32(np.sqrt(d)),
         "w_in": rng.standard_normal((e, d, ff)).astype(f32)
         / f32(np.sqrt(d)),
         "w_out": rng.standard_normal((e, ff, d)).astype(f32)
         / f32(np.sqrt(ff))}
    if act == "swiglu":
        p["w_gate"] = rng.standard_normal((e, d, ff)).astype(f32) \
            / f32(np.sqrt(d))
    return p


def _case(name, act, seed=0):
    b, s, d, ff, e, k, cf = CASES[name]
    rng = np.random.default_rng(seed + len(name))
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    kw = dict(n_experts=e, top_k=k, d_model=d, d_ff=ff, act=act,
              capacity_factor=cf)
    return x, _weights(rng, e, d, ff, act), kw


def _jax_routes(x, p, kw):
    """The JAX side's routes: each token's experts by ``jax.lax.top_k`` of
    its router softmax (as ``repro.models.layers.moe`` computes them), and
    its dropped (token, slot) pairs by the capacity rule: a slot's
    position is the count of earlier slots, token-major, that chose the
    same expert; positions at or past the capacity are dropped."""
    t = x.shape[0] * x.shape[1]
    xt = jnp.asarray(x).reshape(t, -1)
    probs = jax.nn.softmax(xt @ jnp.asarray(p["router"]), axis=-1)
    top_p, top_e = jax.lax.top_k(probs, kw["top_k"])
    srt = np.sort(np.asarray(probs), axis=-1)[:, ::-1]
    k = kw["top_k"]
    if k < srt.shape[1]:
        assert (srt[:, k - 1] > srt[:, k]).all(), "tied router probabilities"
    top_e = np.asarray(top_e)
    cap = int(np.ceil(t * k / kw["n_experts"] * kw["capacity_factor"]))
    cap = max((cap + 127) // 128 * 128, 128)
    seen = np.zeros(kw["n_experts"], np.int64)
    kept = np.zeros(top_e.shape, bool)
    for i in range(t):
        for j in range(k):
            kept[i, j] = seen[top_e[i, j]] < cap
            seen[top_e[i, j]] += 1
    return top_e, kept


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_matches_jax(name, act):
    x, p, kw = _case(name, act)
    want, waux = JL.moe({k: jnp.asarray(v) for k, v in p.items()},
                        JL.MoEConfig(**kw), jnp.asarray(x), jnull_ctx())
    with L.recording_routes() as routes:
        got, aux = L.moe({k: torch.as_tensor(v) for k, v in p.items()},
                         L.MoEConfig(**kw), torch.as_tensor(x), null_ctx())
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=MOE_RTOL,
                               atol=MOE_ATOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=MOE_RTOL)
    assert aux.dtype == torch.float32 and got.dtype == torch.float32
    top_e, kept = _jax_routes(x, p, kw)
    assert len(routes) == 1
    np.testing.assert_array_equal(routes[0]["experts"].numpy(), top_e)
    np.testing.assert_array_equal(routes[0]["kept"].numpy(), kept)
    dropped = int((~kept).sum())
    if name == "capacity-pressing":
        assert dropped > 0
        # a dropped slot adds nothing: the JAX output of the kept slots
        # alone, and the port's, are the whole output
        assert not kept.all(1).all()
    else:
        assert dropped == 0


def test_moe_capacity_rule():
    c = L.MoEConfig(n_experts=64, top_k=8, d_model=8, d_ff=8)
    assert L.moe_capacity(c, 8) == 128                  # a decode step
    assert L.moe_capacity(c, 8 * 2048) == 2560          # ceil(2048 x 1.25)
    assert L.moe_capacity(dataclasses.replace(c, capacity_factor=0.5),
                          512 * 64 // 8) == 256


def test_moe_refuses_a_mesh():
    x, p, kw = _case("roomy", "swiglu")
    sc = ShardingCtx(type("M", (), {"axis_names": ("data", "model"),
                                    "shape": {"data": 1, "model": 2}})())
    with pytest.raises(NotImplementedError, match="moe_shardmap"):
        L.moe({k: torch.as_tensor(v) for k, v in p.items()},
              L.MoEConfig(**kw), torch.as_tensor(x), sc)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("name", ["roomy", "capacity-pressing"])
def test_moe_gradients_match_jax(name, act):
    """d(sum(out * w) + aux) with respect to x and every weight."""
    x, p, kw = _case(name, act, seed=5)
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jloss(x_, p_):
        out, aux = JL.moe(p_, JL.MoEConfig(**kw), x_, jnull_ctx())
        return jnp.sum(out * jnp.asarray(w)) + aux

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    tx = torch.as_tensor(x).requires_grad_(True)
    tp = {k: torch.as_tensor(v).requires_grad_(True) for k, v in p.items()}
    out, aux = L.moe(tp, L.MoEConfig(**kw), tx, null_ctx())
    (out * torch.as_tensor(w)).sum().add(aux).backward()
    pairs = [("x", tx.grad, jgx)] + [(k, tp[k].grad, jgp[k]) for k in p]
    for name_, got, want in pairs:
        want = _np(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(want).max(),
                                   err_msg=name_)


# ---------------------------------------------------------------------------
# reduced olmoe-1b-7b, with the JAX package's weights carried over
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def olmoe():
    jcfg = jget(ARCH).reduced()
    params = JModel(jcfg).init(jax.random.PRNGKey(7))
    return params, jax.tree.map(np.asarray, params)


def _models(impl, olmoe):
    jparams, tree = olmoe
    jcfg = dataclasses.replace(jget(ARCH).reduced(), attn_impl=impl)
    cfg = dataclasses.replace(get(ARCH).reduced(), attn_impl=impl)
    model = Model(cfg, device="cpu")
    return JModel(jcfg), jparams, model, model.params_from_numpy(tree)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).float(),
                                          np.float64),
                               _np(want), rtol=tol, atol=tol, err_msg=msg)


def test_olmoe_config_and_carried_weights(olmoe):
    cfg = get(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv,
            cfg.d_ff, cfg.vocab, cfg.n_experts, cfg.top_k) == (
        "moe", 16, 2048, 16, 16, 1024, 50304, 64, 8)
    assert Model(cfg, device="cpu").n_params() == 6_919_096_320
    _, _, model, params = _models("einsum", olmoe)
    moe = params["layers"]["moe"]
    e, d, ff = 4, 128, 256
    assert moe["router"].shape == (2, d, e) \
        and moe["router"].dtype == torch.float32
    assert moe["w_in"].shape == moe["w_gate"].shape == (2, e, d, ff)
    assert moe["w_out"].shape == (2, e, ff, d)
    _, tree = olmoe
    got = dict(PM.tree_items(params))
    for path, a in PM.tree_items(tree):
        np.testing.assert_array_equal(got[path].numpy(), a)


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_olmoe_forward_and_loss_match_jax(impl, olmoe):
    jm, jparams, m, params = _models(impl, olmoe)
    toks = _tokens(0, (2, 32), m.cfg.vocab)
    want, waux = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    with L.recording_routes() as routes:
        got, aux = m.forward(params, {"tokens": torch.as_tensor(toks)})
    assert len(routes) == m.cfg.n_layers
    tol = MODEL_TOL[impl]
    _close(got, want, tol)
    assert float(aux) > 0
    _close(aux, waux, tol)
    labels = _tokens(1, (2, 32), m.cfg.vocab)
    labels[1, :7] = -1
    batch = {"tokens": toks, "labels": labels}
    want, wm = jm.loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    got, gm = m.loss(params, {k: torch.as_tensor(v)
                              for k, v in batch.items()})
    _close(got, want, tol)
    for key in ("nll", "aux", "tokens"):
        _close(gm[key], wm[key], tol, key)
    # the loss carries 0.01 of the layers' summed aux
    _close(got, gm["nll"] + 0.01 * gm["aux"], 1e-6)


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_olmoe_prefill_and_decode_steps_match_jax(impl, olmoe):
    """Prefill 12 tokens into a 16-slot cache, then 4 decode steps."""
    jm, jparams, m, params = _models(impl, olmoe)
    toks = _tokens(2, (3, 16), m.cfg.vocab)
    tol = MODEL_TOL[impl]
    jlg, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :12])},
                         cache_len=16)
    lg, c = m.prefill(params, {"tokens": torch.as_tensor(toks[:, :12])},
                      cache_len=16)
    _close(lg, jlg, tol, "prefill logits")
    for key in ("k", "v"):
        _close(c["layers"][key], jc["layers"][key], tol, f"prefill {key}")
    for i in range(12, 16):
        jlg, jc = jm.decode_step(jparams, jnp.asarray(toks[:, i]), jc,
                                 jnp.int32(i))
        lg, c = m.decode_step(params, torch.as_tensor(toks[:, i]), c, i)
        _close(lg, jlg, tol, f"decode logits {i}")
        for key in ("k", "v"):
            _close(c["layers"][key], jc["layers"][key], tol,
                   f"decode {key} {i}")


def test_olmoe_gradients_match_jax(olmoe):
    """``loss_and_grads`` differentiates through ``moe``: every leaf's
    gradient against ``jax.grad`` of the JAX loss."""
    jm, jparams, m, params = _models("einsum", olmoe)
    toks = _tokens(3, (2, 24), m.cfg.vocab)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jg = jax.grad(lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in
                                        batch.items()}, jnull_ctx())[0])(
        jparams)
    loss, metrics, grads = loss_and_grads(m, params, batch)
    assert float(metrics["aux"]) > 0
    want = dict(PM.tree_items(jax.tree.map(np.asarray, jg)))
    got = dict(PM.tree_items(grads))
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(got[path].numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg="/".join(path))
    assert np.abs(want[("layers", "moe", "router")]).max() > 0


def _jax_greedy(jm, jparams, prompts, gen):
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


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_olmoe_generate_matches_jax_greedy(impl, olmoe):
    jm, jparams, m, params = _models("einsum", olmoe)
    out = serve_llm.generate(ARCH, batch=3, prompt_len=20, gen=6,
                             device="cpu", params=params, attn_impl=impl)
    prompts = serve_llm.synthetic_prompts(3, 20, m.cfg.vocab)
    np.testing.assert_array_equal(out["completions"],
                                  _jax_greedy(jm, jparams, prompts, 6))


def test_olmoe_train_step_and_trainer_report_aux(olmoe):
    _, _, m, params = _models("einsum", olmoe)
    state = {"params": params,
             "opt": {"m": PM.tree_map(torch.zeros_like, params),
                     "v": PM.tree_map(torch.zeros_like, params),
                     "step": torch.zeros((), dtype=torch.int32)}}
    toks = _tokens(4, (2, 17), m.cfg.vocab)
    step = make_train_step(m, AdamWConfig(lr=1e-3))
    before = state["params"]["layers"]["moe"]["router"].clone()
    state, metrics = step(state, {"tokens": toks[:, :-1],
                                  "labels": toks[:, 1:]})
    assert float(metrics["aux"]) > 0 and np.isfinite(float(metrics["loss"]))
    assert not torch.equal(state["params"]["layers"]["moe"]["router"],
                           before)
    out = train_loop(TrainRun(arch=ARCH, steps=3, batch=2, seq=32,
                              n_docs=40, log_every=1, device="cpu"))
    assert len(out["aux"]) == 3 and all(a > 0 for a in out["aux"])
