"""The port's ssm family (Mamba2, ``mamba2-130m``) against the JAX package,
on the CPU.

The pieces of ``models/ssm.py`` -- ``_segsum``, the chunked ``ssd`` scan
(at a length the chunk divides, one that halves it and one that falls to
chunks of 1; with and without an entering state), ``_causal_conv``,
``mamba2_block`` with its final state and ``mamba2_step`` -- on inputs made
with numpy from a seed, and the reduced ``mamba2-130m`` (2 layers, d 128,
4 heads of 32 over a state of 16, chunk 16, f32) through ``forward``,
``lm_loss`` with its gradients (against ``jax.grad``), ``prefill`` with
its caches, eight ``decode_step``s, greedy ``generate`` and one train
step, with the JAX package's weights carried over by
``params_from_numpy``.

Tolerances: rtol = atol = 1e-4 for every comparison of the two packages
and of the port with itself (the same f32 arithmetic, summed in another
order: measured at most 1e-5 on these inputs), except where a test says
otherwise: ``_segsum`` 1e-6, the slabbed scan against the whole 1e-6,
the naive f64 recurrence 1e-4.

The packages are imported inside the fixture, not while the file is
collected, so that collecting it allocates little.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

ARCH = "mamba2-130m"
TOL = 1e-4


@pytest.fixture(scope="module")
def pk():
    """Both packages' modules, and the JAX package's reduced weights."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get as jget
    from repro.distributed.shardings import null_ctx as jnull_ctx
    from repro.models import param as JPM
    from repro.models import ssm as JSSM
    from repro.models.modeling import Model as JModel
    from repro_torch.configs import get
    from repro_torch.distributed.shardings import null_ctx
    from repro_torch.launch import serve_llm
    from repro_torch.launch import steps as ST
    from repro_torch.models import param as PM
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TF
    from repro_torch.models.modeling import Model
    jparams = JModel(jget(ARCH).reduced()).init(jax.random.PRNGKey(31))
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, jget=jget, jnull_ctx=jnull_ctx, JPM=JPM,
        JSSM=JSSM, JModel=JModel, get=get, null_ctx=null_ctx,
        serve_llm=serve_llm, ST=ST, PM=PM, SSM=SSM, TF=TF, Model=Model,
        jparams=jparams, tree=jax.tree.map(np.asarray, jparams))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _close_trees(pk, got, want, tol=TOL):
    want = dict(pk.PM.tree_items(pk.jax.tree.map(np.asarray, want)))
    got = dict(pk.PM.tree_items(got))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        _close(got[path], w, tol, "/".join(path))


def _scan_inputs(seed, b=2, l=32, h=4, g=2, p=8, n=6):
    """x, a_dt (negative), B, C and an entering state, f32 numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((b, l, h, p)).astype(f),
            (-np.abs(rng.standard_normal((b, l, h))) * 0.3).astype(f),
            rng.standard_normal((b, l, g, n)).astype(f),
            rng.standard_normal((b, l, g, n)).astype(f),
            rng.standard_normal((b, h, p, n)).astype(f))


def _ssm_cfg(pk, chunk=8):
    return pk.SSM.SSMConfig(d_model=16, d_inner=32, head_dim=8, n_groups=2,
                            d_state=6, chunk=chunk)


def _block_params(pk, seed):
    """Mamba2 mixer weights from the JAX spec's init, with the per-head
    vectors and the conv bias drawn at random (their inits are constant)."""
    jc = pk.JSSM.SSMConfig(**dataclasses.asdict(_ssm_cfg(pk)))
    jp = pk.JPM.init_params(pk.JSSM.mamba2_spec(jc, pk.jnp.float32),
                            pk.jax.random.PRNGKey(seed))
    tree = pk.jax.tree.map(np.array, jp)
    rng = np.random.default_rng(seed)
    for k in ("A_log", "D", "dt_bias", "conv_b"):
        tree[k] = (0.5 * rng.standard_normal(tree[k].shape)).astype(
            np.float32)
    tree["norm"]["scale"] = (1 + 0.1 * rng.standard_normal(
        tree["norm"]["scale"].shape)).astype(np.float32)
    ported = {k: (torch.as_tensor(v) if not isinstance(v, dict) else
                  {kk: torch.as_tensor(vv) for kk, vv in v.items()})
              for k, v in tree.items()}
    return jc, pk.jax.tree.map(pk.jnp.asarray, tree), ported


# ---------------------------------------------------------------------------
# the pieces of models/ssm.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 5, 16])
def test_segsum_matches_jax(pk, t):
    x = np.random.default_rng(t).standard_normal((2, 3, t)).astype(
        np.float32)
    want = np.asarray(pk.JSSM._segsum(pk.jnp.asarray(x)))
    got = pk.SSM._segsum(torch.as_tensor(x)).numpy()
    assert got.shape == (2, 3, t, t)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got).sum() == 6 * t * (t - 1) // 2
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


#: lengths against chunk 16: 32 divides it (2 chunks), 24 halves it to 8
#: (3 chunks), 17 falls to 1 (17 chunks)
SCAN_LENGTHS = {32: 16, 24: 8, 17: 1}


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("l", sorted(SCAN_LENGTHS))
def test_ssd_matches_jax(pk, l, with_h0):
    x, a, b, c, h0 = _scan_inputs(l, l=l)
    assert pk.SSM.chunk_len(l, 16) == SCAN_LENGTHS[l]
    jy, jfinal = pk.JSSM.ssd(*map(pk.jnp.asarray, (x, a, b, c)), chunk=16,
                             h0=pk.jnp.asarray(h0) if with_h0 else None)
    y, final = pk.SSM.ssd(*map(torch.as_tensor, (x, a, b, c)), chunk=16,
                          h0=torch.as_tensor(h0) if with_h0 else None)
    assert tuple(y.shape) == x.shape and tuple(final.shape) == h0.shape
    assert y.dtype == final.dtype == torch.float32
    _close(y, jy)
    _close(final, jfinal)


@pytest.mark.parametrize("l", sorted(SCAN_LENGTHS))
def test_ssd_matches_the_naive_recurrence(pk, l):
    """The chunked scan against the state recurrence it computes, step by
    step in f64, from an entering state."""
    x, a, b, c, h0 = _scan_inputs(50 + l, l=l)
    y, final = pk.SSM.ssd(*map(torch.as_tensor, (x, a, b, c)), chunk=16,
                          h0=torch.as_tensor(h0))
    rep = x.shape[2] // b.shape[2]
    bh, ch = np.repeat(b, rep, axis=2), np.repeat(c, rep, axis=2)
    state = h0.astype(np.float64)
    want = np.zeros(x.shape)
    for t in range(l):
        state = (state * np.exp(a[:, t])[:, :, None, None]
                 + np.einsum("bhp,bhn->bhpn", x[:, t], bh[:, t]))
        want[:, t] = np.einsum("bhpn,bhn->bhp", state, ch[:, t])
    _close(y, want)
    _close(final, state)


def test_ssd_slabbed_equals_whole(pk, monkeypatch):
    """The intra-chunk terms over slabs of 1 and 3 chunks against one slab
    of all 8 (the default at this size)."""
    x, a, b, c, h0 = map(torch.as_tensor, _scan_inputs(7, l=64))
    assert len(pk.SSM._slabs(8, 2 * 4 * 8 * 8)) == 1
    whole = pk.SSM.ssd(x, a, b, c, chunk=8, h0=h0)
    for per_slab in (1, 3):
        monkeypatch.setattr(pk.SSM, "SLAB_ELEMS", per_slab * 2 * 4 * 8 * 8)
        assert len(pk.SSM._slabs(8, 2 * 4 * 8 * 8)) == -(-8 // per_slab)
        for got, want in zip(pk.SSM.ssd(x, a, b, c, chunk=8, h0=h0), whole):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("l", [2, 3, 9])
def test_causal_conv_matches_jax(pk, l):
    rng = np.random.default_rng(l)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, l, 5), (4, 5), (5,)))
    want = pk.JSSM._causal_conv(*map(pk.jnp.asarray, (x, w, b)))
    _close(pk.SSM._causal_conv(*map(torch.as_tensor, (x, w, b))), want)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("l", [16, 12, 9])
def test_mamba2_block_matches_jax(pk, l, with_h0):
    jc, jp, tp = _block_params(pk, 40 + l)
    c = _ssm_cfg(pk)
    rng = np.random.default_rng(l)
    u = rng.standard_normal((2, l, c.d_model)).astype(np.float32)
    h0 = rng.standard_normal((2, c.n_heads, c.head_dim, c.d_state)).astype(
        np.float32) if with_h0 else None
    want, wstate = pk.JSSM.mamba2_block(
        jp, jc, pk.jnp.asarray(u), pk.jnull_ctx(),
        h0=None if h0 is None else pk.jnp.asarray(h0), return_state=True)
    got, state = pk.SSM.mamba2_block(
        tp, c, torch.as_tensor(u), pk.null_ctx(),
        h0=None if h0 is None else torch.as_tensor(h0), return_state=True)
    _close(got, want)
    _close(state, wstate)
    _close(pk.SSM.mamba2_block(tp, c, torch.as_tensor(u), pk.null_ctx(),
                               h0=None if h0 is None else
                               torch.as_tensor(h0)), want)


def test_mamba2_step_matches_jax(pk):
    jc, jp, tp = _block_params(pk, 60)
    c = _ssm_cfg(pk)
    rng = np.random.default_rng(61)
    u = rng.standard_normal((3, 1, c.d_model)).astype(np.float32)
    cache = {"state": rng.standard_normal(
                 (3, c.n_heads, c.head_dim, c.d_state)).astype(np.float32),
             "conv": rng.standard_normal(
                 (3, c.conv_kernel - 1, c.conv_dim)).astype(np.float32)}
    spec = pk.SSM.mamba2_cache_spec(c, 3)
    assert {k: tuple(s.shape) for k, s in spec.items()} == \
        {k: v.shape for k, v in cache.items()}
    want, wnew = pk.JSSM.mamba2_step(
        jp, jc, pk.jnp.asarray(u),
        {k: pk.jnp.asarray(v) for k, v in cache.items()}, pk.jnull_ctx())
    got, new = pk.SSM.mamba2_step(
        tp, c, torch.as_tensor(u),
        {k: torch.as_tensor(v) for k, v in cache.items()}, pk.null_ctx())
    assert tuple(got.shape) == (3, 1, c.d_model)
    _close(got, want)
    for k in cache:
        _close(new[k], wnew[k], msg=k)


# ---------------------------------------------------------------------------
# the reduced mamba2-130m
# ---------------------------------------------------------------------------


def _models(pk, **over):
    jcfg = pk.jget(ARCH).reduced(**over)
    cfg = pk.get(ARCH).reduced(**over)
    model = pk.Model(cfg, device="cpu")
    return jcfg, cfg, pk.JModel(jcfg), model, model.params_from_numpy(
        pk.tree)


def _tokens(cfg, seed, b=2, s=32, labels=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        out["labels"][:, -3:] = -1
    return out


def _j(pk, batch):
    return {k: pk.jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_the_family_is_ported(pk):
    cfg = pk.get(ARCH)
    assert cfg.family == "ssm" and "ssm" in pk.TF.FAMILIES
    from repro_torch.models import modeling
    assert modeling.FAMILIES["ssm"] is pk.TF
    assert sorted(modeling.FAMILIES) == sorted(pk.TF.FAMILIES
                                               + ("encdec",))
    spec = pk.TF.spec(cfg)
    assert sorted(spec["layers"]) == ["ln", "mixer"]
    dtypes = {k: s.dtype for k, s in spec["layers"]["mixer"].items()
              if k != "norm"}
    assert dtypes == {"in_proj": torch.float32, "out_proj": torch.float32,
                      "conv_w": torch.float32, "conv_b": torch.float32,
                      "A_log": torch.float32, "D": torch.float32,
                      "dt_bias": torch.float32}


@pytest.mark.parametrize("s", [32, 24, 17])
def test_forward_and_loss_match_jax(pk, s):
    _, cfg, jm, model, params = _models(pk)
    batch = _tokens(cfg, 70 + s, s=s, labels=True)
    want, jaux = jm.forward(pk.jparams, _j(pk, batch))
    got, aux = model.forward(params, _t(batch))
    assert tuple(got.shape) == (2, s, cfg.padded_vocab)
    assert float(aux) == float(jaux) == 0.0
    _close(got, want)
    jloss, jmet = jm.loss(pk.jparams, _j(pk, batch))
    with torch.no_grad():
        loss, met = model.loss(params, _t(batch))
    _close(loss, jloss)
    for k in ("nll", "aux", "tokens"):
        _close(met[k], jmet[k], msg=k)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_loss_gradients_match_jax(pk, remat):
    jcfg, cfg, jm, model, params = _models(pk, remat=remat)
    batch = _tokens(cfg, 80, s=24, labels=True)
    want = pk.jax.grad(lambda p: jm.loss(p, _j(pk, batch))[0])(pk.jparams)
    loss, _, grads = pk.ST.loss_and_grads(model, params, batch)
    _close(loss, jm.loss(pk.jparams, _j(pk, batch))[0])
    want = dict(pk.PM.tree_items(pk.jax.tree.map(np.asarray, want)))
    for path, g in pk.PM.tree_items(grads):
        w = want[path]
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        # per leaf, against the leaf's largest gradient
        assert err <= TOL * max(scale, 1.0), ("/".join(path), err, scale)


@pytest.mark.parametrize("s", [16, 24, 17])
def test_prefill_and_decode_match_jax(pk, s):
    _, cfg, jm, model, params = _models(pk)
    toks = _tokens(cfg, 90 + s, s=s + 8)["tokens"]
    jl, jc = jm.prefill(pk.jparams, {"tokens": pk.jnp.asarray(toks[:, :s])},
                        cache_len=s + 8)
    logits, caches = model.prefill(params, _t({"tokens": toks[:, :s]}),
                                   cache_len=s + 8)
    _close(logits, jl)
    _close_trees(pk, caches, jc)
    want = {k: tuple(t.shape) for k, t in pk.PM.tree_items(
        model.abstract_caches(2, s + 8))}
    assert {k: tuple(t.shape) for k, t in pk.PM.tree_items(caches)} == want
    for i in range(s, s + 8):
        jl, jc = jm.decode_step(pk.jparams, pk.jnp.asarray(toks[:, i]), jc,
                                pk.jnp.int32(i))
        logits, caches = model.decode_step(
            params, torch.as_tensor(toks[:, i]), caches, i)
        _close(logits, jl, msg=f"step {i}")
    _close_trees(pk, caches, jc)


def test_decode_matches_the_forward(pk):
    """Prefill + decode (the recurrent form) over a split against one
    forward (the chunked form) over the whole, as the JAX package's
    ``test_decode_matches_forward`` holds its own."""
    _, cfg, _, model, params = _models(pk)
    toks = torch.as_tensor(_tokens(cfg, 100, s=40)["tokens"])
    full, _ = model.forward(params, {"tokens": toks})
    logits, caches = model.prefill(params, {"tokens": toks[:, :24]})
    _close(logits, full[:, 23])
    for i in range(24, 40):
        logits, caches = model.decode_step(params, toks[:, i], caches, i)
        _close(logits, full[:, i], msg=f"step {i}")


def test_generate_matches_jax(pk):
    """Greedy serving of the reduced config against the JAX package's
    steps on the same prompts and weights."""
    _, cfg, jm, _, params = _models(pk)
    prompt, gen = 12, 6
    out = pk.serve_llm.generate(ARCH, batch=2, prompt_len=prompt, gen=gen,
                                device="cpu", params=params,
                                return_logits=True)
    assert out["completions"].shape == (2, gen)
    jb = {"tokens": pk.jnp.asarray(pk.serve_llm.synthetic_prompts(
        2, prompt, cfg.vocab))}
    logits, caches = jm.prefill(pk.jparams, jb, cache_len=prompt + gen)
    _close(out["prefill_logits"], logits)
    want = []
    for i in range(gen):
        tok = pk.jnp.argmax(logits, -1).astype(pk.jnp.int32)
        want.append(np.asarray(tok))
        logits, caches = jm.decode_step(pk.jparams, tok, caches,
                                        pk.jnp.int32(prompt + i))
        _close(out["decode_logits"][:, i], logits, msg=f"step {i}")
    np.testing.assert_array_equal(out["completions"], np.stack(want, 1))


def test_train_step_matches_jax(pk):
    """One AdamW step from the JAX package's initial train state: the
    metrics (rtol 1e-5, as ``test_torch_train.py``) and the updated
    parameters (atol 1e-5 + rtol 1e-4 where the JAX gradient is above
    1e-3 of its leaf's largest or exactly 0: AdamW's first step moves a weight by
    about lr whatever its gradient, so rounding-noise gradients may move
    it either way)."""
    from repro.launch.steps import init_train_state as jinit
    from repro.launch.steps import make_train_step as jmake
    from repro.optim import AdamWConfig as JAdamW
    from repro_torch.launch.train import train_state_from_numpy
    from repro_torch.optim import AdamWConfig
    jcfg, cfg, jm, model, _ = _models(pk)
    jstate = jinit(jm, pk.jax.random.PRNGKey(5))
    state = train_state_from_numpy(model, pk.jax.tree.map(np.asarray,
                                                          jstate))
    batch = _tokens(cfg, 110, s=32, labels=True)
    jgrads = pk.jax.grad(lambda p: jm.loss(p, _j(pk, batch))[0])(
        jstate["params"])
    jnew, jmet = pk.jax.jit(jmake(jm, JAdamW(lr=1e-3), pk.jnull_ctx()))(
        jstate, _j(pk, batch))
    new, met = pk.ST.make_train_step(model, AdamWConfig(lr=1e-3))(state,
                                                                   batch)
    for k in ("loss", "nll", "tokens", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(met["aux"]) == float(jmet["aux"]) == 0.0
    grads = dict(pk.PM.tree_items(pk.jax.tree.map(np.asarray, jgrads)))
    want = dict(pk.PM.tree_items(pk.jax.tree.map(np.asarray,
                                                 jnew["params"])))
    for path, p in pk.PM.tree_items(new["params"]):
        g = grads[path]
        # exact zeros (embedding rows of absent tokens) decay alike
        keep = (np.abs(g) > 1e-3 * np.abs(g).max()) | (g == 0)
        assert keep.mean() > 0.5, path
        np.testing.assert_allclose(p.numpy()[keep], want[path][keep],
                                   rtol=1e-4, atol=1e-5,
                                   err_msg="/".join(path))
    assert int(new["opt"]["step"]) == 1


#: bf16 compute: two bf16 roundings of these logits (|logit| < 8: 2^-5);
#: measured 1.6e-2, where the JAX package's bf16 path differs from its
#: own f32 path by 3.4e-2
BF16_TOL = 2.0 ** -5


def test_bf16_compute_matches_jax(pk):
    """The card's dtypes on the CPU: the stacked per-head vectors and the
    conv weight come to the mixer in bf16 (``cast_compute`` casts every
    stacked leaf), and the products that mix them with f32 run in f32, as
    the JAX package's promotion runs them."""
    cfg = pk.get(ARCH).reduced(compute_dtype=torch.bfloat16)
    jm = pk.JModel(pk.jget(ARCH).reduced(compute_dtype=pk.jnp.bfloat16))
    model = pk.Model(cfg, device="cpu")
    params = model.params_from_numpy(pk.tree)
    toks = _tokens(cfg, 120, s=24)["tokens"]
    jl, jc = jm.prefill(pk.jparams, {"tokens": pk.jnp.asarray(toks[:, :16])},
                        cache_len=24)
    logits, caches = model.prefill(params, _t({"tokens": toks[:, :16]}))
    assert caches["layers"]["state"].dtype == torch.float32
    _close(logits, jl, BF16_TOL)
    for i in range(16, 24):
        jl, jc = jm.decode_step(pk.jparams, pk.jnp.asarray(toks[:, i]), jc,
                                pk.jnp.int32(i))
        logits, caches = model.decode_step(
            params, torch.as_tensor(toks[:, i]), caches, i)
        _close(logits, jl, BF16_TOL, msg=f"step {i}")
    got, _ = model.forward(params, _t({"tokens": toks}))
    assert got.dtype == torch.bfloat16
    _close(got, pk.jnp.asarray(jm.forward(pk.jparams, {
        "tokens": pk.jnp.asarray(toks)})[0], pk.jnp.float32), BF16_TOL)
