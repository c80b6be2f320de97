"""The port's train step and trainer against the JAX package, on the CPU.

The reduced ``qwen3-0.6b`` (2 layers, d 128, vocab 512, f32).  Both
packages start from the JAX package's initial train state (carried over
with ``train_state_from_numpy``) and see the same batches (numpy, from a
seed).  The JAX side runs ``jax.jit`` of its own ``make_train_step``.

Tolerances, per step of three:
* loss, nll, tokens, grad_norm and lr: rtol 1e-5 (the same f32
  arithmetic summed in another order: measured at most 2.0e-6);
* gradients: per leaf, max |g_port - g_jax| <= tol x max |g_jax| of the
  leaf, tol 1e-5 at the first step (measured 1.6e-6) and 1e-3 after it
  (measured 2.8e-4: see the next point);
* parameters after each step: |p_port - p_jax| <= 1e-5 + 1e-4 x |p_jax|
  (measured 1.9e-6 at most), only where every step's |g_jax| is above
  GRAD_FLOOR (1e-3) x the leaf's max |g_jax| or is exactly 0 in both.
  AdamW's first step moves a weight by about +-lr whatever its
  gradient's size, so a gradient that is rounding noise in both packages
  (below ``eps`` after the clip) can flip a weight's direction; those
  weights are left out of the comparison (at most 12 % of a leaf), and
  they move the later steps' gradients by the 2.8e-4 above.

The peak lr is 1e-3 with a one-step warm-up.  At 1e-2 the flipped noise
weights move the second step's loss by 0.4 % between the two (each
correct) f32 implementations, which no tolerance on the port could tell
from a fault.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get as jget
from repro.distributed.shardings import null_ctx as jnull_ctx
from repro.launch.steps import init_train_state as jinit_train_state
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.modeling import Model as JModel
from repro.models.modeling import input_specs as jinput_specs
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs import SHAPES, get
from repro_torch.kernels.decode_attention import kernel as DA
from repro_torch.kernels.flash_attention import kernel as FL
from repro_torch.launch.steps import (abstract_train_state, init_train_state,
                                      loss_and_grads, make_train_step)
from repro_torch.launch.supervisor import StepWatchdog, run_supervised
from repro_torch.launch.train import TrainRun, main, train_loop, \
    train_state_from_numpy
from repro_torch.models import param as PM
from repro_torch.models import transformer as TF
from repro_torch.models.modeling import (Model, demo_batch, enc_len_of,
                                         input_specs)
from repro_torch.optim import AdamWConfig, warmup_cosine

ARCH = "qwen3-0.6b"
LR = 1e-3
STEPS = 3
SCALAR_RTOL = 1e-5
GRAD_TOL = {0: 1e-5, "later": 1e-3}
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
GRAD_FLOOR = 1e-3

#: (attention route, sequence length, batch): einsum at B 2 x S 64,
#: blockwise at B 1 x S 2048 (above block_k 1024: 4 q blocks x 2 k blocks)
ROUTES = {"einsum": (64, 2), "blockwise": (2048, 1)}


def _batches(seq, batch, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 512, (batch, seq + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    return out


def _named(tree):
    return {n: np.asarray(torch.as_tensor(x).detach().cpu()
                          if isinstance(x, torch.Tensor) else x)
            for n, x in PM.flatten_with_paths(tree)}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's 3-step runs, one per (route, remat), shared by
    the parity cases: its metrics, gradients and parameters per step."""
    cache = {}

    def run(impl, remat):
        if (impl, remat) in cache:
            return cache[impl, remat]
        cfg = jget(ARCH).reduced(attn_impl=impl, remat=remat)
        model = JModel(cfg)
        state = jinit_train_state(model, jax.random.PRNGKey(0))
        init = jax.tree.map(np.asarray, state)
        step = jmake_train_step(
            model, JAdamWConfig(lr=jwarmup_cosine(LR, 1, STEPS)),
            jnull_ctx())
        grad = jax.grad(lambda p, b: model.loss(p, b, jnull_ctx())[0])
        # one program for the gradient and the step: one compile
        both = jax.jit(lambda st, b: (grad(st["params"], b), step(st, b)))
        out = []
        for batch in _batches(*ROUTES[impl], STEPS):
            g, (state, metrics) = both(state, batch)
            g = _named(jax.tree.map(np.asarray, g))
            out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                        "grads": g,
                        "params": _named(jax.tree.map(np.asarray,
                                                      state["params"]))})
        cache[impl, remat] = (init, out)
        return cache[impl, remat]

    return run


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("impl", sorted(ROUTES))
def test_train_step_matches_jax(jax_runs, impl, remat):
    init, want = jax_runs(impl, remat)
    cfg = get(ARCH).reduced(attn_impl=impl, remat=remat)
    model = Model(cfg, device="cpu")
    state = train_state_from_numpy(model, init)
    step = make_train_step(model, AdamWConfig(lr=warmup_cosine(LR, 1,
                                                               STEPS)))
    floor_ok = None
    for i, batch in enumerate(_batches(*ROUTES[impl], STEPS)):
        w = want[i]
        _, _, grads = loss_and_grads(model, state["params"], batch)
        got_g = _named(grads)
        masks = {}
        for name, wg in w["grads"].items():
            scale = np.abs(wg).max()
            err = np.abs(got_g[name] - wg).max()
            tol = GRAD_TOL[0] if i == 0 else GRAD_TOL["later"]
            assert err <= tol * scale, (i, name, err, scale)
            # exact zeros (embedding rows of absent tokens) decay alike
            masks[name] = (np.abs(wg) > GRAD_FLOOR * scale) | (
                (wg == 0) & (got_g[name] == 0))
        floor_ok = masks if floor_ok is None else {
            n: floor_ok[n] & masks[n] for n in masks}
        state, metrics = step(state, batch)
        for k in ("loss", "nll", "tokens", "grad_norm", "lr"):
            np.testing.assert_allclose(float(metrics[k]), w["metrics"][k],
                                       rtol=SCALAR_RTOL, err_msg=f"{i} {k}")
        assert float(metrics["aux"]) == w["metrics"]["aux"] == 0.0
        got_p = _named(state["params"])
        for name, wp in w["params"].items():
            keep = floor_ok[name]
            assert keep.mean() > 0.5, (i, name, keep.mean())
            np.testing.assert_allclose(got_p[name][keep], wp[keep],
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"step {i} {name}")
        assert int(state["opt"]["step"]) == i + 1


def test_remat_settings_give_the_same_gradients():
    """none, full and dots: the same gradients (recomputation runs the
    same f32 operations); under full and dots the outer graph keeps only
    each layer's input, and the backward pass recomputes every product
    under full, only the batched (attention) products under dots."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountProducts(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.bmm.default,
                               torch.ops.aten.mm.default)
            return func(*args, **(kwargs or {}))

    batch = _batches(*ROUTES["blockwise"], 1)[0]
    grads, saved, products = {}, {}, {}
    for remat in ("none", "full", "dots"):
        cfg = get(ARCH).reduced(attn_impl="blockwise", remat=remat)
        model = Model(cfg, device="cpu")
        params = model.init(0)
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), \
                CountProducts() as count:
            _, _, g = loss_and_grads(model, params, batch)
        grads[remat], saved[remat] = _named(g), total[0]
        products[remat] = count.n
    for remat in ("full", "dots"):
        for name, want in grads["none"].items():
            np.testing.assert_allclose(grads[remat][name], want, rtol=0,
                                       atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"{remat} {name}")
    assert saved["full"] == saved["dots"] < saved["none"] / 10, saved
    assert products["none"] < products["dots"] < products["full"], products


def test_remat_applies_only_under_autograd():
    """A layer is checkpointed only while autograd records; an unknown
    remat raises."""
    fn = lambda x: x
    full = get(ARCH).reduced(remat="full")
    assert TF._remat(full, fn) is not fn
    with torch.no_grad():
        assert TF._remat(full, fn) is fn
    assert TF._remat(dataclasses.replace(full, remat="none"), fn) is fn
    model = Model(dataclasses.replace(full, remat="some"), device="cpu")
    batch = _batches(16, 2, 1)[0]
    with pytest.raises(ValueError, match="remat"):
        loss_and_grads(model, model.init(0), batch)


# -- kernels under autograd ------------------------------------------------------


def test_pallas_route_refuses_autograd():
    """attn_impl="pallas" reaches the flash kernel, which has no backward
    pass: the train step raises instead of giving the attention weights no
    gradient."""
    cfg = get(ARCH).reduced(attn_impl="pallas")
    model = Model(cfg, device="cpu")
    state = init_train_state(model, 0)
    step = make_train_step(model, AdamWConfig())
    with pytest.raises(NotImplementedError, match="no backward pass"):
        step(state, _batches(32, 2, 1)[0])
    with torch.no_grad():       # scoring still runs the kernel's route
        loss, _ = model.loss(state["params"], {
            k: torch.as_tensor(v) for k, v in _batches(32, 2, 1)[0].items()})
    assert math.isfinite(float(loss))


def test_attention_kernels_refuse_inputs_that_require_grad():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 16, 32, generator=g)
    k = torch.randn(1, 2, 16, 32, generator=g)
    v = torch.randn(1, 2, 16, 32, generator=g)
    for name in ("q", "k", "v"):
        args = {"q": q, "k": k, "v": v}
        args[name] = args[name].clone().requires_grad_()
        with pytest.raises(NotImplementedError, match="blockwise"):
            FL.flash_attention(args["q"], args["k"], args["v"])
        with torch.no_grad():
            FL.flash_attention(args["q"], args["k"], args["v"])
    qd = torch.randn(1, 4, 32, generator=g, requires_grad=True)
    lengths = torch.tensor([9], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="einsum"):
        DA.decode_attention(qd, k, v, lengths)
    with torch.no_grad():
        out = DA.decode_attention(qd, k, v, lengths)
    assert out.shape == (1, 4, 32)
    # a tensor that does not require grad runs under grad mode too
    FL.flash_attention(q, k, v)


# -- state and input specs -----------------------------------------------------


def test_abstract_train_state_matches_init():
    model = Model(get(ARCH).reduced(), device="cpu")
    abstract = abstract_train_state(model)
    state = init_train_state(model, 0)
    a, c = PM.tree_items(abstract), PM.tree_items(state)
    assert [p for p, _ in a] == [p for p, _ in c]
    for (path, x), (_, y) in zip(a, c):
        assert x.device.type == "meta", path
        assert (tuple(x.shape), x.dtype) == (tuple(y.shape), y.dtype), path
    assert state["opt"]["step"].dtype == torch.int32
    assert PM.tree_bytes(abstract) == PM.tree_bytes(state) == \
        3 * PM.tree_bytes(model.spec) + 4
    full = Model.__new__(Model)
    full.cfg = get(ARCH)
    assert PM.count_params(full.spec) == 663_548_416


def test_input_specs_and_demo_batch_match_jax():
    jcfg, cfg = jget(ARCH), get(ARCH)
    from repro.configs.base import SHAPES as JSHAPES
    for name, shape in SHAPES.items():
        jspecs, jaxes = jinput_specs(jcfg, JSHAPES[name])
        specs, axes = input_specs(cfg, shape)
        assert axes == jaxes
        assert {k: tuple(v.shape) for k, v in specs.items()} == \
            {k: tuple(v.shape) for k, v in jspecs.items()}
        assert all(v.device.type == "meta" for v in specs.values())
    assert enc_len_of(cfg, 4096) == 1024 and enc_len_of(cfg, 8) == 8
    small = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    b1 = demo_batch(cfg, small, 3, device="cpu")
    b2 = demo_batch(cfg, small, 3, device="cpu")
    assert set(b1) == {"tokens", "labels"}
    for k in b1:
        assert b1[k].dtype == torch.int32 and b1[k].shape == (2, 16)
        assert torch.equal(b1[k], b2[k])
        assert int(b1[k].min()) >= 0 and int(b1[k].max()) < cfg.vocab - 1


# -- the trainer (counterparts of tests/test_train_loop.py) --------------------


def test_loss_decreases():
    run = TrainRun(steps=25, batch=4, seq=64, ckpt_dir=None, n_docs=100,
                   device="cpu")
    out = train_loop(run)
    first = np.mean(out["losses"][:3])
    last = np.mean(out["losses"][-3:])
    assert last < first * 0.7, (first, last)


@pytest.fixture
def one_thread():
    """torch's multi-threaded CPU kernels may sum in another order from
    run to run (two fresh runs differ in the last bit of some losses);
    one intra-op thread makes a run repeat bit for bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_checkpoint_resume_is_exact(tmp_path, one_thread):
    """train(20) == train(10) + resume(10 more): the same loss stream, bit
    for bit on the CPU with one thread.  (``synth``'s word cache is set by an earlier run in this
    process, or by the first run here: every run sees the same words.)"""
    train_loop(TrainRun(steps=1, batch=2, seq=16, n_docs=10,
                        device="cpu"))
    kw = dict(batch=4, seq=64, ckpt_every=5, n_docs=100, device="cpu")
    full = train_loop(TrainRun(steps=20, ckpt_dir=str(tmp_path / "a"), **kw))
    d2 = str(tmp_path / "b")
    train_loop(TrainRun(steps=10, ckpt_dir=d2, **kw))
    resumed = train_loop(TrainRun(steps=20, ckpt_dir=d2, **kw))
    assert resumed["start_step"] == 10
    np.testing.assert_array_equal(resumed["losses"], full["losses"][10:])
    assert resumed["checkpoint"]["restore_ms"] > 0


def test_supervisor_restarts_on_fault(tmp_path):
    run = TrainRun(steps=12, batch=2, seq=32, ckpt_dir=str(tmp_path),
                   ckpt_every=4, fault_prob=0.15, n_docs=60, device="cpu")
    attempts = []

    def once():
        train_loop(run)

    def on_restart(n, e):
        run.restarts_seen = n
        attempts.append(type(e).__name__)

    restarts = run_supervised(once, max_restarts=20,
                              on_restart=on_restart)
    assert all(a == "FaultInjected" for a in attempts)
    assert restarts == len(attempts) >= 1
    # training completed despite faults
    assert len(run.losses) >= 12


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(threshold=2.0, warmup=3)
    events = []
    for step, dt in enumerate([0.1] * 6 + [0.5] + [0.1] * 3):
        wd.observe(step, dt, on_straggler=events.append)
    assert len(events) == 1 and events[0]["step"] == 6


def test_supervisor_gives_up_after_max():
    calls = []

    def always_fails():
        calls.append(1)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError):
        run_supervised(always_fails, max_restarts=2)
    assert len(calls) == 3  # initial + 2 restarts


def test_cli_on_the_cpu(tmp_path, capsys):
    main(["--device", "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
          "--n-docs", "20", "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    out = capsys.readouterr().out
    assert "[train] step     2" in out and "supervisor restarts: 0" in out
    assert (tmp_path / "step_0000000003" / "manifest.json").exists()
    with pytest.raises(ValueError, match="one device"):
        train_loop(TrainRun(model_parallel=2, device="cpu"))
