"""The port's optimizer substrate (``repro_torch.optim``) on the CPU.

The counterparts of ``tests/test_optim.py``'s eight tests, with the same
limits, plus ``adamw_update`` and ``warmup_cosine`` against the JAX
package on random trees (numpy inputs from a seed, f32 on both sides).

Tolerances:
* schedule: rtol 1e-6 (the same f32 operations);
* one AdamW step on random trees: rtol 1e-6 / atol 1e-7 on the updated
  parameters, ``m`` and ``v`` (the same f32 arithmetic: the grads' norm
  is summed in another order, which moves the clip scale by ulps);
* ``compressed_psum`` over 4 ``gloo`` processes: relative error below
  0.05 of the largest sum (the reference test's limit), and equal to the
  JAX package's ``compressed_psum`` formula computed on one host to 1e-6.
"""
import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as JO
from repro.optim import compression as JC
from repro_torch.models.param import tree_items
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, warmup_cosine)
from repro_torch.optim import compression as C

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}  # d/dw ||w||^2
        params, opt, _ = adamw_update(grads, opt, params, cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_weight_decay_decoupled():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5)
    params = {"w": torch.tensor([1.0])}
    opt = adamw_init(params)
    params2, _, _ = adamw_update({"w": torch.tensor([0.0])}, opt, params,
                                 cfg)
    assert float(params2["w"][0]) < 1.0  # decays even with zero grad


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 3.0, "b": torch.ones(9) * 4.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    total = float(torch.sqrt(sum(torch.sum(x ** 2)
                                 for _, x in tree_items(clipped))))
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)
    assert float(norm) > 1.0


def test_schedule_shape():
    lr = warmup_cosine(1.0, 10, 100)
    step = lambda s: torch.tensor(s, dtype=torch.int32)
    assert float(lr(step(0))) == 0.0
    np.testing.assert_allclose(float(lr(step(10))), 1.0, rtol=1e-5)
    assert float(lr(step(100))) < 0.2
    assert float(lr(step(55))) < float(lr(step(20)))


def test_quantize_roundtrip_error_bounded():
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(1000),
                        dtype=torch.float32)
    q, s = C.quantize(x)
    err = (C.dequantize(q, s) - x).abs().numpy()
    assert err.max() <= float(s) * 0.5 + 1e-7


def test_error_feedback_accumulates():
    """With EF, the *running sum* of compressed grads tracks the true sum
    far better than independent quantization."""
    rng = np.random.default_rng(1)
    grads = [torch.as_tensor(rng.standard_normal(256) * 0.01,
                             dtype=torch.float32) for _ in range(50)]
    err = torch.zeros(256)
    ef_sum = np.zeros(256)
    naive_sum = np.zeros(256)
    true_sum = np.zeros(256)
    for g in grads:
        q, s, err = C.compress_with_feedback(g, err)
        ef_sum += C.dequantize(q, s).numpy()
        qn, sn = C.quantize(g)
        naive_sum += C.dequantize(qn, sn).numpy()
        true_sum += g.numpy()
    ef_err = np.abs(ef_sum - true_sum).max()
    naive_err = np.abs(naive_sum - true_sum).max()
    assert ef_err <= naive_err + 1e-6


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


PSUM_WORLD = 4

PSUM_SCRIPT = textwrap.dedent(r"""
    import sys
    import numpy as np, torch, torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.optim.compression import compressed_psum

    def worker(rank, world, port):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        x = np.random.default_rng(0).standard_normal((world, 64))
        got = compressed_psum(torch.as_tensor(x[rank], dtype=torch.float32))
        np.save(sys.argv[2] + f".{rank}.npy", got.numpy())
        dist.destroy_process_group()

    if __name__ == "__main__":
        world = int(sys.argv[3])
        mp.spawn(worker, args=(world, int(sys.argv[1])), nprocs=world)
""")


def test_compressed_psum_matches_psum(tmp_path):
    """Four CPU processes in a ``gloo`` group: the int8-payload sum
    against the exact sum, and against the JAX package's formula (pmax of
    the scale, psum of the rounded payload) computed on the host."""
    script = tmp_path / "psum.py"
    script.write_text(PSUM_SCRIPT)
    out = str(tmp_path / "got")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(script), str(_free_port()),
                           out, str(PSUM_WORLD)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    x = np.random.default_rng(0).standard_normal((PSUM_WORLD, 64)
                                                 ).astype(np.float32)
    want = x.sum(0)
    amax = np.float32(np.abs(x).max())
    scale = np.maximum(amax, np.float32(1e-12)) / np.float32(127.0)
    formula = np.clip(np.round(x / scale), -127, 127).astype(np.int32
                                                             ).sum(0) * scale
    for rank in range(PSUM_WORLD):
        got = np.load(f"{out}.{rank}.npy")
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert rel < 0.05, (rank, rel)
        np.testing.assert_allclose(got, formula, rtol=1e-6, atol=1e-7)
    # the same quantization as the JAX package's per-tensor quantize
    q, s = JC.quantize(jnp.asarray(x))
    tq, ts = C.quantize(torch.as_tensor(x))
    np.testing.assert_array_equal(np.asarray(q), tq.numpy())


def test_gradient_compression_training_still_converges():
    """Compressed-accumulation variant reaches the same optimum."""
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0)
    params = {"w": torch.tensor([4.0, -2.0, 1.0])}
    opt = adamw_init(params)
    errors = C.zeros_like_errors(params)
    for _ in range(300):
        grads = {"w": 2 * params["w"]}
        grads, errors = C.tree_compress_grads(grads, errors)
        params, opt, _ = adamw_update(grads, opt, params, cfg)
    assert float(params["w"].abs().max()) < 5e-2


# -- against the JAX package ---------------------------------------------------


def _random_tree(rng, scale=1.0):
    return {"a": {"w": (rng.standard_normal((6, 5)) * scale
                        ).astype(np.float32),
                  "b": (rng.standard_normal(5) * scale).astype(np.float32)},
            "z": (rng.standard_normal((3, 2, 4)) * scale).astype(np.float32)}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.as_tensor(v.copy()) for k, v in tree.items()}


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("seed,clip,sched", [(0, 1.0, False),
                                             (1, 100.0, True),
                                             (2, 0.3, True)])
def test_adamw_update_matches_jax(seed, clip, sched):
    """Four AdamW steps on random trees of params and grads (clipping
    active or not, constant or scheduled lr): params, m, v, step,
    grad_norm and lr equal the JAX package's."""
    rng = np.random.default_rng(seed)
    params = _random_tree(rng)
    lr = 1e-2
    jcfg = JO.AdamWConfig(lr=JO.warmup_cosine(lr, 2, 6) if sched else lr,
                          clip_norm=clip)
    tcfg = AdamWConfig(lr=warmup_cosine(lr, 2, 6) if sched else lr,
                       clip_norm=clip)
    jp, tp = _jax_tree(params), _torch_tree(params)
    jopt, topt = JO.adamw_init(jp), adamw_init(tp)
    for _ in range(4):
        grads = _random_tree(rng, scale=rng.uniform(0.1, 3.0))
        jp, jopt, jm = JO.adamw_update(_jax_tree(grads), jopt, jp, jcfg)
        tp, topt, tm = adamw_update(_torch_tree(grads), topt, tp, tcfg)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-6)
        assert int(topt["step"]) == int(jopt["step"])
        assert topt["step"].dtype == torch.int32
        for want_tree, got_tree in ((jp, tp), (jopt["m"], topt["m"]),
                                    (jopt["v"], topt["v"])):
            got = dict(tree_items(got_tree))
            for path, want in tree_items(want_tree):
                np.testing.assert_allclose(got[path].numpy(),
                                           np.asarray(want), rtol=1e-6,
                                           atol=1e-7, err_msg=str(path))


def test_warmup_cosine_matches_jax():
    for peak, warm, total, floor in ((3e-3, 10, 50, 0.1),
                                     (1.0, 0, 7, 0.0), (0.5, 20, 20, 0.3)):
        jlr = JO.warmup_cosine(peak, warm, total, floor)
        tlr = warmup_cosine(peak, warm, total, floor)
        for s in range(0, total + 3):
            got = tlr(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(
                float(got), float(jlr(jnp.int32(s))), rtol=1e-6, atol=0,
                err_msg=f"{peak} {warm} {total} step {s}")
