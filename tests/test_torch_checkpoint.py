"""The port's checkpoint manager and elastic placement on the CPU.

The counterparts of ``tests/test_checkpoint.py`` (round trip, corruption
skipped, retention, atomic publish, torch tensors in bf16), checkpoints
crossing between the two packages in both directions (the arrays must be
equal, exactly), and ``remesh`` / ``replicate`` onto the port's
one-device mesh.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.configs import get as jget
from repro.launch.steps import init_train_state as jinit_train_state
from repro.models.modeling import Model as JModel
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.elastic import remesh, replicate
from repro_torch.configs import get
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.launch.steps import abstract_train_state, init_train_state
from repro_torch.launch.train import train_state_from_numpy
from repro_torch.models import param as PM
from repro_torch.models.modeling import Model


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((8, 8)).astype(np.float32),
                       "b": rng.standard_normal(8).astype(np.float32)},
            "opt": {"m": {"w": np.zeros((8, 8), np.float32),
                          "b": np.zeros(8, np.float32)},
                    "step": np.int32(7)}}


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(5, st, extra={"pipeline": {"epoch": 1, "cursor": 3,
                                        "seed": 0}})
    step, restored, extra = mgr.restore(_state(1))
    assert step == 5
    assert extra["pipeline"]["cursor"] == 3
    np.testing.assert_array_equal(restored["params"]["w"],
                                  st["params"]["w"])
    np.testing.assert_array_equal(restored["opt"]["step"],
                                  st["opt"]["step"])
    assert restored["opt"]["step"].dtype == np.int32


def test_corruption_detected_and_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    # corrupt the newest checkpoint's first array file
    d = os.path.join(str(tmp_path), "step_0000000002")
    victim = sorted(f for f in os.listdir(d) if f.endswith(".bin"))[0]
    with open(os.path.join(d, victim), "r+b") as f:
        f.write(b"\xde\xad\xbe\xef")
    step, restored, _ = mgr.restore(_state())
    assert step == 1  # fell back to the older verified checkpoint
    np.testing.assert_array_equal(restored["params"]["w"],
                                  _state(1)["params"]["w"])


def test_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    assert mgr.list_steps() == [3, 4]


def test_atomic_no_partial_visible(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state())
    # a leftover tmp dir must not be listed as a checkpoint
    os.makedirs(os.path.join(str(tmp_path), "tmp.99"), exist_ok=True)
    assert mgr.list_steps() == [1]
    assert mgr.latest_step() == 1


def test_torch_tensors_roundtrip(tmp_path):
    """Tensors (f32, int32 0-d, bf16) go to the host once; bf16 is
    written as its bits under ``bfloat16`` and read back as the exact f32
    widening."""
    mgr = CheckpointManager(str(tmp_path))
    st = {"w": torch.arange(16.0).reshape(4, 4),
          "s": torch.full((4,), 2.5, dtype=torch.bfloat16) * torch.tensor(
              [1.0, -3.0, 1e-3, 7.0], dtype=torch.bfloat16),
          "step": torch.tensor(3, dtype=torch.int32)}
    mgr.save(3, st)
    _, restored, _ = mgr.restore(st)
    np.testing.assert_array_equal(st["w"].numpy(), restored["w"])
    np.testing.assert_array_equal(st["s"].float().numpy(), restored["s"])
    assert restored["step"].shape == () and restored["step"] == 3
    with open(os.path.join(str(tmp_path), "step_0000000003",
                           "manifest.json")) as f:
        dtypes = {a["name"]: a["dtype"] for a in json.load(f)["arrays"]}
    assert dtypes == {"s": "bfloat16", "step": "int32", "w": "float32"}


def test_restore_into_a_meta_template(tmp_path):
    """The trainer restores into ``abstract_train_state`` (meta tensors):
    the leaf names are the JAX package's ``"/"``-joined paths."""
    model = Model(get("qwen3-0.6b").reduced(), device="cpu")
    state = init_train_state(model, 0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state)
    with open(os.path.join(str(tmp_path), "step_0000000002",
                           "manifest.json")) as f:
        names = [a["name"] for a in json.load(f)["arrays"]]
    assert "params/layers/attn/wq" in names and "opt/step" in names
    assert "opt/m/layers/mlp/w_gate" in names
    _, restored, _ = mgr.restore(abstract_train_state(model))
    back = train_state_from_numpy(model, restored)
    for (path, a), (_, b) in zip(PM.tree_items(state),
                                 PM.tree_items(back)):
        assert a.dtype == b.dtype, path
        assert torch.equal(a, b), path


def _jax_state(seed=0):
    cfg = jget("qwen3-0.6b").reduced()
    state = jinit_train_state(JModel(cfg), jax.random.PRNGKey(seed))
    state = jax.tree.map(np.asarray, state)
    rng = np.random.default_rng(seed)
    # non-zero moments and step, so the round trip is not trivial
    state["opt"]["m"] = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32),
        state["opt"]["m"])
    state["opt"]["step"] = np.int32(11)
    return state


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    host = _jax_state()
    JManager(str(tmp_path)).save(4, host, extra={"pipeline": {
        "epoch": 0, "cursor": 4, "seed": 0}})
    model = Model(get("qwen3-0.6b").reduced(), device="cpu")
    step, restored, extra = CheckpointManager(str(tmp_path)).restore(
        abstract_train_state(model))
    assert step == 4 and extra["pipeline"]["cursor"] == 4
    got = dict(PM.flatten_with_paths(restored))
    want = dict(PM.flatten_with_paths(host))
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    state = train_state_from_numpy(model, restored)
    assert state["opt"]["step"].dtype == torch.int32
    assert int(state["opt"]["step"]) == 11


def test_port_checkpoint_restores_in_jax(tmp_path):
    model = Model(get("qwen3-0.6b").reduced(), device="cpu")
    state = init_train_state(model, 3)
    state["opt"]["step"] = torch.tensor(5, dtype=torch.int32)
    CheckpointManager(str(tmp_path)).save(9, state, extra={"k": 1})
    template = jax.tree.map(np.asarray, _jax_state())
    step, restored, extra = JManager(str(tmp_path)).restore(template)
    assert step == 9 and extra == {"k": 1}
    got = dict(PM.flatten_with_paths(restored))
    for name, t in PM.flatten_with_paths(state):
        np.testing.assert_array_equal(got[name], t.numpy(), err_msg=name)
        assert got[name].dtype == t.numpy().dtype, name
    assert restored["opt"]["step"].dtype == np.int32


def test_remesh_onto_one_device(tmp_path):
    model = Model(get("qwen3-0.6b").reduced(), device="cpu")
    host = {k: v.numpy() for k, v in
            PM.flatten_with_paths(model.init(0))}
    params = PM.tree_unflatten(
        (tuple(k.split("/")), v) for k, v in host.items())
    mesh = make_data_mesh(4, device="cpu")   # 4 row shards, one device
    placed = remesh(params, model.spec, mesh, rules=None)
    for name, t in PM.flatten_with_paths(placed):
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), host[name])
    rep = replicate({"x": np.arange(3, dtype=np.int32)}, mesh)
    assert rep["x"].dtype == torch.int32
    with pytest.raises(ValueError):
        remesh(params, model.spec, ["cpu", "meta"])
    with pytest.raises(ValueError):
        replicate(params, ["cpu", "meta"])
    bad = dict(params, head=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError):
        remesh(bad, model.spec, mesh)
