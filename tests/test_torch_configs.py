"""The port's configs and sharding rules against the JAX package's.

Every ported config equals the JAX one field for field (dtypes mapped),
has the same parameter count at full size (counted from abstract
parameters on ``meta``: ``dbrx-132b`` allocates nothing), and the same
``shape_applicable`` verdict for every arch and shape; the dense configs
that need no new family run a reduced forward against the JAX package
(f32, rtol = atol = 1e-4; ``pixtral-12b`` with its vision prefix).  The
sharding rules map every parameter, train state, batch input and cache
onto the same mesh axes as the JAX package's, for both profiles, as
tuples of ``PartitionSpec`` entries.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get as jget
from repro.configs.registry import ARCHS
from repro.distributed import shardings as JSH
from repro.launch import steps as JST
from repro.models import param as JPM
from repro.models.modeling import Model as JModel
from repro_torch.configs import PORTED, SHAPES, ArchConfig, get, \
    shape_applicable
from repro_torch.distributed import shardings as SH
from repro_torch.launch import serve_llm
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import Mesh
from repro_torch.models import param as PM
from repro_torch.models.modeling import Model

TOL = 1e-4
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
NEW = ["olmoe_1b_7b", "dbrx_132b", "granite_8b", "qwen3_14b",
       "starcoder2_7b", "pixtral_12b", "seamless_m4t_large_v2",
       "mamba2_130m"]
UNPORTED = ["recurrentgemma_2b"]


def _fields(cfg):
    out = dataclasses.asdict(cfg)
    for k, v in out.items():
        if v in _DTYPES:
            out[k] = _DTYPES[v]
    return out


def test_the_registry_ports_the_dense_and_moe_archs():
    assert sorted(PORTED) == sorted(NEW + ["qwen3_0_6b"])
    assert sorted(PORTED + UNPORTED) == sorted(ARCHS)
    for arch in UNPORTED:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            get(arch.replace("_", "-"))


@pytest.mark.parametrize("arch", NEW)
def test_config_fields_and_params_equal_jax(arch):
    cfg, jcfg = get(arch), jget(arch)
    assert _fields(cfg) == _fields(jcfg)
    assert _fields(cfg.reduced()) == _fields(jcfg.reduced())
    model = Model(cfg, device="cpu")
    aparams = model.abstract_params()
    assert all(t.device.type == "meta"
               for _, t in PM.tree_items(aparams))
    n = sum(t.numel() for _, t in PM.tree_items(aparams))
    assert n == model.n_params() == JModel(jcfg).n_params()
    names = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    want = jax.tree.map(lambda s: (tuple(s.shape),
                                   names[np.dtype(s.dtype).name]),
                        JModel(jcfg).abstract_params())
    got = PM.tree_map(lambda t: (tuple(t.shape), t.dtype), aparams)
    assert dict(PM.tree_items(got)) == dict(PM.tree_items(want))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_equals_jax(arch, shape):
    jcfg = jget(arch)
    cfg = ArchConfig(**_fields(jcfg))
    want = jbase.shape_applicable(jcfg, jbase.SHAPES[shape])
    assert shape_applicable(cfg, SHAPES[shape]) == want


# ---------------------------------------------------------------------------
# reduced forwards of the dense configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite_8b", "qwen3_14b",
                                  "starcoder2_7b", "pixtral_12b"])
def test_reduced_forward_matches_jax(arch):
    jcfg, cfg = jget(arch).reduced(), get(arch).reduced()
    jparams = JModel(jcfg).init(jax.random.PRNGKey(11))
    model = Model(cfg, device="cpu")
    params = model.params_from_numpy(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(12)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["prefix"] = (0.02 * rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model))).astype(np.float32)
    want, _ = JModel(jcfg).forward(jparams, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
    got, aux = model.forward(params, {k: torch.as_tensor(v)
                                      for k, v in batch.items()})
    assert got.shape == (2, 24 + cfg.frontend_len, cfg.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_pixtral_generate_feeds_its_prefix():
    """Greedy serving of the reduced pixtral-12b: prefill of its seeded
    prefix (``vision_prefix`` of seed + 1) and the prompt, decoding after
    both, against the JAX package's steps fed the same prefix (its
    ``serve_llm`` feeds zeros)."""
    arch = "pixtral_12b"
    jcfg, cfg = jget(arch).reduced(), get(arch).reduced()
    jm = JModel(jcfg)
    jparams = jm.init(jax.random.PRNGKey(13))
    params = Model(cfg, device="cpu").params_from_numpy(
        jax.tree.map(np.asarray, jparams))
    prefix = serve_llm.vision_prefix(cfg, 2, 1, "cpu")
    assert prefix.shape == (2, cfg.frontend_len, cfg.d_model)
    prompt, gen = 12, 4
    out = serve_llm.generate(arch, batch=2, prompt_len=prompt, gen=gen,
                             seed=0, device="cpu", params=params,
                             return_logits=True)
    base = cfg.frontend_len + prompt
    jb = {"tokens": jnp.asarray(serve_llm.synthetic_prompts(2, prompt,
                                                             cfg.vocab)),
          "prefix": jnp.asarray(prefix.numpy())}
    logits, caches = jm.prefill(jparams, jb, cache_len=base + gen)
    np.testing.assert_allclose(out["prefill_logits"].numpy(),
                               np.asarray(logits), rtol=TOL, atol=TOL)
    want = []
    for i in range(gen):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
        logits, caches = jm.decode_step(jparams, tok, caches,
                                        jnp.int32(base + i))
        np.testing.assert_allclose(out["decode_logits"][:, i].numpy(),
                                   np.asarray(logits), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(out["completions"], np.stack(want, 1))


def test_generate_cuts_the_depth():
    out = serve_llm.generate("starcoder2-7b", batch=2, prompt_len=8, gen=2,
                             device="cpu", n_layers=1)
    assert out["completions"].shape == (2, 2)


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

#: (axis names, sizes): single-pod, multi-pod, and a model axis of 3 that
#: divides few sizes (the replication fallback)
MESHES = {"data16-model16": (("data", "model"), (16, 16)),
          "pod2-data8-model4": (("pod", "data", "model"), (2, 8, 4)),
          "data2-model3": (("data", "model"), (2, 3))}


def _meshes(name):
    axes, sizes = MESHES[name]
    jmesh = types.SimpleNamespace(axis_names=axes,
                                  devices=np.empty(sizes, dtype=object))
    return jmesh, Mesh(axes, sizes, torch.device("cpu"))


def _spec_tree(tree):
    return {path: tuple(v) for path, v in PM.tree_items(tree)}


def _jax_spec_tree(tree):
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(k.key for k in path): tuple(v) for path, v in leaves}


def test_rules_are_the_jax_rules():
    for multi_pod in (False, True):
        assert SH.rules_tp_fsdp(multi_pod) == JSH.rules_tp_fsdp(multi_pod)
        assert SH.rules_dp_only(multi_pod) == JSH.rules_dp_only(multi_pod)
    assert sorted(SH.PROFILES) == sorted(JSH.PROFILES)
    with pytest.raises(NotImplementedError):
        SH.make_ctx(_meshes("data2-model3")[1]).constrain(
            torch.zeros(2, 3), "batch", None)
    x = torch.zeros(2, 3)
    assert SH.null_ctx().constrain(x, "batch", None) is x


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("profile", ["tp_fsdp", "dp_only"])
@pytest.mark.parametrize("arch", sorted(PORTED))
def test_pspecs_equal_jax(arch, profile, mesh):
    jmesh, tmesh = _meshes(mesh)
    jsc, sc = JSH.make_ctx(jmesh, profile), SH.make_ctx(tmesh, profile)
    assert sc.mesh_shape == jsc.mesh_shape
    jm, m = JModel(jget(arch)), Model(get(arch), device="cpu")
    got = ST.train_state_pspecs(m, sc)
    want = JST.train_state_pspecs(jm, jsc)
    assert _spec_tree(got) == _jax_spec_tree(want)
    assert PM.param_pspecs.fallbacks == JPM.param_pspecs.fallbacks
    for shape in SHAPES.values():
        jshape = jbase.SHAPES[shape.name]
        got = ST.batch_pspecs(get(arch), shape, sc)
        want = JST.batch_pspecs(jget(arch), jshape, jsc)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}
    for batch, cache_len in ((128, 32768), (8, 2080), (1, 524288)):
        got = ST.cache_pspecs(m, batch, cache_len, sc)
        want = JST.cache_pspecs(jm, batch, cache_len, jsc)
        assert _spec_tree(got) == _jax_spec_tree(want)


@pytest.mark.parametrize("axes", [("batch", "seq", "act_embed"),
                                  ("act_expert", "act_cap", None),
                                  ("batch", None, "kv_seq", None),
                                  ("vocab", "embed"), ("embed", "embed")])
def test_pspec_with_and_without_shapes(axes):
    for mesh in MESHES:
        jmesh, tmesh = _meshes(mesh)
        for profile in ("tp_fsdp", "dp_only"):
            jsc, sc = JSH.make_ctx(jmesh, profile), SH.make_ctx(tmesh,
                                                                profile)
            assert sc.pspec(*axes) == tuple(jsc.pspec(*axes))
            shape = (48, 7, 1024, 10)[:len(axes)]
            assert sc.pspec(*axes, shape=shape) == \
                tuple(jsc.pspec(*axes, shape=shape))
