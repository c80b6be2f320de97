"""Uniform model facade on an explicit device::

    m = Model(cfg)                            # device="cuda" by default
    params = m.init(seed)                     # or m.params_from_numpy(tree)
    aparams = m.abstract_params()             # meta tensors (no storage)
    loss, metrics = m.loss(params, batch)     # differentiable
    logits, aux = m.forward(params, batch)
    logits, caches = m.prefill(params, batch, cache_len=...)
    logits, caches = m.decode_step(params, tokens, caches, length)
    acaches = m.abstract_caches(batch, cache_len)   # meta tensors

The families in :data:`FAMILIES`: the decoder-only ones (dense, moe and
ssm, ``transformer.FAMILIES``) are assembled in ``models/transformer.py``,
encdec in ``models/encdec.py``, and ``Model`` calls the same entry points
of either; another family raises "not yet ported".  A vision config takes its precomputed patch
embeddings as ``batch["prefix"]``, an encdec config its frame embeddings
(the audio frontend's stub, :func:`enc_len_of` frames) as
``batch["enc_embeds"]``.  ``loss``
is what the train step differentiates (``launch/steps.py``);
``forward``, ``prefill`` and ``decode_step`` take no gradient.
``input_specs(cfg, shape)`` gives the ``meta`` stand-ins of every model
input of an (arch x shape) cell, and ``demo_batch`` a concrete random
batch of those shapes.  ``param_pspecs(rules, mesh_shape)`` maps the
parameters' logical axes onto a mesh's axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.shardings import ShardingCtx, null_ctx
from repro_torch.models import encdec as ED
from repro_torch.models import param as PM
from repro_torch.models import transformer as TF


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device; the LM path runs on "
                           "the GPU unless the caller passes device='cpu'")
    return dev


def enc_len_of(cfg: ArchConfig, seq_len: int) -> int:
    """Audio frontend stub: 1 frame embedding per 4 decoder tokens."""
    return max(seq_len // 4, 8)


#: The families the port runs, each with the module that assembles it.
FAMILIES = dict({f: TF for f in TF.FAMILIES}, encdec=ED)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{self.cfg.name}: family {self.cfg.family!r} is not yet "
                f"ported to repro_torch (ported: {', '.join(FAMILIES)})")
        self.device = resolve_device(self.device)

    @property
    def _family(self):
        """The module that assembles this config's family."""
        return FAMILIES[self.cfg.family]

    @property
    def spec(self) -> Dict:
        return self._family.spec(self.cfg)

    def init(self, seed: Union[int, torch.Generator] = 0) -> Dict:
        """Parameters drawn from ``seed`` (or a generator on this
        model's device)."""
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return PM.init_params(self.spec, gen, self.device)

    def params_from_numpy(self, tree) -> Dict:
        """The JAX package's parameters (as numpy arrays) on this device."""
        return PM.params_from_numpy(tree, self.spec, device=self.device)

    def abstract_params(self) -> Dict:
        """The parameter tree as ``meta`` tensors: shapes and dtypes, no
        storage (the JAX package's ``ShapeDtypeStruct``s)."""
        return PM.abstract_params(self.spec)

    def param_pspecs(self, rules, mesh_shape) -> Dict:
        return PM.param_pspecs(self.spec, rules, mesh_shape)

    def n_params(self) -> int:
        return PM.count_params(self.spec)

    # -- entry points ---------------------------------------------------------

    def loss(self, params, batch, sc: Optional[ShardingCtx] = None):
        """(loss, metrics).  Differentiable: autograd records it when the
        parameters require grad; wrap a scoring call in
        ``torch.no_grad()``."""
        return self._family.lm_loss(self.cfg, params, batch,
                                    sc or null_ctx())

    @torch.no_grad()
    def forward(self, params, batch, sc: Optional[ShardingCtx] = None):
        return self._family.forward(self.cfg, params, batch,
                                    sc or null_ctx())

    @torch.no_grad()
    def prefill(self, params, batch, sc=None, cache_len: int = None):
        if cache_len is None:
            cache_len = batch["tokens"].shape[1]
        return self._family.prefill(self.cfg, params, batch,
                                    sc or null_ctx(), cache_len)

    @torch.no_grad()
    def decode_step(self, params, tokens, caches, length, sc=None):
        return self._family.decode_step(self.cfg, params, tokens, caches,
                                        length, sc or null_ctx())

    def cache_spec(self, batch: int, cache_len: int,
                   enc_len: int = 0) -> Dict:
        """Decode caches of ``cache_len`` positions; an encdec config's
        also hold cross K/V of ``enc_len`` frames (by default
        :func:`enc_len_of` ``cache_len``, as in the JAX package; the
        caches ``prefill`` returns hold the encoder's own length)."""
        return self._family.cache_spec(
            self.cfg, batch, cache_len,
            enc_len or enc_len_of(self.cfg, cache_len))

    def abstract_caches(self, batch: int, cache_len: int,
                        enc_len: int = 0) -> Dict:
        """:meth:`cache_spec` as ``meta`` tensors (no storage)."""
        return PM.abstract_params(self.cache_spec(batch, cache_len,
                                                  enc_len))

    def init_caches(self, batch: int, cache_len: int,
                    enc_len: int = 0) -> Dict:
        return PM.tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                  device=self.device),
            self.cache_spec(batch, cache_len, enc_len))


# ---------------------------------------------------------------------------
# input specs per (arch x shape) cell
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape: ShapeConfig
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Returns (batch specs as ``meta`` tensors, logical axes per input)
    for a cell.

    * train:   tokens + labels (+ modality extras)
    * prefill: tokens (+ extras)
    * decode:  single-token batch; caches come from ``Model.cache_spec``
      (or ``Model.abstract_caches``).
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    cdt = cfg.compute_dtype
    specs: Dict[str, torch.Tensor] = {}
    axes: Dict[str, Tuple] = {}

    def add(name, shp, dtype, ax):
        specs[name] = torch.empty(shp, dtype=dtype, device="meta")
        axes[name] = ax

    if shape.kind == "decode":
        add("tokens", (b,), i32, ("batch",))
        return specs, axes

    add("tokens", (b, s), i32, ("batch", "seq"))
    if shape.kind == "train":
        add("labels", (b, s), i32, ("batch", "seq"))
    if cfg.frontend == "vision":
        add("prefix", (b, cfg.frontend_len, cfg.d_model), cdt,
            ("batch", None, "act_embed"))
    if cfg.family == "encdec":
        add("enc_embeds", (b, enc_len_of(cfg, s), cfg.d_model), cdt,
            ("batch", None, "act_embed"))
    return specs, axes


def demo_batch(cfg: ArchConfig, shape: ShapeConfig,
               gen: Union[int, torch.Generator] = 0,
               device: Union[str, torch.device] = "cuda") -> Dict:
    """Concrete random batch matching ``input_specs``: integers in
    ``[0, vocab - 1)`` and normals, drawn from ``gen`` (a seed, or a
    generator on ``device``) input by input in the specs' order."""
    dev = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(gen))
    specs, _ = input_specs(cfg, shape)
    out = {}
    for name, spec in specs.items():
        if not spec.dtype.is_floating_point:
            out[name] = torch.randint(0, max(cfg.vocab - 1, 2), spec.shape,
                                      generator=gen, device=dev,
                                      dtype=spec.dtype)
        else:
            out[name] = torch.randn(spec.shape, generator=gen, device=dev,
                                    dtype=torch.float32).to(spec.dtype)
    return out
