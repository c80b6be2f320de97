"""Registry mapping --arch ids to config modules.

It knows every arch id of the JAX package; only those in :data:`PORTED`
have a config here, and asking for another raises "not yet ported".
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ArchConfig

ARCHS: List[str] = [
    "qwen3_0_6b", "starcoder2_7b", "granite_8b", "qwen3_14b",
    "mamba2_130m", "seamless_m4t_large_v2", "pixtral_12b",
    "dbrx_132b", "olmoe_1b_7b", "recurrentgemma_2b",
]

#: Archs whose config and family the port runs.
PORTED: List[str] = [
    "qwen3_0_6b", "starcoder2_7b", "granite_8b", "qwen3_14b", "pixtral_12b",
    "dbrx_132b", "olmoe_1b_7b", "seamless_m4t_large_v2", "mamba2_130m",
]

_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "qwen3-0.6b": "qwen3_0_6b", "qwen3-14b": "qwen3_14b",
    "starcoder2-7b": "starcoder2_7b", "granite-8b": "granite_8b",
    "mamba2-130m": "mamba2_130m",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "pixtral-12b": "pixtral_12b", "dbrx-132b": "dbrx_132b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
})


def get(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ALIASES)}")
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not yet ported to repro_torch; ported: "
            f"{PORTED}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
