"""Hand-written CUDA kernels of the port (Hopper, sm_90a).

Each kernel package holds a wrapper that launches the CUDA kernel, the
plain PyTorch version of the same function, and ``launches``, the count of
kernel launches:

* the native dispatch path (TPC-H): ``filter_agg``, ``segmented_reduce``,
  ``join_probe``.  Their skeletons live in ``csrc/``; the per-fragment row
  function comes from the query (:class:`Body`, generated by
  ``repro_torch.native.patterns.ExprCompiler``), and ``cuda_build``
  compiles a skeleton together with its body with nvcc at first use;
* the LM path: ``flash_attention`` (full-sequence attention; a
  tensor-core kernel for bf16 at D 64 and 128 and a CUDA-core kernel for
  the rest, chosen by ``flash_attention.kernel.route``) and
  ``decode_attention`` (one token over a KV cache).  Each kernel is one
  fixed source in ``csrc/`` (no generated body), built the same way
  (``cuda_build.fixed_unit``).

The device policy is :func:`on_card`, and it looks only at the tensor it
is given: a CPU tensor takes the plain version, a CUDA tensor the kernel --
or an exception.  Nothing catches a build or launch failure to fall back.

Two error types matter to the degradation ladder
(``repro_torch.resilience.degrade``): :class:`KernelBudgetError` is raised
only by eligibility and geometry checks before a launch, and the ladder
answers it from a weaker rung only while a template compiles -- raised
by a wrapper's argument checks at execute time it propagates;
:class:`UnsupportedDeviceError` says that no kernel exists for the device
at all, and the ladder never absorbs it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

#: Bytes of shared memory a block may use for its grouped accumulator:
#: the static limit every launch gets without an opt-in attribute.
SMEM_BUDGET_BYTES = 48 * 1024

#: Columns one kernel unit can stream (``FLARE_MAX_COLS`` in csrc/).
MAX_COLS = 24

#: The keyless second pass runs one warp: one thread per output slot.
MAX_OUT = 32


class KernelBudgetError(ValueError):
    """A kernel was asked for work outside its resource envelope (an
    accumulator larger than its memory budget, too many columns, ...).

    Raised by explicit checks, never ``assert``.  The dispatch
    eligibility layer (``repro_torch.native.patterns``) screens these
    limits before it emits a kernel call, so seeing this at run time
    means a caller bypassed eligibility."""


class UnsupportedDeviceError(RuntimeError):
    """No kernel and no plain version exists for a tensor's device (a
    device that is neither CUDA nor the CPU, or a card older than sm_90).
    Not a geometry refusal: the degradation ladder must not absorb it,
    since a weaker rung would hide that the kernel never ran."""


def on_card(t: torch.Tensor) -> bool:
    """True when ``t`` lives on a CUDA device (launch the kernel), False
    for a CPU tensor (run the plain version).  Any other device raises
    :class:`UnsupportedDeviceError`."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise UnsupportedDeviceError(f"no kernel or plain version for device "
                                 f"{t.device}")


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` when autograd would record a call of
    the attention kernel ``name``: grad is enabled and an input requires
    grad.  Neither package has a backward pass for these kernels (the JAX
    package's Pallas kernels define no VJP, and ``jax.grad`` through them
    fails), and the CUDA kernels write their output through a raw pointer
    that autograd does not see -- without this check the inputs would get
    no gradient and no error.  It holds on every device, the plain
    versions' too, so the CPU fails as the card does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the kernel has no backward pass (in neither package); "
            f"train with attn_impl 'blockwise', 'einsum' or 'ring'")


@dataclasses.dataclass(frozen=True, eq=False)
class Body:
    """One fragment's generated per-row function, in CUDA C and in torch.

    ``src`` defines ``flare_row`` (and, for a join probe,
    ``flare_probe_key``) for the kernel unit; ``rows`` (and
    ``probe_key``) compute the same thing over whole columns for the
    plain version.  ``ops``/``fills`` give each accumulator slot its
    reduction ("sum" or "max") and neutral element; ``col_dtypes`` and
    ``build_dtypes`` the device dtype each streamed column must have;
    ``key_cols`` the probe columns (by index) that ``flare_probe_key``
    reads.
    Query parameters are never in ``src``: they arrive in the ``scal``
    vector, so every binding of a template shares one unit.
    """

    src: str
    rows: Callable
    ops: Tuple[str, ...]
    fills: Tuple[float, ...]
    col_dtypes: Tuple[torch.dtype, ...]
    build_dtypes: Tuple[torch.dtype, ...] = ()
    probe_key: Optional[Callable] = None
    key_cols: Tuple[int, ...] = ()

    @property
    def n_out(self) -> int:
        return len(self.ops)


def check_columns(what: str, cols: Sequence[torch.Tensor],
                  dtypes: Sequence[torch.dtype], n: int,
                  device: torch.device) -> None:
    """Validate streamed columns before their pointers reach a kernel."""
    if len(cols) != len(dtypes):
        raise KernelBudgetError(f"{what}: {len(cols)} columns for a body "
                                f"that streams {len(dtypes)}")
    if len(cols) > MAX_COLS:
        raise KernelBudgetError(f"{what}: {len(cols)} columns > {MAX_COLS}")
    for k, (c, dt) in enumerate(zip(cols, dtypes)):
        if c.dtype != dt or c.shape != (n,) or c.device != device \
                or not c.is_contiguous():
            raise KernelBudgetError(
                f"{what}: column {k} is {c.dtype} {tuple(c.shape)} on "
                f"{c.device}; the kernel takes a contiguous {dt} ({n},) "
                f"on {device}")


def check_mask(what: str, mask: Optional[torch.Tensor], n: int,
               device: torch.device) -> None:
    if mask is None:
        return
    if mask.dtype != torch.bool or mask.shape != (n,) \
            or mask.device != device or not mask.is_contiguous():
        raise KernelBudgetError(f"{what}: a mask must be a contiguous bool "
                                f"({n},) tensor on {device}")


def prologue(body: Body, extra: str = "") -> str:
    """The unit's constants: slot count, per-slot op and fill."""
    ops = ", ".join("1" if op == "max" else "0" for op in body.ops)
    fills = ", ".join(f32_literal(f) for f in body.fills)
    return (f"#define FLARE_N_OUT {body.n_out}\n{extra}"
            f"__constant__ int flare_op_max[FLARE_N_OUT] = {{{ops}}};\n"
            f"__constant__ float flare_fill[FLARE_N_OUT] = {{{fills}}};\n")


def f32_literal(x: float) -> str:
    """An exact C spelling of ``x`` rounded to float32: a hex float
    literal, or for inf/nan a bit pattern (device code only)."""
    v = np.float32(x)
    if np.isfinite(v):
        return float(v).hex() + "f"
    return f"__int_as_float(0x{int(v.view(np.uint32)):08x})"
