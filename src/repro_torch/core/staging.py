"""Staged UDFs -- Flare Level 3 (paper section 5.1).

The paper's ``Rep[A] => Rep[B]`` UDFs become ordinary Python functions over
torch tensors.  They are called once per column batch inside the query
function (never per row by the compiled engines), so they run fused with
the relational operators on the device::

    @udf(FLOAT32)
    def sqr(x):
        return x * x

    df.select(("y", sqr(col("x"))))

The same function object runs on every engine, because every engine hands
it torch tensors: the ``compiled`` and ``stage`` engines their device
columns, the ``volcano`` oracle CPU tensors made from its host arrays (in
the dtype it computes in, float64 for floats), the ``tuple`` engine
length-1 CPU tensors.  What the function returns goes back to each
engine's own form.  This is the "same code, staged or unstaged" property
of multi-stage programming (paper section 2.2); ``map_batches``
functions follow the same rule (``{column: tensor}`` in, ``{name:
tensor}`` out).

UDFs compose with prepared-query parameters (``repro_torch.core.expr.
param``): a Param argument reaches ``fn`` as a 0-d tensor, so one
compiled template serves every binding::

    df.select(("y", scaled(col("x"), param("gain", "float32"))))
    df.lower("compiled").compile()(gain=2.5)
"""
from __future__ import annotations

import functools
from typing import Callable

from repro_torch.core import expr as E


class StagedUDF:
    """A named, staged scalar function over columns."""

    def __init__(self, fn: Callable, dtype: str, name: str = None):
        self.fn = fn
        self.dtype = dtype
        self.name = name or getattr(fn, "__name__", "udf")
        functools.update_wrapper(self, fn)

    def __call__(self, *args) -> E.Udf:
        return E.Udf(self.fn, tuple(E.wrap(a) for a in args), self.dtype,
                     self.name)

    def raw(self, *tensors):
        """Apply directly to tensors (outside a query)."""
        return self.fn(*tensors)

    def __repr__(self):
        return f"StagedUDF({self.name}: ... -> {self.dtype})"


def udf(dtype: str, name: str = None):
    """Decorator: mark a function as a staged UDF returning ``dtype``."""

    def deco(fn: Callable) -> StagedUDF:
        return StagedUDF(fn, dtype, name)

    return deco
