"""repro_torch.core -- Flare's relational core on PyTorch.

Deferred DataFrame plans -> the Catalyst-analogue optimizer -> whole-query
compilation (``stages``), optionally with native CUDA kernel dispatch
(``repro_torch.native``).
"""
from repro_torch.core.dataframe import (DataFrame, FlareContext, any_, avg,
                                        count, max_, min_, sum_)
from repro_torch.core.engines import CompileStats
from repro_torch.core.expr import (Col, Expr, Param, WithDomain, cast, col,
                                   lit, param, when)
from repro_torch.core.plan import AggSpec
from repro_torch.core.stages import CompileCache, Compiled, Lowered

__all__ = [
    "DataFrame", "FlareContext", "col", "lit", "param", "when", "cast",
    "AggSpec", "WithDomain", "sum_", "avg", "min_", "max_", "count", "any_",
    "Col", "Expr", "Param", "Lowered", "Compiled", "CompileCache",
    "CompileStats",
]
