"""repro_torch.core -- Flare's relational core on PyTorch.

Deferred DataFrame plans -> the Catalyst-analogue optimizer -> whole-query
compilation (``stages``), optionally with native CUDA kernel dispatch
(``repro_torch.native``); staged UDFs (``staging``) and ML kernels
(``ml``) that run inside the same query function (Level 3).
"""
from repro_torch.core.dataframe import (DataFrame, FlareContext,
                                        FlareDataFrame, MatrixView, any_, avg,
                                        count, flare, max_, min_, sum_)
from repro_torch.core.engines import CompileStats
from repro_torch.core.expr import (Col, Expr, Param, WithDomain, cast, col,
                                   lit, param, when)
from repro_torch.core.ml import TrainKernel, register_kernel, train_kernel
from repro_torch.core.plan import AggSpec, IterativeKernel, MapBatches
from repro_torch.core.stages import (CompileCache, Compiled, Lowered,
                                     available_engines, register_engine)
from repro_torch.core.staging import udf

__all__ = [
    "DataFrame", "FlareContext", "FlareDataFrame", "flare",
    "col", "lit", "param", "when", "cast", "udf", "AggSpec", "WithDomain",
    "sum_", "avg", "min_", "max_", "count", "any_", "Col", "Expr", "Param",
    "Lowered", "Compiled", "CompileCache", "CompileStats",
    "available_engines", "register_engine",
    "MapBatches", "IterativeKernel", "MatrixView",
    "TrainKernel", "register_kernel", "train_kernel",
]
