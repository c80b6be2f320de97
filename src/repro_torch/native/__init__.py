"""repro_torch.native -- native kernel dispatch for the compiled engine.

A registry of kernel patterns (``registry``), the built-in patterns and
the per-fragment code generator (``patterns``), and the post-optimizer
rewrite pass plus the ``compiled-native`` engine name (``dispatch``)::

    lowered  = df.lower(engine="compiled", native=True)
    lowered.dispatch_report()        # which patterns fired / fell back
    compiled = lowered.compile()     # builds the fragments' CUDA kernels
    compiled(**params)               # prepared bindings, no rebuilds
"""
from repro_torch.native.dispatch import (NativeOp, NativeWholeQueryEngine,
                                         has_native_ops, rewrite_plan)
from repro_torch.native.patterns import ExprCompiler, UnsupportedExpr
from repro_torch.native.registry import (Decision, DispatchReport, Fragment,
                                         KernelPattern, available_patterns,
                                         get_pattern, patterns,
                                         register_pattern)

__all__ = [
    "NativeOp", "NativeWholeQueryEngine", "has_native_ops", "rewrite_plan",
    "ExprCompiler", "UnsupportedExpr",
    "Decision", "DispatchReport", "Fragment", "KernelPattern",
    "available_patterns", "get_pattern", "patterns", "register_pattern",
]
