"""Deprecated alias of :mod:`repro_torch.launch.serve_llm`, the
LLM-serving CLI; ``repro_torch.serve`` is the prepared-query server.

The alias mirrors the JAX package's ``repro.launch.serve`` shim so that
both packages expose the same module names.  The port never had a
``launch/serve.py`` of its own, so no caller depends on it: import
``repro_torch.launch.serve_llm`` (LLM serving) or ``repro_torch.serve``
(query serving).
"""
from __future__ import annotations

import warnings

from repro_torch.launch.serve_llm import (ServeStats, generate,  # noqa: F401
                                          main)

warnings.warn(
    "repro_torch.launch.serve moved to repro_torch.launch.serve_llm; "
    "repro_torch.serve is now the prepared-query server",
    DeprecationWarning, stacklevel=2)

if __name__ == "__main__":
    main()
