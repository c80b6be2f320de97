"""Prepared-query serving: compiled templates as a multi-tenant server.

The production posture of Flare section 5: templates compile once,
concurrent requests coalesce into vmapped batches, and each request pays
the copy of its own result when it reads it.

    from repro_torch.serve import QueryServer
"""
from repro_torch.serve.server import (DeadlineExceededError,
                                      NotDispatchedError, QueryServer,
                                      QueueFullError, ServeFuture,
                                      SyncTimeoutError)
from repro_torch.serve.stats import ServeStats, percentile

__all__ = ["QueryServer", "ServeFuture", "ServeStats", "percentile",
           "QueueFullError", "NotDispatchedError", "SyncTimeoutError",
           "DeadlineExceededError"]
