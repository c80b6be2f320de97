"""Sharding context (one card: no mesh)."""
from repro_torch.distributed.shardings import ShardingCtx, null_ctx

__all__ = ["ShardingCtx", "null_ctx"]
