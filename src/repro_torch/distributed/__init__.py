"""Sharding rules and the sharding context (one card: nothing placed)."""
from repro_torch.distributed.shardings import (PROFILES, ShardingCtx,
                                               make_ctx, null_ctx,
                                               rules_dp_only, rules_tp_fsdp)

__all__ = ["PROFILES", "ShardingCtx", "make_ctx", "null_ctx",
           "rules_dp_only", "rules_tp_fsdp"]
