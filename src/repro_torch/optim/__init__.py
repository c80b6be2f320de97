"""Optimizer substrate: AdamW, schedules, clipping, gradient compression."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm)      # noqa: F401
from repro_torch.optim.schedule import warmup_cosine            # noqa: F401
