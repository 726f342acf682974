"""AdamW and learning-rate schedules as plain functions on param trees
(port of ``repro/optim``)."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.schedules import warmup_cosine, warmup_linear

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "warmup_cosine",
    "warmup_linear",
]
