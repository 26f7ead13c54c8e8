"""AdamW, global-norm clipping and LR schedules over the port's parameter
trees (the port of ``src/repro/optim``)."""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine
from repro_torch.optim.clip import clip_by_global_norm, global_norm

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "linear_warmup_cosine", "clip_by_global_norm", "global_norm"]
