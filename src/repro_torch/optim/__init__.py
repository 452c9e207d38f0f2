"""From-scratch optimizers of the port."""

from repro_torch.optim.adamw import (
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    lr_schedule,
)

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm", "global_norm",
           "lr_schedule"]
