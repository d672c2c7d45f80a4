"""AdamW with global-norm clipping and a warmup + cosine schedule."""

from .adamw import (AdamWConfig, adamw_init, adamw_update, adamw_update_ref,
                    clip_by_global_norm, lr_schedule)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_ref",
           "clip_by_global_norm", "lr_schedule"]
