"""Optimizer-side numerics of the port: AdamW with its schedule and
global-norm clipping (:mod:`repro_torch.optim.adamw`, the trainer's), and
the symmetric int8 quantizer of :mod:`repro_torch.optim.compress`, which
the serving stack's int8 KV pages and int8 weights use, and its
error-feedback gradient mean over ranks (``compressed_psum``, the pod
data-parallel step's)."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     lr_schedule)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "lr_schedule"]
