"""TrainState: the device-resident tree the trainer time-integrates.

The state is a plain dict ``{"params", "opt": {"m", "v", "step"}}``, the
reference's, so checkpointing and the time loop treat it as an opaque
tree.  Params are float32 (``param_dtype``) leaf tensors that require a
gradient; the step function updates them in place
(:func:`repro_torch.optim.adamw.adamw_update`).  A mesh (sharded at birth)
comes with ROADMAP A13b.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.module import resolve_device, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_init

TrainState = dict  # {"params": ..., "opt": {"m", "v", "step"}}


def create_train_state(model, seed, opt_cfg: AdamWConfig, mesh=None, *,
                       device=None, param_dtype=torch.float32,
                       params: Optional[dict] = None) -> TrainState:
    """Params and AdamW moments on ``device`` (``cuda`` unless named): the
    params drawn there from ``seed`` (an int or a ``torch.Generator`` on
    the device) in ``param_dtype``, or ``params`` given (bridged weights,
    moved and cast there); the moments zero."""
    if mesh is not None:
        raise NotImplementedError("a train state sharded over a mesh comes "
                                  "with ROADMAP A13b")
    dev = resolve_device(device)
    if params is None:
        params = model.init(seed, device=dev, dtype=param_dtype)
    else:
        params = tree_map(lambda t: t.detach().to(dev, param_dtype).clone(),
                          params)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}
