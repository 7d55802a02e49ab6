"""TrainState: the device-resident tree the trainer time-integrates.

The state is a plain dict ``{"params", "opt": {"m", "v", "step"}}``, the
reference's, so checkpointing and the time loop treat it as an opaque
tree.  Params are float32 (``param_dtype``) leaf tensors that require a
gradient; the step function updates them in place
(:func:`repro_torch.optim.adamw.adamw_update`).

On a mesh the state is sharded at birth: each rank holds its ZeRO-3 shard
of every param and moment (:func:`state_shardings`), and ``step`` is
replicated.  The reference's ``abstract_train_state`` (a shape-only state
for the dry-run) comes with ROADMAP A14, with ``module.abstract_params``
and the dry-run, its only users.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.mesh.axes import AxisRules, Sharding, logical_to_mesh
from repro_torch.models.api import _generator
from repro_torch.models.module import (init_params, resolve_device,
                                       shard_leaf, tree_leaves, tree_map)
from repro_torch.optim.adamw import AdamWConfig, adamw_init

TrainState = dict  # {"params": ..., "opt": {"m", "v", "step"}}


def param_shardings(model, mesh, rules: AxisRules) -> dict:
    """:class:`repro_torch.mesh.axes.Sharding` of every param on ``mesh``."""
    return tree_map(lambda p: Sharding(mesh, logical_to_mesh(
        p.logical_axes(), rules)), model.param_defs())


def state_shardings(model, mesh, rules: AxisRules) -> dict:
    """The train state's layout on ``mesh``: params and moments as the
    params' rules say, ``step`` replicated."""
    p = param_shardings(model, mesh, rules)
    return {"params": p, "opt": {"m": p, "v": p,
                                 "step": Sharding(mesh, ())}}


def create_train_state(model, seed, opt_cfg: AdamWConfig, mesh=None,
                       rules: Optional[AxisRules] = None, *, device=None,
                       param_dtype=torch.float32,
                       params: Optional[dict] = None) -> TrainState:
    """Params and AdamW moments on ``device`` (``cuda`` unless named): the
    params drawn there from ``seed`` (an int or a ``torch.Generator`` on
    the device) in ``param_dtype``, or ``params`` given (bridged weights,
    moved and cast there); the moments zero.

    With a ``mesh`` (and its ``rules``) the state is sharded at birth: each
    leaf is drawn whole from the seed's generator, in the order the model's
    ``init`` draws it, this rank's shard cut from it, and the whole leaf
    let go before the next is drawn (the peak is one leaf, never the tree),
    so the shards gathered equal the unsharded state from the same seed,
    bit for bit.  Given ``params`` (whole), each is cut the same way."""
    dev = resolve_device(device)
    if mesh is not None and rules is None:
        raise ValueError("create_train_state: a mesh needs its rules "
                         "(repro_torch.mesh.rules_for_mesh)")
    specs = None if mesh is None else tree_map(
        lambda s: s.spec, param_shardings(model, mesh, rules))
    if params is None and mesh is None:
        params = model.init(seed, device=dev, dtype=param_dtype)
    elif params is None:
        order = iter(tree_leaves(specs))         # init_params' draw order
        params = init_params(model.param_defs(), _generator(seed, dev),
                             device=dev, dtype=param_dtype,
                             finish=lambda t: shard_leaf(t, next(order),
                                                         mesh))
    else:
        def place(t, spec):
            if isinstance(t, dict):
                return {k: place(v, None if spec is None else spec[k])
                        for k, v in t.items()}
            t = t.detach().to(dev, param_dtype)
            s = t if spec is None else shard_leaf(t, spec, mesh)
            return s.clone() if s is t else s    # never the caller's tensor
        params = place(params, specs)
    params = tree_map(lambda t: t.requires_grad_(True), params)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}
