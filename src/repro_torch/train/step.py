"""Train and eval step builders: the ``do_timestep`` of the paper's generic
loop.

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``:
loss, backward, global-norm clip and AdamW, the params and moments updated
in place.  The reference jits one SPMD program and donates the state;
here the step runs eagerly, its kernels (and their backward kernels) on
the card, and the in-place update takes the donation's place.  Gradient
accumulation (``accum_steps``) splits the batch into microbatches, each
its own forward and backward, the gradients summed in float32 and
averaged, the metrics the last microbatch's, as the reference's scan
does.

On a mesh (``mesh``, ``rules``: :mod:`repro_torch.mesh.axes`) every rank
runs the step on its shards of the state and its block of the batch
(:class:`repro_torch.mesh.grad_comm.TrainMesh`): the forward gathers each
layer's weights, the backward reduce-scatters their gradients, a leaf
replicated on some axes has its gradient summed over them
(``finish_grads``), and AdamW updates the shards in place against the
global norm.  ``grad_sync="compressed"`` is refused as the reference
refuses it: compressed cross-pod sync is host-orchestrated
(:mod:`repro_torch.train.pod_dp`).
"""
from __future__ import annotations

import torch

from repro_torch.mesh.axes import AxisRules
from repro_torch.mesh.grad_comm import TrainMesh
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update


def _split_microbatches(batch: dict, n: int) -> list:
    """(B, ...) -> n microbatches of (B / n, ...)."""
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch of {B} rows does not split into "
                         f"accum_steps={n} microbatches")
    per = B // n
    return [{k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            for i in range(n)]


def _grads_of(model, params, batch, mesh=None):
    """(loss, metrics, grads) of one (micro)batch; grads float32 and
    detached, None leaves as zeros."""
    leaves = tree_leaves(params)
    loss, metrics = model.loss(params, batch, mesh=mesh)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_grads_fn(model, mesh=None, *, accum_steps: int = 1):
    """``grads_of(params, batch) -> (loss, metrics, grads)`` over
    ``accum_steps`` microbatches; ``mesh`` a :class:`TrainMesh` (the
    gradients are then this rank's shards summed over the axes that split
    them, not yet over those that replicate them)."""
    def grads_of(params, batch):
        if accum_steps == 1:
            return _grads_of(model, params, batch, mesh)
        loss_sum = None
        acc = None
        for mb in _split_microbatches(batch, accum_steps):
            loss, metrics, grads = _grads_of(model, params, mb, mesh)
            grads = tree_map(lambda g: g.to(torch.float32), grads)
            if acc is None:
                acc, loss_sum = grads, loss
            else:
                for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                    a.add_(g)
                loss_sum = loss_sum + loss
            del grads
        scale = 1.0 / accum_steps
        for a in tree_leaves(acc):
            a.mul_(scale)
        return loss_sum * scale, metrics, acc
    return grads_of


def train_mesh(model, mesh, rules: AxisRules, *, axes=None):
    """The :class:`TrainMesh` of ``model`` on ``mesh`` (None without one)."""
    if mesh is None:
        return None
    if rules is None:
        raise ValueError("a mesh needs its rules "
                         "(repro_torch.mesh.rules_for_mesh)")
    return TrainMesh(mesh, rules, model.param_defs(), axes=axes)


def make_train_step(model, opt_cfg: AdamWConfig, mesh=None,
                    rules: AxisRules | None = None, *,
                    accum_steps: int = 1, grad_sync: str = "gspmd"):
    """``step(state, batch) -> (state, metrics)``: ``state`` updated in
    place; ``metrics`` ``{"loss", "ce", "aux", "tokens", "lr",
    "grad_norm"}`` (0-d tensors on the device, global on a mesh)."""
    if grad_sync == "compressed":
        raise ValueError(
            "compressed cross-pod sync is host-orchestrated: use "
            "repro_torch.train.pod_dp.make_pod_dp_step")
    if grad_sync != "gspmd":
        raise ValueError(f"unknown grad_sync {grad_sync!r}")
    tm = train_mesh(model, mesh, rules)
    grads_of = make_grads_fn(model, tm, accum_steps=accum_steps)

    def step(state, batch):
        loss, metrics, grads = grads_of(state["params"], batch)
        if tm is not None:
            tm.finish_grads(grads)
        _, _, stats = adamw_update(state["params"], grads, state["opt"],
                                   opt_cfg, tm)
        return state, {"loss": loss, **metrics, **stats}

    return step


def make_eval_step(model, mesh=None, rules: AxisRules | None = None):
    """``step(params, batch) -> {"loss", "ce", "aux", "tokens"}`` without a
    gradient (global on a mesh)."""
    tm = train_mesh(model, mesh, rules)

    def step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch, mesh=tm)
        return {"loss": loss, **metrics}

    return step
