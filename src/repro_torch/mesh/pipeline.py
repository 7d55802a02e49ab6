"""Pipeline parallelism, function-centric: the user supplies ``stage_fn``
(one stage's computation, the paper's ``subdomain_solve`` role); this
module supplies the schedule and the transfer at each stage boundary (the
paper's ``communicate``: a neighbour shift, the additive-Schwarz ghost
exchange applied to the layer dimension).  Counterpart of
``repro.mesh.pipeline``.

GPipe over a mesh axis with S stages and M microbatches: T = M + S - 1
ticks; at tick t stage s runs microbatch t - s.  SPMD as in the reference:
every stage runs every tick, the activations advance one stage a tick by
:meth:`repro_torch.core.comm.Comm.shift`, and the last stage's outputs are
broadcast.  Bubble fraction (S - 1) / T (:func:`bubble_fraction`).  A
forward primitive (inference, activations pipelined across pods), plain
PyTorch as the reference's is plain ``jnp``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.module import tree_leaves, tree_map


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pipeline_apply(stage_fn: Callable, params_stacked, x_micro, mesh, *,
                   axis: str = "pod"):
    """Run a GPipe forward pipeline over ``mesh``'s ``axis`` (every rank of
    the mesh calls it).

    ``stage_fn(stage_params, h) -> h``; ``params_stacked``: a nested dict
    whose leaves have a leading (n_stages,) axis (a rank reads its stage's
    slice, its coordinate on ``axis``); ``x_micro``: (n_micro, micro_batch,
    ...), the same on every rank.  Returns the last stage's (n_micro,
    micro_batch, ...) outputs on every rank."""
    comm = mesh.comm(axis)
    n_stages, stage = comm.size(), comm.rank()
    n_micro = x_micro.shape[0]
    sp = tree_map(lambda a: a[stage], params_stacked)
    h_in = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        # stage 0 injects microbatch t (while there is one)
        h = x_micro[min(t, n_micro - 1)] if stage == 0 else h_in
        h = stage_fn(sp, h)
        out_idx = t - (n_stages - 1)             # the last stage emits
        if out_idx >= 0 and stage == n_stages - 1:
            outs[out_idx] = h
        h_in = comm.shift(h, offset=1)           # stage s -> s + 1
    # only the last stage's outputs are real
    return comm.broadcast_from(outs, root=n_stages - 1)


def reference_apply(stage_fn: Callable, params_stacked, x_micro):
    """Oracle: the stages in order on one device, microbatch by
    microbatch."""
    n_stages = tree_leaves(params_stacked)[0].shape[0]
    outs = []
    for h in x_micro:
        for s in range(n_stages):
            h = stage_fn(tree_map(lambda a: a[s], params_stacked), h)
        outs.append(h)
    return torch.stack(outs)
