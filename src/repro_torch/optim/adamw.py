"""AdamW with a warmup + cosine schedule, global-norm clipping and a
chosen moment dtype: the reference's ``repro.optim.adamw``.

The update's math runs in float32; params and moments are stored in their
own dtypes.  The reference returns a new state (its step donates the old
buffers); here :func:`adamw_update` writes params and moments **in
place**, leaf by leaf, so a full-width model never holds a second copy of
its state (qwen3-1.7b: 2.03 B params x 16 B of float32 params, gradients
and moments ~ 33 GB on one card).

On a mesh (a :class:`repro_torch.mesh.grad_comm.TrainMesh`) each rank
holds shards of the params, gradients and moments; the update stays
elementwise on them, and only the global norm needs the mesh: the shards'
sums of squares are summed over the ranks, each leaf replicated on some
axes counted once (by the ranks at coordinate 0 of those axes).

A leaf of more than :data:`SLICE_OVER` elements (a stacked expert weight:
qwen3-moe's gate at two layers is (2, 128, 4096, 1536), 1.61 B) is updated
and summed in slices along its leading axes, each under
:data:`SLICE_ELEMS`: the update makes several float32 temporaries of what
it updates, which for such a leaf whole would be 6.4 GB each.  The update
is elementwise, so slicing leaves its bits unchanged; only such a leaf's
sum of squares is added up in another order.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.module import tree_leaves, tree_map

SLICE_OVER = 2 ** 30     # a leaf above this many elements goes in slices
SLICE_ELEMS = 2 ** 28    # of at most this many elements (whole rows)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: torch.dtype = torch.float32   # bf16 for the >=200B MoE archs


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * peak``, in float32
    (a 0-d tensor; ``step`` an int or a tensor)."""
    f32 = torch.float32
    step = torch.as_tensor(step).to(f32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                         * (1 + torch.cos(torch.tensor(math.pi, dtype=f32)
                                          * t)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _slices(*ts) -> list:
    """Matching views of ``ts`` (tensors of one shape): the tensors
    themselves, or for one of more than SLICE_OVER elements, blocks of
    whole rows along the leading axes of at most SLICE_ELEMS elements
    each (contiguous tensors only, so that writes reach them)."""
    t = ts[0]
    if t.numel() <= SLICE_OVER or not all(x.is_contiguous() for x in ts):
        return [ts]
    k = 1
    while math.prod(t.shape[k:]) > SLICE_ELEMS and k < t.dim() - 1:
        k += 1
    per = max(1, SLICE_ELEMS // math.prod(t.shape[k:]))
    return list(zip(*(x.view(-1, *x.shape[k:]).split(per) for x in ts)))


def _sum_squares(x) -> torch.Tensor:
    return sum(torch.sum(torch.square(s.to(torch.float32)))
               for s, in _slices(x))


def global_norm(tree, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32; over a tree of
    shards on ``mesh`` (a ``TrainMesh`` whose specs the tree mirrors) the
    sum runs over the whole tree, every rank gets the same norm."""
    if mesh is None:
        return torch.sqrt(sum(_sum_squares(x) for x in tree_leaves(tree)))
    owned = mesh.owned(tree)
    zero = torch.zeros((), dtype=torch.float32, device=owned[0][0].device)
    total = sum(_sum_squares(x) if own else zero for x, own in owned)
    return torch.sqrt(mesh.all_reduce_sum(total))


def clip_by_global_norm(tree, max_norm: float):
    """``(tree scaled by min(1, max_norm / norm), norm)``; each leaf scaled
    in float32 and stored back in its dtype."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                    tree), norm


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside ``params``, and the step
    count (a 0-d int32 tensor)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _walk(fn, p, g, m, v):
    if isinstance(p, dict):
        for k in p:
            _walk(fn, p[k], g[k], m[k], v[k])
    else:
        fn(p, g, m, v)


@torch.no_grad()
def adamw_update(params, grads, opt_state, cfg: AdamWConfig, mesh=None):
    """One AdamW step: clip ``grads`` by their global norm, update
    ``params`` and the moments **in place** (math in float32, stored in
    their own dtypes), advance the step.  Returns ``(params, opt_state,
    {"lr", "grad_norm"})``, the first two the same objects updated.  On a
    ``mesh`` the leaves are shards (:func:`global_norm`)."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    # clip_by_global_norm's scaling, leaf by leaf inside the update (no
    # clipped copy of the gradients)
    gnorm = global_norm(grads, mesh)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    f32 = torch.float32
    bc1 = 1 - b1 ** step.to(f32)
    bc2 = 1 - b2 ** step.to(f32)

    def upd(p, g, m, v):
        for part in _slices(p, g, m, v):
            upd_part(*part)

    def upd_part(p, g, m, v):
        gf = (g.to(f32) * scale).to(g.dtype).to(f32)
        mf = b1 * m.to(f32) + (1 - b1) * gf
        vf = b2 * v.to(f32) + (1 - b2) * gf * gf
        delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        pf = p.to(f32)
        p.copy_(pf - lr * (delta + cfg.weight_decay * pf))
        m.copy_(mf)
        v.copy_(vf)

    _walk(upd, params, grads, opt_state["m"], opt_state["v"])
    opt_state["step"].copy_(step)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
