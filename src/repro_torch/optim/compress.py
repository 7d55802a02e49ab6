"""Symmetric int8 quantization, per tensor or per axis.

Counterpart of ``repro.optim.compress``'s ``int8_compress`` and
``int8_decompress``: ``q = clip(round(g / s), -127, 127)`` with
``s = max(max|g| / 127, 1e-30)``, over the whole tensor (``axis=None``:
one scalar scale, the per-tensor weight format) or over one axis (the KV
page format: one scale per remaining index).  ``torch.round`` rounds half
to even, as ``jnp.round`` does, and the division is a true division, so
identical inputs give identical codes and scales in both packages.

The error-feedback mean all-reduce of a gradient tree
(:func:`compressed_psum`, the pod data-parallel step's wire format) moves
int8 codes and one float32 scale a tensor: an all-gather of both and a
local mean, the quantization residual kept on the rank and fed into the
next step's gradient (error feedback).  Quantizing works on one float32
copy of ``g`` in place, and dequantizing writes its result in one pass, so
a multi-gigabyte weight never meets a chain of float32 temporaries.
"""
from __future__ import annotations

__all__ = ["compressed_psum", "init_compression_state", "int8_compress",
           "int8_decompress"]

import torch
import torch.distributed as dist

from repro_torch.models.module import tree_leaves, tree_map

CompressionState = dict  # {"err": tree of float32 residuals}


def int8_compress(g: torch.Tensor, *, axis=None):
    """``g`` -> (int8 codes of ``g``'s shape, float32 scale).

    ``axis=None`` reduces over the whole tensor (a 0-dim scale); ``axis=k``
    over that axis only (the scale has ``g``'s shape without axis ``k``:
    a (page, head, D) block with ``axis=-1`` gets a (page, head) scale)."""
    gf = g.to(torch.float32, copy=True)
    if axis is None:
        lo, hi = torch.aminmax(gf)
        s = torch.maximum(-lo, hi)            # max|g| without an |g| copy
    else:
        s = gf.abs().amax(dim=axis)
    s = torch.clamp(s / 127.0, min=1e-30)
    sb = s if axis is None else s.unsqueeze(axis)
    q = gf.div_(sb).round_().clamp_(-127, 127).to(torch.int8)
    return q, s


def int8_decompress(q: torch.Tensor, s: torch.Tensor, *, axis=None,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`int8_compress` (``axis`` as given there): the codes
    times their scale in float32, rounded once to ``dtype``.  One pass
    writes the ``dtype`` result (the product is computed in float32, the
    inputs' common type), so no float32 copy is made."""
    sb = s if axis is None else s.unsqueeze(axis)
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    return torch.mul(q, sb, out=out)



def init_compression_state(grads) -> CompressionState:
    """Zero float32 residuals beside ``grads`` (a nested dict)."""
    return {"err": tree_map(lambda g: torch.zeros(
        g.shape, dtype=torch.float32, device=g.device), grads)}


def compressed_psum(grads, err, comm, *, scale_comms=()):
    """Error-feedback int8 mean of a gradient tree over ``comm``'s ranks:
    ``(mean_grads float32, new_err)``, trees like ``grads``.

    Each leaf ``gf = g + e`` (float32) is quantized with one scale
    (:func:`int8_compress`'s), the codes and the scales of every leaf are
    all-gathered over ``comm`` (int8 plus 4 bytes a leaf on the wire; one
    collective for the codes, one for the scales), and the mean is formed
    locally in float32, the ranks' dequantized codes added in rank order;
    the residual ``gf - q s`` stays on the rank.  ``scale_comms``: when the
    ranks of those comms each hold a shard of every tensor (a mesh inside
    each member of ``comm``), the comms over which the shards' ``max |gf|``
    are reduced (one collective each), so that each tensor's one scale and
    its codes are the whole tensor's.  Every rank calls it with the same
    leaves in the same order."""
    n = comm.size()
    gfs = [g.to(torch.float32) + e
           for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    amax = torch.stack([torch.maximum(-lo, hi) for lo, hi in
                        (torch.aminmax(gf) for gf in gfs)])
    for c in scale_comms:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=c.group)
    scales = torch.clamp(amax / 127.0, min=1e-30)
    codes = [(gf / s).round_().clamp_(-127, 127).to(torch.int8)
             for gf, s in zip(gfs, scales)]
    errs = [gf - int8_decompress(q, s)              # the residual stays
            for gf, q, s in zip(gfs, codes, scales)]
    qs = comm.all_gather(torch.cat([q.reshape(-1) for q in codes]))
    ss = comm.all_gather(scales)                    # (n, leaves) float32
    means, off = [], 0
    for i, q in enumerate(codes):
        mean = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for r in range(n):
            mean += qs[r, off:off + q.numel()].view(q.shape).to(
                torch.float32) * ss[r, i]
        means.append(mean / n)
        off += q.numel()
    it_m, it_e = iter(means), iter(errs)
    return (tree_map(lambda _: next(it_m), grads),
            tree_map(lambda _: next(it_e), grads))
