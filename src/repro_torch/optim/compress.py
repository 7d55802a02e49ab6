"""Symmetric int8 quantization, per tensor or per axis.

Counterpart of ``repro.optim.compress``'s ``int8_compress`` and
``int8_decompress``: ``q = clip(round(g / s), -127, 127)`` with
``s = max(max|g| / 127, 1e-30)``, over the whole tensor (``axis=None``:
one scalar scale, the per-tensor weight format) or over one axis (the KV
page format: one scale per remaining index).  ``torch.round`` rounds half
to even, as ``jnp.round`` does, and the division is a true division, so
identical inputs give identical codes and scales in both packages.

The error-feedback all-reduce (``compressed_psum``) comes with training
over ``torch.distributed`` (ROADMAP A13b).  Quantizing works on one
float32 copy of ``g`` in place, and dequantizing writes its result in one
pass, so a multi-gigabyte weight never meets a chain of float32
temporaries.
"""
from __future__ import annotations

__all__ = ["int8_compress", "int8_decompress"]

import torch


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
