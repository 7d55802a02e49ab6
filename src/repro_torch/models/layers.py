"""Shared layers of the dense decoder path (functional; params are dicts of
tensors already in the compute dtype).

Counterpart of ``repro.models.layers``.  The reference keeps float32
params and casts them at every call; the port casts once when the params
are made or loaded, which gives the same values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.module import Param


def rmsnorm_def(dim: int) -> dict:
    """Declaration of one RMSNorm scale."""
    return {"scale": Param((dim,), init="ones")}


def rmsnorm(params, x, *, eps: float = 1e-6):
    """Row-wise RMSNorm over the last axis: the RMSNorm kernel on a card,
    its plain version on the CPU."""
    return ops.rmsnorm(x, params["scale"], eps=eps)


def embed(params, tokens):
    """Table lookup: (..., ) int tokens -> (..., d)."""
    return params["table"][tokens.long()]


def linear(params, x):
    """``x @ w (+ b)``."""
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def mlp_def(d_model: int, d_ff: int) -> dict:
    """Declaration of the gated (SwiGLU) MLP."""
    return {
        "gate": Param((d_model, d_ff)),
        "up": Param((d_model, d_ff)),
        "down": Param((d_ff, d_model)),
    }


def mlp(params, x):
    """SwiGLU: ``(silu(x @ gate) * (x @ up)) @ down``."""
    return (F.silu(x @ params["gate"]) * (x @ params["up"])) @ params["down"]


def rope(x, positions, *, theta: float = 10000.0):
    """Rotary embedding.  x: (..., S, H, D); positions: (..., S) ints.

    The angles are float32, so a bf16 ``x`` is rotated in float32 and cast
    back, as in the reference."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs      # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
