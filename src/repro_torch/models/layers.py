"""Shared layers of the served models (functional; params are dicts of
tensors already in the dtype they are read in).

Counterpart of ``repro.models.layers``.  The reference keeps float32
params and casts them at every call; the port casts once when the params
are made or loaded, which gives the same values where the reference casts
to the compute dtype.  A leaf the reference reads in float32 whatever the
compute dtype (the layernorm's scale and bias) is declared float32
(``Param(dtype=...)``) and stays so.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.module import Param


def rmsnorm_def(dim: int) -> dict:
    """Declaration of one RMSNorm scale."""
    return {"scale": Param((dim,), (None,), init="ones")}


def rmsnorm(params, x, *, eps: float = 1e-6):
    """Row-wise RMSNorm over the last axis: the RMSNorm kernel on a card,
    its plain version on the CPU."""
    return ops.rmsnorm(x, params["scale"], eps=eps)


def add_rmsnorm(params, x, delta, *, eps: float = 1e-6):
    """The residual stream ``x + delta`` and its RMSNorm, ``(stream,
    normed)``, in one kernel; with ``delta`` None (nothing pending: the
    first norm of a model) the stream is ``x`` and only the norm runs."""
    if delta is None:
        return x, rmsnorm(params, x, eps=eps)
    return ops.add_rmsnorm(x, delta, params["scale"], eps=eps)


def final_rmsnorm(params, x, delta, *, eps: float = 1e-6):
    """The RMSNorm of ``x + delta`` (``x`` with ``delta`` None) after a
    model's last block: as :func:`add_rmsnorm`, but the stream, which no op
    reads after it, is not stored."""
    if delta is None:
        return rmsnorm(params, x, eps=eps)
    return ops.add_rmsnorm(x, delta, params["scale"], eps=eps,
                           keep_sum=False)[1]


def gated_rmsnorm(params, y, z, *, eps: float = 1e-6):
    """Mamba-2's gated norm ``rmsnorm(y.to(z.dtype) * silu(z))`` in one
    kernel; y float32, the result in z's dtype."""
    return ops.gated_rmsnorm(y, z, params["scale"], eps=eps)


def layernorm_def(dim: int) -> dict:
    """Declaration of one LayerNorm's scale and bias (kept in float32)."""
    return {"scale": Param((dim,), (None,), init="ones",
                           dtype=torch.float32),
            "bias": Param((dim,), (None,), init="zeros",
                          dtype=torch.float32)}


def layernorm(params, x, *, eps: float = 1e-5):
    """LayerNorm over the last axis, in float32 with float32 scale and bias;
    the result keeps ``x``'s dtype.  No kernel: the reference has none."""
    xf = x.to(torch.float32)
    var, mu = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)
            + params["bias"].to(torch.float32)).to(x.dtype)


def embedding_def(vocab: int, dim: int) -> dict:
    """Declaration of one embedding table."""
    return {"table": Param((vocab, dim), ("vocab", "embed"), init="small")}


def embed(params, tokens):
    """Table lookup: (..., ) int tokens -> (..., d)."""
    return params["table"][tokens.long()]


def unembed(params, x):
    """Tied unembedding: (B, S, d) @ (V, d)^T -> (B, S, V) in float32."""
    return x.float() @ params["table"].float().T


def linear(params, x):
    """``x @ w (+ b)``."""
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def mlp_def(d_model: int, d_ff: int) -> dict:
    """Declaration of the gated (SwiGLU) MLP."""
    return {
        "gate": Param((d_model, d_ff), ("embed_w", "mlp")),
        "up": Param((d_model, d_ff), ("embed_w", "mlp")),
        "down": Param((d_ff, d_model), ("mlp", "embed_w")),
    }


def mlp(params, x):
    """SwiGLU: ``(silu(x @ gate) * (x @ up)) @ down``."""
    return (F.silu(x @ params["gate"]) * (x @ params["up"])) @ params["down"]


def mlp_plain_def(d_model: int, d_ff: int) -> dict:
    """Declaration of the non-gated FFN with biases (whisper's)."""
    return {
        "up": Param((d_model, d_ff), ("embed_w", "mlp")),
        "up_b": Param((d_ff,), ("mlp",), init="zeros"),
        "down": Param((d_ff, d_model), ("mlp", "embed_w")),
        "down_b": Param((d_model,), (None,), init="zeros"),
    }


def mlp_plain(params, x):
    """``gelu(x @ up + up_b) @ down + down_b`` with the tanh GELU, which is
    ``jax.nn.gelu``'s default (torch's default is the erf form)."""
    h = F.gelu(x @ params["up"] + params["up_b"], approximate="tanh")
    return h @ params["down"] + params["down_b"]


def sinusoidal_pos(positions, dim: int, *, base: float = 10000.0):
    """(S,) int positions -> (S, dim) float32 sinusoidal embeddings (whisper's
    encoder and decoder): ``[sin, cos]`` of ``positions * base ** (-i /
    max(half - 1, 1))``."""
    half = dim // 2
    freqs = base ** (-torch.arange(half, dtype=torch.float32,
                                   device=positions.device)
                     / max(half - 1, 1))
    ang = positions[:, None].to(torch.float32) * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
