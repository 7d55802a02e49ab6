"""RWKV-6 (Finch) blocks for serving and training: attention-free token
mixing with a data-dependent decay.

Counterpart of ``repro.models.rwkv6``.  The per-head recurrence
``S_t = diag(w_t) S_t-1 + k_t v_t^T`` runs through the wkv kernel
(:func:`repro_torch.kernels.ops.rwkv6_scan`) for every sequence length,
prefill and decode alike; the reference's chunked matmul form
(``_wkv_chunked``) and its ``lax.scan`` are what the kernel replaces, and
they differ from it by rounding only.  Given a state, the kernel writes
the final state **in place** into it, so a layer's slice of the decode
state is the result.  Training passes no state: the scan starts from zeros
and its backward is the kernel's.

As in the reference, the projections, the token shift and the channel mix
run in the compute dtype, while the decay ``w``, the bonus ``u``, the wkv
output, ``ln_x``, the ``silu(g)`` gate and ``w_o`` work in float32: those
leaves are declared float32 (``decay_base``, ``u``, ``ln_x``, ``w_o``,
and ``ln1`` / ``ln2``).

Over a training mesh (``mesh=``, a :class:`repro_torch.mesh.grad_comm.
TrainMesh`) a rank holds its block of positions and the layer's weights
whole (gathered by the caller).  Everything per token runs there as on one
device: the projections, the gates, ``ln_x``, ``w_o`` and the channel
mix.  The token shift reads the last position of the block before
(``mesh.prev_rows``).  The wkv scan runs on whole heads over every
position: ``r``, ``k``, ``v`` and ``w`` go from sequence blocks to head
blocks (``mesh.seq_to_heads``, an all-to-all over the sequence's axis),
the rank takes its heads of ``u``, and ``y`` comes back.  So each rank's
scan keeps K = V = 64 at full width, the kernel's tensor-core route both
ways; the reference instead splits ``v`` over its value channels
(``rwkv_v``).  That is how the forward computes, not how it stores: the
leaves are still split at birth by the reference's rules.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.module import Param


def rwkv_block_def(cfg) -> dict:
    """Parameter tree of one RWKV-6 block (time mix + channel mix)."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    H = cfg.rwkv_heads
    f32 = torch.float32
    return {
        "ln1": L.layernorm_def(d),
        "ln2": L.layernorm_def(d),
        "tm": {  # time mix
            "mu_r": Param((d,), (None,), init="small"),
            "mu_k": Param((d,), (None,), init="small"),
            "mu_v": Param((d,), (None,), init="small"),
            "mu_g": Param((d,), (None,), init="small"),
            "mu_w": Param((d,), (None,), init="small"),
            "w_r": Param((d, H, hd), ("embed_w", None, None)),
            "w_k": Param((d, H, hd), ("embed_w", None, None)),
            "w_v": Param((d, H, hd), ("embed_w", None, "rwkv_v")),
            "w_g": Param((d, H, hd), ("embed_w", None, "rwkv_v")),
            "w_decay": Param((d, H, hd), ("embed_w", None, None),
                             init="small"),
            "decay_base": Param((H, hd), (None, None), init="zeros",
                                dtype=f32),
            "u": Param((H, hd), (None, None), init="small", dtype=f32),
            "ln_x": L.layernorm_def(H * hd),
            "w_o": Param((H, hd, d), (None, "rwkv_v", "embed_w"),
                         dtype=f32),
        },
        "cm": {  # channel mix
            "mu_k": Param((d,), (None,), init="small"),
            "mu_r": Param((d,), (None,), init="small"),
            "w_k": Param((d, cfg.d_ff), ("embed_w", "mlp")),
            "w_v": Param((cfg.d_ff, d), ("mlp", "embed_w")),
            "w_r": Param((d, d), ("embed_w", None)),
        },
    }


def _token_shift(x, x_prev=None):
    """(B, S, d) -> the previous token's activations: zeros before the
    first, or ``x_prev`` (B, 1, d), kept in float32 by the state, cast to
    ``x``'s dtype."""
    if x_prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([x_prev.to(x.dtype), x], dim=1)[:, :-1]


def _lerp(x, shifted, mu):
    """``x + (shifted - x) * mu`` in ``x``'s dtype."""
    return x + (shifted - x) * mu.to(x.dtype)


def time_mix(p, x, cfg, *, state=None, x_prev=None, mesh=None):
    """Returns ``(out, state, last_x)``.  ``state``: (B, H, K, V) float32,
    updated in place (zeros, in a fresh tensor, when None: training's
    case, where autograd differentiates the scan).  ``mesh``: ``x`` is
    this rank's block of positions (the module's docstring)."""
    B, S, d = x.shape
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    if mesh is not None:
        x_prev = mesh.prev_rows([x], 1)[0]
    sx = _token_shift(x, x_prev)

    def project(mu, w):
        return (_lerp(x, sx, p[mu]) @ p[w].reshape(d, H * hd)).view(B, S, H,
                                                                    hd)

    r = project("mu_r", "w_r")
    k = project("mu_k", "w_k")
    v = project("mu_v", "w_v")
    g = project("mu_g", "w_g")
    wlog = project("mu_w", "w_decay")
    # data-dependent decay in (0, 1): w = exp(-exp(base + wlog)), float32
    w = torch.exp(-torch.exp(p["decay_base"].to(torch.float32)
                             + wlog.to(torch.float32)))        # (B, S, H, K)
    u = p["u"].to(torch.float32)
    if mesh is not None:        # this rank's heads over every position
        r, k, v, w = mesh.seq_to_heads(r, k, v, w)
        u = mesh.own_heads(u)
    y, state = ops.rwkv6_scan(r, k, v, w, u, state, out_state=state)
    if mesh is not None:
        y, = mesh.heads_to_seq(y)
    y = L.layernorm(p["ln_x"], y.reshape(B, S, H * hd))        # float32
    y = y.view(B, S, H, hd) * F.silu(g.to(y.dtype))
    w_o = p["w_o"].reshape(H * hd, d).to(y.dtype)
    out = y.reshape(B, S, H * hd) @ w_o
    return out.to(x.dtype), state, x[:, -1:]


def channel_mix(p, x, *, x_prev=None, mesh=None):
    """The squared-ReLU FFN with a sigmoid receptance gate; returns
    ``(out, last_x)``.  ``mesh``: ``x`` is this rank's block of
    positions."""
    if mesh is not None:
        x_prev = mesh.prev_rows([x], 1)[0]
    sx = _token_shift(x, x_prev)
    k = torch.square(torch.relu(_lerp(x, sx, p["mu_k"]) @ p["w_k"]))
    kv = k @ p["w_v"]
    r = torch.sigmoid(_lerp(x, sx, p["mu_r"]) @ p["w_r"])
    return r * kv, x[:, -1:]


def rwkv_block(params, x, cfg, *, tm_state=None, tm_prev=None,
               cm_prev=None, mesh=None):
    """Pre-norm block: returns ``(x, wkv state, tm last_x, cm last_x)``;
    ``mesh``: training over a mesh, ``x`` this rank's block of
    positions."""
    h = L.layernorm(params["ln1"], x)
    o, new_state, new_tm_prev = time_mix(params["tm"], h, cfg,
                                         state=tm_state, x_prev=tm_prev,
                                         mesh=mesh)
    x = x + o
    h = L.layernorm(params["ln2"], x)
    o, new_cm_prev = channel_mix(params["cm"], h, x_prev=cm_prev, mesh=mesh)
    return x + o, new_state, new_tm_prev, new_cm_prev
