"""Mamba-2 (SSD) blocks for serving and training.

Counterpart of ``repro.models.mamba2``.  The per-head recurrence
``S_t = exp(la_t) S_t-1 + B_t (outer) xdt_t``, ``y_t = C_t . S_t`` runs
through the SSD kernel (:func:`repro_torch.kernels.ops.ssd_scan`) for every
sequence length, prefill and decode alike; the reference's jnp chunked form
(``_ssd_chunked``) and its ``lax.scan`` are what the kernel replaces, and
they differ from it by rounding only.  Given states, the kernel writes the
final SSM state **in place** into the caller's and the block writes the
conv tails into theirs, so a layer's slice of the decode state is the
result.  Training passes no states: the scan starts from zeros, and on a
card its backward, and the gated norm's, are kernels too.

As in the reference, the projections and the conv output run in the
compute dtype, while ``A_log``, ``D``, ``dt_bias`` and the conv weights are
read in float32 (declared float32 here), the step sizes, decays and the SSD
inputs are float32, and the conv tails are kept in float32.

Over a training mesh (``mesh=``, a :class:`repro_torch.mesh.grad_comm.
TrainMesh`) a rank holds its block of positions and the layer's weights
whole (gathered by the caller).  The projections, the step sizes, the
``D`` skip, the gated norm and ``w_out`` run there as on one device.  The
causal conv reads the last K-1 pre-conv rows of the block before
(``mesh.prev_rows``, x, B and C in one permute).  The SSD scan runs on
whole heads over every position: ``xdt`` and the log decays go from
sequence blocks to head blocks (``mesh.seq_to_heads``), ``B`` and ``C``,
which every head reads, are gathered whole over the sequence (their
gradient the sum of every rank's), and ``y`` comes back.  So each rank's
scan keeps N = P = 64 at full width, the kernel's tensor-core route both
ways.  That is how the forward computes, not how it stores: the leaves
are still split at birth by the reference's rules (``inner``,
``ssm_heads``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.module import Param


def mamba2_def(cfg) -> dict:
    """Parameter tree of one Mamba-2 mixer."""
    d, di, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    K = cfg.conv_kernel
    f32 = torch.float32
    return {
        "w_z": Param((d, di), ("embed_w", "inner")),
        "w_x": Param((d, di), ("embed_w", "inner")),
        "w_B": Param((d, N), ("embed_w", None)),
        "w_C": Param((d, N), ("embed_w", None)),
        "w_dt": Param((d, H), ("embed_w", "ssm_heads")),
        "conv_x": Param((K, di), ("conv_k", "inner"), init="small",
                        dtype=f32),
        "conv_B": Param((K, N), ("conv_k", None), init="small", dtype=f32),
        "conv_C": Param((K, N), ("conv_k", None), init="small", dtype=f32),
        "A_log": Param((H,), ("ssm_heads",), init="zeros", dtype=f32),
        "D": Param((H,), ("ssm_heads",), init="ones", dtype=f32),
        "dt_bias": Param((H,), ("ssm_heads",), init="zeros", dtype=f32),
        "out_norm": L.rmsnorm_def(di),
        "w_out": Param((di, d), ("inner", "embed_w")),
    }


def _causal_conv(x, w, conv_state=None):
    """Depthwise causal conv with a SiLU.  x: (B, S, C), w: (K, C) float32.
    With ``conv_state`` (B, K-1, C) the history is prepended (decode), cast
    to ``x``'s dtype first; without it the history is zeros.  Accumulates
    in float32; the result keeps ``x``'s dtype."""
    K = w.shape[0]
    if conv_state is not None:
        x_pad = torch.cat([conv_state.to(x.dtype), x], dim=1)
    else:
        x_pad = F.pad(x, (0, 0, K - 1, 0))
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        out = out + x_pad[:, i:i + S].to(torch.float32) * w[i].to(torch.float32)
    return F.silu(out).to(x.dtype)


def mamba2_block(params, x, cfg, *, ssm_state=None, conv_state=None,
                 mesh=None):
    """x: (B, S, d) -> ``(y (B, S, d), ssm_state, conv_state)``.

    With states (prefill into a fresh state, and decode): ``ssm_state``
    (B, H, N, P) float32 is advanced in place by the kernel, and
    ``conv_state`` ``{"x", "B", "C"}`` of (B, K-1, C) float32 receives the
    last K-1 pre-conv rows in place.  Without them (no cache) the SSM state
    starts at zeros and a fresh final state is returned, with no conv
    tails.  ``mesh`` (training, no states): ``x`` is this rank's block of
    positions (the module's docstring)."""
    H, Pd, K = cfg.ssm_heads, cfg.ssm_head_dim, cfg.conv_kernel
    z = x @ params["w_z"]
    xc = x @ params["w_x"]
    Bm = x @ params["w_B"]
    Cm = x @ params["w_C"]
    dt = x @ params["w_dt"]

    pre = {"x": xc, "B": Bm, "C": Cm}
    hist = conv_state or {}
    if mesh is not None:        # the K-1 rows before this rank's block
        hist = dict(zip("xBC", mesh.prev_rows([xc, Bm, Cm], K - 1)))
    xc = _causal_conv(xc, params["conv_x"], hist.get("x"))
    Bm = _causal_conv(Bm, params["conv_B"], hist.get("B"))
    Cm = _causal_conv(Cm, params["conv_C"], hist.get("C"))
    if conv_state is not None:      # after the convs have read the history
        for k, new in pre.items():
            old = conv_state[k]
            old.copy_(torch.cat([old, new.to(old.dtype)], dim=1)[:, -(K - 1):])

    f32 = torch.float32
    dt = F.softplus(dt.to(f32) + params["dt_bias"].to(f32))          # (B,S,H)
    a = torch.exp(-torch.exp(params["A_log"].to(f32)) * dt)
    xh = xc.reshape(xc.shape[0], xc.shape[1], H, Pd)
    xdt = (xh * dt[..., None]).to(f32)
    la = torch.log(torch.clamp(a, min=1e-20))
    if mesh is not None:        # this rank's heads over every position
        xdt, la = mesh.seq_to_heads(xdt, la)
        Bm, Cm = mesh.gather_seq(Bm, Cm)
    y, ssm_state = ops.ssd_scan(xdt, la, Bm, Cm, ssm_state,
                                out_state=ssm_state)
    if mesh is not None:
        y, = mesh.heads_to_seq(y)
    y = y.to(xh.dtype) + xh.to(f32) * params["D"].to(f32)[:, None]
    y = y.reshape(xc.shape)

    y = L.gated_rmsnorm(params["out_norm"], y, z)       # z in x's dtype
    return y @ params["w_out"], ssm_state, conv_state


def init_mamba_state(cfg, batch: int, *, device) -> dict:
    """Zeroed state of one Mamba-2 layer: ``ssm`` (batch, H, N, P) and the
    conv tails ``conv`` ``{"x", "B", "C"}`` (batch, K-1, C), all float32."""
    H, Pd, N, K = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.conv_kernel
    f32 = torch.float32

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    return {"ssm": zeros(batch, H, N, Pd),
            "conv": {"x": zeros(batch, K - 1, cfg.d_inner),
                     "B": zeros(batch, K - 1, N),
                     "C": zeros(batch, K - 1, N)}}
