"""Grouped-query attention of the dense decoders, against paged KV storage.

Counterpart of ``repro.models.attention`` for the paged serving path:
projections (QKV bias for qwen2, QK-norm for qwen3, rotary) and the one
paged-attention call that decode and chunked prefill share.  The dense
``gqa_attention`` path of the reference (prefill without pages, training)
is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.module import Param


def attention_def(cfg) -> dict:
    """Parameter tree for one attention block."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.padded_q_heads, cfg.padded_kv_heads
    defs = {
        "wq": Param((d, hq, hd)),
        "wk": Param((d, hkv, hd)),
        "wv": Param((d, hkv, hd)),
        "wo": Param((hq, hd, d)),
    }
    if cfg.qkv_bias:
        defs["bq"] = Param((hq, hd), init="zeros")
        defs["bk"] = Param((hkv, hd), init="zeros")
        defs["bv"] = Param((hkv, hd), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = L.rmsnorm_def(hd)
        defs["k_norm"] = L.rmsnorm_def(hd)
    return defs


def _heads(x, w):
    """(B, S, d) @ (d, H, D) -> (B, S, H, D)."""
    d, H, D = w.shape
    return (x @ w.reshape(d, H * D)).reshape(*x.shape[:-1], H, D)


def qkv_project(params, x, cfg, positions):
    """x: (B, S, d) -> q (B, S, Hq, D), k/v (B, S, Hkv, D), rotary applied."""
    q = _heads(x, params["wq"])
    k = _heads(x, params["wk"])
    v = _heads(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        q = L.rmsnorm(params["q_norm"], q)
        k = L.rmsnorm(params["k_norm"], k)
    if cfg.rope_theta:
        q = L.rope(q, positions, theta=cfg.rope_theta)
        k = L.rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def out_project(params, o):
    """(B, S, Hq, D) -> (B, S, d)."""
    H, D, d = params["wo"].shape
    return o.reshape(*o.shape[:-2], H * D) @ params["wo"].reshape(H * D, d)


def window_lengths(n_cached, batch: int, device):
    """The kernel's ``lengths`` for a window after ``n_cached`` cached
    tokens (an int or a (B,) tensor): valid keys of window position 0, its
    own included — ``n_cached + 1`` as (B,) int32.  A step builds it once
    and every layer's attention reads the same tensor."""
    if isinstance(n_cached, torch.Tensor):
        return (n_cached.to(torch.int32) + 1).expand(batch).contiguous()
    # filled on the device: no host-to-device copy
    return torch.full((batch,), int(n_cached) + 1, dtype=torch.int32,
                      device=device)


def paged_window_attention(q, k_pages, v_pages, tables, lengths):
    """Attention for a window of queries against paged KV storage — chunked
    prefill, and decode through :func:`paged_decode_attention`.

    q: (B, W, Hq, D); k_pages/v_pages: (N, page_size, Hkv, D); tables:
    (B, P) int32 page ids; ``lengths``: (B,) int32 from
    :func:`window_lengths` (the reference takes ``n_cached`` here and adds
    the 1 itself, once per layer).  Window position w attends to the cached
    positions and to window positions <= w; every window token's K/V must
    already be in its page.  Returns (B, W, Hq, D).
    """
    Hq, Hkv = q.shape[2], k_pages.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a positive multiple of Hkv={Hkv}")
    return ops.paged_attention_mq(q, k_pages, v_pages, tables, lengths)


def paged_decode_attention(q, k_pages, v_pages, tables, lengths):
    """Decode attention (one query per sequence): the W = 1 window of
    :func:`paged_window_attention`.  ``lengths``: (B,) int32 valid-KV counts
    including the current token (already written to its page) — which is
    already the window's ``lengths``."""
    if q.shape[1] != 1:
        raise ValueError(f"decode attention takes one query per sequence, "
                         f"got a window of {q.shape[1]}")
    return paged_window_attention(q, k_pages, v_pages, tables, lengths)
