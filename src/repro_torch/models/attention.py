"""Grouped-query attention of the dense decoders.

Counterpart of ``repro.models.attention`` for the serving paths:
projections (QKV bias for qwen2, QK-norm for qwen3, rotary), the one
paged-attention call that paged decode and chunked prefill share, and
:func:`gqa_attention` over contiguous K/V for the dense per-slot path
(whole-prompt prefill through the flash-attention kernel, decode over the
slot cache in plain PyTorch).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.module import Param

NEG_INF = -1e30


def attention_def(cfg) -> dict:
    """Parameter tree for one attention block."""
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.padded_q_heads, cfg.padded_kv_heads
    defs = {
        "wq": Param((d, hq, hd), ("embed_w", "q_heads", "head_dim")),
        "wk": Param((d, hkv, hd), ("embed_w", "kv_heads", "head_dim")),
        "wv": Param((d, hkv, hd), ("embed_w", "kv_heads", "head_dim")),
        "wo": Param((hq, hd, d), ("q_heads", "head_dim", "embed_w")),
    }
    if cfg.qkv_bias:
        defs["bq"] = Param((hq, hd), ("q_heads", "head_dim"), init="zeros")
        defs["bk"] = Param((hkv, hd), ("kv_heads", "head_dim"),
                           init="zeros")
        defs["bv"] = Param((hkv, hd), ("kv_heads", "head_dim"),
                           init="zeros")
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


def paged_window_attention(q, k_pages, v_pages, tables, lengths, *,
                           k_scale=None, v_scale=None):
    """Attention for a window of queries against paged KV storage — chunked
    prefill, and decode through :func:`paged_decode_attention`.

    q: (B, W, Hq, D); k_pages/v_pages: (N, page_size, Hkv, D); tables:
    (B, P) int32 page ids; ``lengths``: (B,) int32 from
    :func:`window_lengths` (the reference takes ``n_cached`` here and adds
    the 1 itself, once per layer).  Window position w attends to the cached
    positions and to window positions <= w; every window token's K/V must
    already be in its page.  ``k_scale``/``v_scale``: None, or the
    (N, page_size, Hkv) float32 scales of int8 pages (dequantized in
    float32 where the keys are read).  Returns (B, W, Hq, D).
    """
    Hq, Hkv = q.shape[2], k_pages.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} must be a positive multiple of Hkv={Hkv}")
    return ops.paged_attention_mq(q, k_pages, v_pages, tables, lengths,
                                  k_scale, v_scale)


def paged_decode_attention(q, k_pages, v_pages, tables, lengths, *,
                           k_scale=None, v_scale=None):
    """Decode attention (one query per sequence): the W = 1 window of
    :func:`paged_window_attention`.  ``lengths``: (B,) int32 valid-KV counts
    including the current token (already written to its page) — which is
    already the window's ``lengths``."""
    if q.shape[1] != 1:
        raise ValueError(f"decode attention takes one query per sequence, "
                         f"got a window of {q.shape[1]}")
    return paged_window_attention(q, k_pages, v_pages, tables, lengths,
                                  k_scale=k_scale, v_scale=v_scale)


def _mask_bias(q_pos, k_pos, *, causal: bool, window: Optional[int],
               kv_valid_len=None):
    """Additive mask in float32, broadcastable against scores
    (B, Hkv, G, Sq, Sk).

    ``q_pos``: (Sq,) or (B, Sq) — per-batch offsets for ragged decode
    (every slot at its own position).  ``kv_valid_len``: None, an int, or a
    (B,) tensor.  Returns (Sq, Sk) or (B, 1, 1, Sq, Sk).
    """
    qp = q_pos[..., :, None]                       # (..., Sq, 1)
    kp = k_pos[None, :]                            # (1, Sk)
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                    dtype=torch.bool, device=kp.device)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= (qp - kp) < window
    ok = ok & (kp >= 0)                            # ring caches: unfilled slots
    if kv_valid_len is not None:
        kv = torch.as_tensor(kv_valid_len, device=kp.device)
        ok = ok & (kp < kv[..., None, None])
    mask = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
    if mask.ndim == 3:                             # (B, Sq, Sk) -> broadcast
        mask = mask[:, None, None]
    return mask


def _matmul_f32(a, b):
    """``a @ b`` over leading batch axes, accumulated and returned in
    float32: the reference's ``preferred_element_type``.  A bf16 pair on a
    card asks cuBLAS for the float32 result of the bf16 product; the CPU
    has no such product, so there both operands are widened first."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        batch = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]),
                        b.reshape(-1, *b.shape[-2:]), out_dtype=torch.float32)
        return out.reshape(*batch, *out.shape[-2:])
    return a.float() @ b.float()


def gqa_attention(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None, q_offset=0,
                  kv_valid_len=None, k_start=None, kv_chunk: int = 1024):
    """Online-softmax GQA over contiguous K/V.

    q: (B, Sq, Hq, D);  k, v: (B, Sk, Hkv, D), Hq % Hkv == 0.
    ``window``: an int for a sliding-window layer, None for a global one
    (the reference passes ``BIG_WINDOW`` there).  ``q_offset``: absolute
    position of q[0], an int or (B,) (ragged decode).  ``kv_valid_len``:
    live prefix of the KV buffers (decode caches), an int or (B,).
    ``k_start``: absolute position of k[0], an int (ring caches: the
    window decode reads its ring of W keys as one chunk, ``kv_chunk=W``, as
    the reference does, which raises for a ring over several chunks too;
    keys at negative positions are masked).  Returns
    (B, Sq, Hq, D) in q's dtype.

    Attention whose keys are every position up to the last query (an int
    ``q_offset``, ``Sk == q_offset + Sq``, no ``kv_valid_len``, no
    ``k_start``: whole-sequence attention, and a rank's block of queries
    under training's sequence parallelism) goes to
    :func:`repro_torch.kernels.ops.flash_attention`: the flash-attention
    kernel on a card, its plain version on the CPU.  The route follows the
    tensor's device; ``cfg.use_pallas`` is not consulted.  Everything else
    (decode caches, rings, whisper's cross-attention over its frames) is
    the reference's chunked online softmax in plain PyTorch.
    """
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5

    if (kv_valid_len is None and k_start is None
            and isinstance(q_offset, int) and q_offset >= 0
            and Sk == q_offset + Sq):
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)

    # (B, Hkv, G * Sq, D): the G query heads of a KV head stacked on rows
    qg = (q.reshape(B, Sq, Hkv, G, D) * scale).permute(0, 2, 3, 1, 4) \
        .reshape(B, Hkv, G * Sq, D)
    q_pos = torch.as_tensor(q_offset, device=q.device)[..., None] \
        + torch.arange(Sq, device=q.device)

    def block(state, kc, vc, k_pos):
        acc, m, l = state
        s = _matmul_f32(qg, kc.permute(0, 2, 3, 1)).reshape(
            B, Hkv, G, Sq, -1)
        s = s + _mask_bias(q_pos, k_pos, causal=causal, window=window,
                           kv_valid_len=kv_valid_len)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = _matmul_f32(p.to(vc.dtype).reshape(B, Hkv, G * Sq, -1),
                         vc.permute(0, 2, 1, 3)).reshape(B, Hkv, G, Sq, D)
        return acc * corr[..., None] + pv, m_new, l

    dev = q.device
    state = (torch.zeros(B, Hkv, G, Sq, D, dtype=torch.float32, device=dev),
             torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32,
                        device=dev),
             torch.zeros(B, Hkv, G, Sq, dtype=torch.float32, device=dev))
    k0 = 0 if k_start is None else k_start
    if Sk <= kv_chunk or Sk % kv_chunk != 0:
        state = block(state, k, v, k0 + torch.arange(Sk, device=dev))
    elif k_start is not None:
        raise NotImplementedError("k_start with chunked KV not needed: "
                                  "window caches fit one chunk")
    else:
        for off in range(0, Sk, kv_chunk):
            state = block(state, k[:, off:off + kv_chunk],
                          v[:, off:off + kv_chunk],
                          off + torch.arange(kv_chunk, device=dev))
    acc, _, l = state
    out = acc / torch.clamp(l[..., None], min=1e-30)      # (B,Hkv,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)
