"""Paged multi-query attention: the CUDA kernel's launcher and its plain
PyTorch version.

A window of W queries per sequence attends to a KV prefix held in
fixed-size pages (:mod:`repro_torch.serve.pages`) through a ``(B, P)``
page table.  Window position w reads KV positions ``< lengths[b] + w``:
``lengths`` counts the valid entries including window position 0's token,
and every window token's K/V is in its page before the call.  Decode is
the W = 1 window; a page-aligned prefill chunk is a W = chunk window of
one sequence.

With int8 pages (``serve/quant.py``), ``k_scale``/``v_scale`` of shape
(N, page_size, Hkv) hold one float32 scale per cached row and KV head, and
attention reads each key and value as ``float(code) * scale``.

The kernel (``csrc/paged_attention.cu``) replaces the TPU kernel
``repro/kernels/paged_attention.py:paged_attention_mq``, float and int8
pages alike; its source note says what bounds it on Hopper and how the
design answers that.  It splits the keys over blocks of
:data:`SPLIT_KEYS` positions (:func:`split_count`), each writing a float32
partial ``(m, l, acc)`` that a combine kernel merges.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
SPLIT_KEYS = 64                  # key positions a block of the kernel takes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def split_count(pages_per_seq: int, page_size: int) -> int:
    """The kernel's key splits for a ``(B, pages_per_seq)`` table: one per
    :data:`SPLIT_KEYS` positions of the table's capacity.  It reads shapes
    only, never the lengths, so a CUDA graph can hold the call."""
    return -(-pages_per_seq * page_size // SPLIT_KEYS)


def paged_attention_mq_plain(q, k_pages, v_pages, tables, lengths,
                             k_scale=None, v_scale=None):
    """Paged attention by explicit gather: the CPU path and the kernel's
    oracle.

    q: (B, W, Hq, D); k_pages/v_pages: (N, page_size, Hkv, D); tables:
    (B, P) int page ids; lengths: (B,) valid-KV counts for window position
    0; k_scale/v_scale: None, or (N, page_size, Hkv) float32 scales of int8
    pages, applied in float32 after the gather.  Returns (B, W, Hq, D);
    rows with no valid key (dead slots) are zero.
    """
    B, W, Hq, D = q.shape
    _, ps, Hkv, _ = k_pages.shape
    P = tables.shape[1]
    G = Hq // Hkv
    t = tables.long()
    k = k_pages[t].reshape(B, P * ps, Hkv, D).to(torch.float32)
    v = v_pages[t].reshape(B, P * ps, Hkv, D).to(torch.float32)
    if k_scale is not None:
        k = k * k_scale[t].reshape(B, P * ps, Hkv, 1).to(torch.float32)
        v = v * v_scale[t].reshape(B, P * ps, Hkv, 1).to(torch.float32)
    qg = q.reshape(B, W, Hkv, G, D).to(torch.float32) * D ** -0.5
    s = torch.einsum("bwhgd,bkhd->bhgwk", qg, k)
    limit = (lengths.long()[:, None]
             + torch.arange(W, device=q.device)[None, :])            # (B, W)
    ok = (torch.arange(P * ps, device=q.device)[None, None, :]
          < limit[..., None])                                        # (B, W, Sk)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgwk,bkhd->bwhgd", p, v)
    o = torch.where((limit > 0)[:, :, None, None, None], o, 0.0)
    return o.reshape(B, W, Hq, D).to(q.dtype)


def paged_attention_mq_cuda(q, k_pages, v_pages, tables, lengths,
                            k_scale=None, v_scale=None):
    """Launch the paged-attention kernel on ``q``'s card (current stream).
    Shapes as in :func:`paged_attention_mq_plain`.  q is float32 or
    bfloat16; the pages share its dtype, or are int8 with both scales
    (float32, (N, page_size, Hkv), contiguous).  D is a multiple of 8 up to
    256, of 16 for int8 pages.  Raises on anything else; never falls
    back.  bf16 q runs on tensor cores (mma.sync), float32 q on CUDA
    cores.  With more than one split (:func:`split_count`) the call is two
    launches, the split kernel and the combine, and allocates float32
    partials of ``B * W * Hq * n_split * (D + 2)`` elements."""
    B, W, Hq, D = q.shape
    N, ps, Hkv, Dk = k_pages.shape
    P = tables.shape[-1]
    dev = q.device
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention_mq_cuda: int8 pages need both "
                         "k_scale and v_scale")
    quantized = k_scale is not None
    scales = (("k_scale", k_scale), ("v_scale", v_scale)) if quantized else ()
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lengths", lengths)) + scales:
        if t.device != dev:
            raise ValueError(f"paged_attention_mq_cuda: {name} on {t.device}, "
                             f"q on {dev}")
    if not q.is_cuda:
        raise ValueError("paged_attention_mq_cuda: q must lie on a card")
    kv_dtype = torch.int8 if quantized else q.dtype
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k_pages.dtype != kv_dtype or v_pages.dtype != kv_dtype:
        raise TypeError(f"paged_attention_mq_cuda: dtypes q={q.dtype} "
                        f"k={k_pages.dtype} v={v_pages.dtype}; want q in "
                        "float32/bfloat16 and pages of q's dtype, or int8 "
                        "pages with k_scale and v_scale")
    if v_pages.shape != k_pages.shape or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"paged_attention_mq_cuda: q {tuple(q.shape)} vs "
                         f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if D % 8 or D > 256 or (quantized and D % 16):
        raise ValueError(f"paged_attention_mq_cuda: head dim {D} must be a "
                         f"multiple of {16 if quantized else 8} up to 256"
                         + (" for int8 pages (16 codes a 16-byte load)"
                            if quantized else ""))
    if tables.shape != (B, P) or lengths.shape != (B,):
        raise ValueError(f"paged_attention_mq_cuda: tables "
                         f"{tuple(tables.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match B={B}")
    for name, t in scales:
        if t.dtype != torch.float32:
            raise TypeError(f"paged_attention_mq_cuda: {name} is {t.dtype}, "
                            "want float32")
        if tuple(t.shape) != (N, ps, Hkv) or not t.is_contiguous():
            raise ValueError(f"paged_attention_mq_cuda: {name} "
                             f"{tuple(t.shape)} must be a contiguous "
                             f"{(N, ps, Hkv)} (one scale a row and head)")
    q = q.contiguous()
    k_pages, v_pages = k_pages.contiguous(), v_pages.contiguous()
    tables = tables.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:
            raise ValueError(f"paged_attention_mq_cuda: {name} is not "
                             "16-byte aligned")
    out = torch.empty_like(q)
    n_split = split_count(P, ps)
    part_acc = part_ml = None
    if n_split > 1:
        rows = B * W * Hq * n_split
        part_acc = torch.empty(rows * D, dtype=torch.float32, device=dev)
        part_ml = torch.empty(rows * 2, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.paged_attention_mq_launch(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr(),
            B, W, Hq, Hkv, D, ps, P, n_split, float(D ** -0.5),
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[kv_dtype], stream),
            "paged_attention_mq")
    return out
