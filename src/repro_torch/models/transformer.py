"""Dense decoder-only LM for serving: on paged KV storage, and on the
dense per-slot cache.

Counterpart of the serving half of ``repro.models.transformer``, without
the mesh transport, MoE or precomputed embeds.  Params keep the
reference's keys and shapes, with ``params["blocks"]`` stacked on a
leading layer axis.

The paged path also serves int8 KV pages (a ``quant`` policy from
:mod:`repro_torch.serve.quant`: K/V are quantized on write, their scales
ride sibling storage leaves, attention dequantizes) and int8 weights: a
``{"q8", "s8"}`` pair anywhere in the params is dequantized where it is
used, to the compute dtype — a block's inside the layer loop, so the
full-precision copy exists for one layer at a time, the embedding after
its rows are gathered, the unembedding in :func:`lm_logits`.  The scales
are per tensor, so these give the numbers of the reference's whole-tree
dequantization followed by its cast to the compute dtype at use.

The reference scans the layers with ``jax.lax.scan`` and returns updated
storage or caches; here a Python loop walks the layers, and each decode or
paged-prefill step writes its fresh K/V **in place** into that layer's view
of the storage or cache tensors, so the caller's single copy is the result.

The dense path (:func:`prefill`, :func:`decode_step`) serves global-
attention families; the window/ring caches of gemma3 come with the
non-paged families' slice and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.module import Param, torch_dtype, tree_map
from repro_torch.serve import pages as PG
from repro_torch.serve import quant as QZ


def stack_defs(defs, n: int):
    """Prepend a stacked layer axis to every Param in a layer def tree."""
    return tree_map(lambda p: Param((n,) + tuple(p.shape), init=p.init,
                                    dtype=p.dtype), defs)


def block_defs(cfg) -> dict:
    """Parameter tree of one dense decoder block."""
    if cfg.n_experts:
        raise NotImplementedError("MoE blocks are not ported yet")
    return {
        "ln1": L.rmsnorm_def(cfg.d_model),
        "attn": A.attention_def(cfg),
        "ln2": L.rmsnorm_def(cfg.d_model),
        "mlp": L.mlp_def(cfg.d_model, cfg.d_ff),
    }


def transformer_defs(cfg) -> dict:
    """Parameter tree of the whole decoder (blocks stacked)."""
    return {
        "embed": {"table": Param((cfg.padded_vocab, cfg.d_model),
                                 init="small")},
        "blocks": stack_defs(block_defs(cfg), cfg.n_layers),
        "final_norm": L.rmsnorm_def(cfg.d_model),
        "unembed": {"w": Param((cfg.d_model, cfg.padded_vocab),
                               init="small")},
    }


def embed_tokens(params, tokens, dtype=None):
    """(B, S) tokens -> (B, S, d) in the params' (compute) dtype; the rows
    of an int8 table are gathered, then dequantized to ``dtype``."""
    table = params["embed"]["table"]
    if QZ.is_q8(table):
        rows = {"q8": table["q8"][tokens.long()], "s8": table["s8"]}
        return QZ.dequantize_params(rows, dtype)
    return L.embed(params["embed"], tokens)


def lm_logits(params, hidden):
    """(B, S, d) -> (B, S, V) logits in float32.

    The reference multiplies in the compute dtype and accumulates into a
    float32 result (``preferred_element_type``).  Here a float32 model
    multiplies in float32; a bf16 model on a card asks cuBLAS for a float32
    output of the bf16 product (``torch.mm(..., out_dtype=float32)``), and
    on the CPU, which has no such product, both bf16 operands are widened
    to float32 first (their values are exact in float32).  An int8
    unembedding is dequantized to the hidden states' dtype first."""
    w = params["unembed"]["w"]
    if QZ.is_q8(w):
        w = QZ.dequantize_params(w, hidden.dtype)
    h = hidden.reshape(-1, hidden.shape[-1])
    if h.dtype == torch.float32:
        out = h @ w
    elif h.is_cuda:
        out = torch.mm(h, w, out_dtype=torch.float32)
    else:
        out = h.float() @ w.float()
    return out.reshape(*hidden.shape[:-1], w.shape[-1])


def layer_windows(cfg) -> list:
    """Per-layer attention window: an int for a sliding-window layer, None
    for a global one (where the reference holds ``BIG_WINDOW``)."""
    return [cfg.window_for_layer(i) for i in range(cfg.n_layers)]


def uses_window_cache(cfg) -> bool:
    """gemma3's mixed cache: ring buffers for its sliding-window layers."""
    return bool(cfg.local_window and cfg.global_every)


def _check_dense(cfg):
    if uses_window_cache(cfg):
        raise NotImplementedError(
            f"{cfg.name}: window/ring caches are not ported yet: they come "
            "with the non-paged families slice (ROADMAP A11)")


def _layer(tree, i: int):
    """Layer ``i``'s view of a stacked (params or storage) tree.  An int8
    weight ``{"q8", "s8"}`` is one leaf: its codes are sliced, its one
    0-dim scale is shared by every layer."""
    if QZ.is_q8(tree):
        return {"q8": tree["q8"][i], "s8": tree["s8"]}
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _write_kv(kv, k, v, quant, scatter) -> None:
    """Commit fresh K/V into one layer's page storage, in place.  With a
    ``quant`` policy the values are quantized first and their per-row
    scales go through the same ``scatter`` into ``k_scale``/``v_scale``."""
    if quant is None:
        scatter(kv["k"], k)
        scatter(kv["v"], v)
        return
    qk, sk = quant.quantize(k)
    qv, sv = quant.quantize(v)
    scatter(kv["k"], qk)
    scatter(kv["v"], qv)
    scatter(kv["k_scale"], sk)
    scatter(kv["v_scale"], sv)


def _paged_block(p, x, delta, cfg, *, positions, kv, write, attend):
    """One decoder block against one layer's page storage ``kv``.

    ``delta`` is the previous block's MLP output, not yet added to the
    residual stream ``x`` (None before the first block): the add runs
    inside this block's first norm, as the attention output's does inside
    its second.  ``write(kv, k, v)`` commits the fresh K/V into pages (a
    whole-chunk scatter in prefill, a per-slot token scatter in decode)
    before ``attend(q, kv)`` reads them.  Returns ``(x, delta)``: the
    stream and this block's pending MLP output."""
    x, h = L.add_rmsnorm(p["ln1"], x, delta)
    q, k, v = A.qkv_project(p["attn"], h, cfg, positions)
    write(kv, k, v)
    o = attend(q, kv)
    x, h = L.add_rmsnorm(p["ln2"], x, A.out_project(p["attn"], o))
    return x, L.mlp(p["mlp"], h)


def _check_paged(cfg):
    if uses_window_cache(cfg):
        raise NotImplementedError("paged decode is global-attention only")


def _blocks(params, cfg):
    """Each layer's params in turn, int8 weights dequantized to the
    compute dtype one layer at a time."""
    dtype = torch_dtype(cfg.dtype)
    for i in range(cfg.n_layers):
        yield QZ.dequantize_params(_layer(params["blocks"], i), dtype)


def paged_prefill_chunk(params, cfg, storage, table_row, pages_chunk, start,
                        tokens, quant=None):
    """Prefill one page-aligned prompt chunk into paged storage, in place.

    storage: {"k", "v"} of (L, N, page_size, Hkv, D), plus
    {"k_scale", "v_scale"} of (L, N, page_size, Hkv) with a ``quant``
    policy;  table_row: (P,) the slot's page table;  pages_chunk:
    (C // page_size,) pages covering positions [start, start + C);  start:
    int;  tokens: (1, C), right-padded (the validity length masks pad
    garbage).  Returns the final hidden states (1, C, d)."""
    _check_paged(cfg)
    page_size = storage["k"].shape[2]
    x = embed_tokens(params, tokens, torch_dtype(cfg.dtype))
    C = x.shape[1]
    positions = start + torch.arange(C, device=x.device)
    tables = table_row[None]
    lengths = A.window_lengths(start, 1, x.device)     # shared by all layers

    def write(kv, k, v):
        _write_kv(kv, k[0], v[0], quant,
                  lambda st, val: PG.scatter_chunk(st, pages_chunk, val,
                                                   page_size=page_size))

    def attend(q, kv):
        return A.paged_window_attention(q, kv["k"], kv["v"], tables, lengths,
                                        k_scale=kv.get("k_scale"),
                                        v_scale=kv.get("v_scale"))

    delta = None
    for i, p in enumerate(_blocks(params, cfg)):
        x, delta = _paged_block(p, x, delta, cfg, positions=positions,
                                kv=_layer(storage, i), write=write,
                                attend=attend)
    return L.final_rmsnorm(params["final_norm"], x, delta)


def paged_decode_step(params, cfg, storage, tables, lengths, tokens,
                      write_pages, write_offs, quant=None):
    """One token for every slot against paged storage, in place.

    tokens: (B, 1);  tables: (B, P);  lengths: (B,) tokens already cached
    (= the current token's position);  write_pages/write_offs: (B,) where
    each slot's new K/V lands (dead slots point at the pool's trash page);
    quant as in :func:`paged_prefill_chunk`.  Returns float32 logits
    (B, 1, V)."""
    _check_paged(cfg)
    x = embed_tokens(params, tokens, torch_dtype(cfg.dtype))
    positions = lengths[:, None]
    # valid keys including the current token; one tensor for all layers
    valid = A.window_lengths(lengths, lengths.shape[0], x.device)

    def write(kv, k, v):
        _write_kv(kv, k[:, 0], v[:, 0], quant,
                  lambda st, val: PG.scatter_token(st, write_pages,
                                                   write_offs, val))

    def attend(q, kv):
        return A.paged_decode_attention(q, kv["k"], kv["v"], tables, valid,
                                        k_scale=kv.get("k_scale"),
                                        v_scale=kv.get("v_scale"))

    delta = None
    for i, p in enumerate(_blocks(params, cfg)):
        x, delta = _paged_block(p, x, delta, cfg, positions=positions,
                                kv=_layer(storage, i), write=write,
                                attend=attend)
    return lm_logits(params, L.final_rmsnorm(params["final_norm"], x, delta))


def paged_verify_chunk(params, cfg, storage, tables, lengths, tokens,
                       write_pages, write_offs, quant=None):
    """Score a per-slot window of candidate tokens in one batched forward,
    in place — the speculative-decode verify step.

    tokens: (B, C) — position 0 is each slot's next input token (its K/V
    not yet cached), positions 1..C-1 draft continuations (right-padded
    for slots with shorter windows);  tables: (B, P);  lengths: (B,) tokens
    already cached (= the position of tokens[:, 0]);  write_pages /
    write_offs: (B, C) where each position's K/V lands (pad and dead-slot
    positions point at the pool's trash page);  quant as in
    :func:`paged_prefill_chunk`.  Returns float32 logits (B, C, V):
    logits[:, i] scores the token following tokens[:, i].  C == 1 is a
    decode step.

    Every window position's K/V is written before attention runs, and
    paged attention scores the whole (B, C) window in one call, window
    position i seeing keys below ``lengths + i + 1``; pad positions only
    influence pad logits."""
    _check_paged(cfg)
    x = embed_tokens(params, tokens, torch_dtype(cfg.dtype))
    C = x.shape[1]
    positions = lengths[:, None] + torch.arange(C, device=x.device)
    valid = A.window_lengths(lengths, lengths.shape[0], x.device)

    def write(kv, k, v):
        _write_kv(kv, k, v, quant,
                  lambda st, val: PG.scatter_window(st, write_pages,
                                                    write_offs, val))

    def attend(q, kv):
        return A.paged_window_attention(q, kv["k"], kv["v"], tables, valid,
                                        k_scale=kv.get("k_scale"),
                                        v_scale=kv.get("v_scale"))

    delta = None
    for i, p in enumerate(_blocks(params, cfg)):
        x, delta = _paged_block(p, x, delta, cfg, positions=positions,
                                kv=_layer(storage, i), write=write,
                                attend=attend)
    return lm_logits(params, L.final_rmsnorm(params["final_norm"], x, delta))


# ---------------------------------------------------------------------------
# Dense per-slot cache (the engine's paged=False path)
# ---------------------------------------------------------------------------

def block_apply(p, x, cfg, *, positions, window, delta=None, cache_k=None,
                cache_v=None, cache_pos=None):
    """Pre-norm block.  Returns ``(x, delta, k, v)``: the residual stream,
    this block's MLP output not yet added to it (the next norm adds it; the
    ``delta`` passed in is the previous block's, None before the first), and
    the fresh K/V of this layer without a cache (whole-prompt prefill), the
    cache itself with one.

    With a cache (decode), ``cache_k``/``cache_v`` are this layer's
    (B, max_len, Hkv, D) views of the stacked cache: the new K/V are written
    at each slot's ``cache_pos`` (an int, or (B,) for ragged slots) **in
    place** with ``index_put_`` on those views, then the queries attend over
    the whole cache, masked by ``cache_pos + S``.  As the reference's
    ``dynamic_update_slice`` does, a start past ``max_len - S`` is clamped.
    """
    x, h = L.add_rmsnorm(p["ln1"], x, delta)
    q, k, v = A.qkv_project(p["attn"], h, cfg, positions)
    if cache_k is None:
        o = A.gqa_attention(q, k, v, causal=True, window=window,
                            kv_chunk=cfg.kv_chunk)
    else:
        B, S = q.shape[:2]
        max_len = cache_k.shape[1]
        start = torch.as_tensor(cache_pos, device=x.device).long()
        start = start.clamp(0, max_len - S).expand(B)
        rows = torch.arange(B, device=x.device)[:, None]
        cols = start[:, None] + torch.arange(S, device=x.device)
        cache_k.index_put_((rows, cols), k)
        cache_v.index_put_((rows, cols), v)
        k, v = cache_k, cache_v
        o = A.gqa_attention(q, k, v, causal=True, window=window,
                            q_offset=cache_pos, kv_valid_len=cache_pos + S,
                            kv_chunk=max(max_len, 1))
    x, h = L.add_rmsnorm(p["ln2"], x, A.out_project(p["attn"], o))
    return x, L.mlp(p["mlp"], h), k, v


def forward(params, cfg, tokens):
    """Scoring forward without a cache (inference only): tokens (B, S) ->
    the final hidden states (B, S, d), every layer's attention causal over
    the whole sequence (the flash-attention kernel on a card).  The
    reference's also returns the MoE auxiliary loss; a dense block has
    none."""
    x = embed_tokens(params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    delta = None
    for i, window in enumerate(layer_windows(cfg)):
        x, delta, _, _ = block_apply(_layer(params["blocks"], i), x, cfg,
                                     positions=positions, window=window,
                                     delta=delta)
    return L.final_rmsnorm(params["final_norm"], x, delta)


def init_cache(cfg, batch: int, max_len: int, *, dtype, device) -> dict:
    """Zeroed per-slot cache ``{"k", "v"}`` of (L, batch, max_len, Hkv, D)."""
    _check_dense(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.padded_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill(params, cfg, tokens, max_len: Optional[int] = None):
    """Run whole prompts (B, S) and build their cache.  Returns
    ``(cache, hidden)``: the cache ``{"k", "v"}`` of (L, B, max_len, Hkv, D)
    holds the prompt's K/V in its first S positions and zeros after, and
    hidden is the final (B, S, d) sequence, so a caller with right-padded
    prompts reads each at its own valid length."""
    _check_dense(cfg)
    x = embed_tokens(params, tokens)
    B, S = x.shape[:2]
    max_len = max_len or S
    positions = torch.arange(S, device=x.device)
    cache = init_cache(cfg, B, max_len, dtype=x.dtype, device=x.device)
    delta = None
    for i, window in enumerate(layer_windows(cfg)):
        x, delta, k, v = block_apply(_layer(params["blocks"], i), x, cfg,
                                     positions=positions, window=window,
                                     delta=delta)
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v
    return cache, L.final_rmsnorm(params["final_norm"], x, delta)


def decode_step(params, cfg, cache, tokens, pos):
    """One token for every slot against the per-slot cache, in place.

    tokens: (B, 1);  pos: an int (aligned) or (B,) int tensor (ragged
    slots): each slot's current length, where its new K/V lands.  Returns
    float32 logits (B, 1, V)."""
    _check_dense(cfg)
    x = embed_tokens(params, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[..., None] + torch.arange(1, device=x.device)
    delta = None
    for i, window in enumerate(layer_windows(cfg)):
        x, delta, _, _ = block_apply(_layer(params["blocks"], i), x, cfg,
                                     positions=positions, window=window,
                                     delta=delta, cache_k=cache["k"][i],
                                     cache_v=cache["v"][i], cache_pos=pos)
    return lm_logits(params, L.final_rmsnorm(params["final_norm"], x, delta))
