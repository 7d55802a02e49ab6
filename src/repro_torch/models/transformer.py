"""Dense decoder-only LM on paged KV storage (serving path).

Counterpart of the paged serving half of ``repro.models.transformer``,
without the mesh transport, MoE, KV quantization or precomputed embeds.
Params keep the reference's keys and shapes, with ``params["blocks"]``
stacked on a leading layer axis.

The reference scans ``(params["blocks"], storage)`` with ``jax.lax.scan``
and returns updated storage; here a Python loop walks the layers, and each
step writes its fresh K/V **in place** into that layer's view of the
storage tensors, so the pool's single copy is the result.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.module import Param, tree_map
from repro_torch.serve import pages as PG


def stack_defs(defs, n: int):
    """Prepend a stacked layer axis to every Param in a layer def tree."""
    return tree_map(lambda p: Param((n,) + tuple(p.shape), init=p.init), defs)


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


def embed_tokens(params, tokens):
    """(B, S) tokens -> (B, S, d) in the params' (compute) dtype."""
    return L.embed(params["embed"], tokens)


def lm_logits(params, hidden):
    """(B, S, d) -> (B, S, V) logits in float32.

    The reference multiplies in the compute dtype and accumulates into a
    float32 result (``preferred_element_type``).  Here a float32 model
    multiplies in float32; a bf16 model on a card asks cuBLAS for a float32
    output of the bf16 product (``torch.mm(..., out_dtype=float32)``), and
    on the CPU, which has no such product, both bf16 operands are widened
    to float32 first (their values are exact in float32)."""
    w = params["unembed"]["w"]
    h = hidden.reshape(-1, hidden.shape[-1])
    if h.dtype == torch.float32:
        out = h @ w
    elif h.is_cuda:
        out = torch.mm(h, w, out_dtype=torch.float32)
    else:
        out = h.float() @ w.float()
    return out.reshape(*hidden.shape[:-1], w.shape[-1])


def _layer(tree, i: int):
    """Layer ``i``'s view of a stacked (params or storage) tree."""
    return tree_map(lambda a: a[i], tree)


def _write_kv(kv, k, v, scatter) -> None:
    """Commit fresh K/V into one layer's page storage, in place."""
    scatter(kv["k"], k)
    scatter(kv["v"], v)


def _paged_block(p, x, cfg, *, positions, kv, write, attend):
    """One decoder block against one layer's page storage ``kv``.

    ``write(kv, k, v)`` commits the fresh K/V into pages (a whole-chunk
    scatter in prefill, a per-slot token scatter in decode) before
    ``attend(q, kv)`` reads them.  Returns the block's output."""
    h = L.rmsnorm(p["ln1"], x)
    q, k, v = A.qkv_project(p["attn"], h, cfg, positions)
    write(kv, k, v)
    o = attend(q, kv)
    x = x + A.out_project(p["attn"], o)
    h = L.rmsnorm(p["ln2"], x)
    return x + L.mlp(p["mlp"], h)


def _check_paged(cfg):
    if cfg.local_window and cfg.global_every:
        raise NotImplementedError("paged decode is global-attention only")


def paged_prefill_chunk(params, cfg, storage, table_row, pages_chunk, start,
                        tokens):
    """Prefill one page-aligned prompt chunk into paged storage, in place.

    storage: {"k", "v"} of (L, N, page_size, Hkv, D);  table_row: (P,) the
    slot's page table;  pages_chunk: (C // page_size,) pages covering
    positions [start, start + C);  start: int;  tokens: (1, C), right-padded
    (the validity length masks pad garbage).  Returns the final hidden
    states (1, C, d)."""
    _check_paged(cfg)
    page_size = storage["k"].shape[2]
    x = embed_tokens(params, tokens)
    C = x.shape[1]
    positions = start + torch.arange(C, device=x.device)
    tables = table_row[None]
    lengths = A.window_lengths(start, 1, x.device)     # shared by all layers

    def write(kv, k, v):
        _write_kv(kv, k[0], v[0],
                  lambda st, val: PG.scatter_chunk(st, pages_chunk, val,
                                                   page_size=page_size))

    def attend(q, kv):
        return A.paged_window_attention(q, kv["k"], kv["v"], tables, lengths)

    for i in range(cfg.n_layers):
        x = _paged_block(_layer(params["blocks"], i), x, cfg,
                         positions=positions, kv=_layer(storage, i),
                         write=write, attend=attend)
    return L.rmsnorm(params["final_norm"], x)


def paged_decode_step(params, cfg, storage, tables, lengths, tokens,
                      write_pages, write_offs):
    """One token for every slot against paged storage, in place.

    tokens: (B, 1);  tables: (B, P);  lengths: (B,) tokens already cached
    (= the current token's position);  write_pages/write_offs: (B,) where
    each slot's new K/V lands (dead slots point at the pool's trash page).
    Returns float32 logits (B, 1, V)."""
    _check_paged(cfg)
    x = embed_tokens(params, tokens)
    positions = lengths[:, None]
    # valid keys including the current token; one tensor for all layers
    valid = A.window_lengths(lengths, lengths.shape[0], x.device)

    def write(kv, k, v):
        _write_kv(kv, k[:, 0], v[:, 0],
                  lambda st, val: PG.scatter_token(st, write_pages,
                                                   write_offs, val))

    def attend(q, kv):
        return A.paged_decode_attention(q, kv["k"], kv["v"], tables, valid)

    for i in range(cfg.n_layers):
        x = _paged_block(_layer(params["blocks"], i), x, cfg,
                         positions=positions, kv=_layer(storage, i),
                         write=write, attend=attend)
    x = L.rmsnorm(params["final_norm"], x)
    return lm_logits(params, x)
