"""Dense decoder-only LM for serving: on paged KV storage, and on the
dense per-slot cache.

Counterpart of the serving half of ``repro.models.transformer``.  Params
keep the reference's keys and shapes, with ``params["blocks"]`` stacked on
a leading layer axis.  Precomputed embeddings (a VLM's image prefix) enter
through ``embeds=`` of :func:`paged_prefill_chunk` and ``inputs_embeds=``
of :func:`prefill`.

Serving tensor parallelism (Megatron TP of the paged path) is the
reference's: the paged calls take a ``comm``, the
:class:`repro_torch.core.comm.Comm` of the engine's ``"model"`` axis, and
then see their rank's shard of the weights (heads, ff, experts, vocab) and
of the KV pages (heads).  Attention runs on the local heads; one
``all_reduce_sum`` after the attention out-projection and one after the
MLP (arctic's dense residual MLP included) rebuild the replicated residual
stream, and the vocab-sharded logits are all-gathered, tiled on the last
axis.  ``ep_comm`` (the ``"expert"`` axis) partitions whole experts
(:func:`repro_torch.models.moe.moe_apply_expert_parallel`).  With the
serial transport (``comm=None``) every collective is the identity and the
code is the single-card path.  The cache-free :func:`forward` (the
self-drafter's) takes the same ``comm``.

An MoE block (``cfg.n_experts``; qwen3-moe, and arctic with its dense
residual MLP beside the experts) replaces the MLP with
:func:`repro_torch.models.moe.moe_apply_expert_parallel` over the serial
transport, fed the rows the forward sees (every slot at decode, dead ones
included; every chunk position, pad included), as in the reference.  The
paged calls take the (3, E) expert ``placement`` map and return, beside
their output, the layer-summed per-expert telemetry ``{"expert_tokens",
"expert_dropped"}`` (int32 (E,); (0,) for a dense model).  The dense
per-slot path runs the serial block and carries no telemetry, as the
reference's does.

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
attention families, and gemma3's mixed cache (full caches for its global
layers, rings for its sliding-window ones: :func:`init_cache`) as an
aligned batch, one position for every row (:func:`_window_decode_step`).

Training (:func:`forward_train`, :func:`lm_loss`) runs on one device or,
with ``mesh=`` (a :class:`repro_torch.mesh.grad_comm.TrainMesh`), on a
rank's ZeRO-3 shards and its block of the batch: rows over ``"data"``,
positions over ``"model"`` (the reference's activation layout).  Each
block gathers its layer's weights inside its checkpointed body, its
queries attend to the K/V of every position up to their last (gathered
over ``"model"``; flash attention with a query offset), and the loss is
the global mean, so the ranks' gradients sum to the single device's.  An
MoE block adds its router's auxiliary loss (the layers' mean, weighted by
``moe_aux_weight``).  On a mesh its expert stacks stay split over the
axis ``"experts"`` maps to (``"model"``; only their ``"expert_embed"``
dim is gathered), each rank routes its own tokens at its own capacity,
and the dispatch buffer goes to the experts' ranks and back through an
all-to-all with a gradient (:class:`repro_torch.mesh.grad_comm.
ExpertComm`); the aux is the mean over the ranks of each rank's, its
router statistics averaged over the expert axis, as in the reference.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.comm import SerialComm
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.module import Param, torch_dtype, tree_map
from repro_torch.serve import pages as PG
from repro_torch.serve import quant as QZ

_SERIAL = SerialComm()


def stack_defs(defs, n: int):
    """Prepend a stacked ``layers`` axis to every Param in a layer def
    tree."""
    return tree_map(lambda p: Param((n,) + tuple(p.shape),
                                    ("layers",) + p.logical_axes(),
                                    init=p.init, dtype=p.dtype), defs)


def block_defs(cfg) -> dict:
    """Parameter tree of one decoder block: the MLP, or for an MoE model the
    expert block (plus the dense residual MLP where the config has one)."""
    d = {
        "ln1": L.rmsnorm_def(cfg.d_model),
        "attn": A.attention_def(cfg),
        "ln2": L.rmsnorm_def(cfg.d_model),
    }
    if cfg.n_experts:
        d["moe"] = M.moe_def(cfg)
        if cfg.dense_residual:
            d["mlp"] = L.mlp_def(cfg.d_model, cfg.d_ff)
    else:
        d["mlp"] = L.mlp_def(cfg.d_model, cfg.d_ff)
    return d


def transformer_defs(cfg) -> dict:
    """Parameter tree of the whole decoder (blocks stacked)."""
    return {
        "embed": {"table": Param((cfg.padded_vocab, cfg.d_model),
                                 ("vocab", "embed_w"), init="small")},
        "blocks": stack_defs(block_defs(cfg), cfg.n_layers),
        "final_norm": L.rmsnorm_def(cfg.d_model),
        "unembed": {"w": Param((cfg.d_model, cfg.padded_vocab),
                               ("embed_w", "vocab"), init="small")},
    }


def embed_tokens(params, tokens, dtype=None):
    """(B, S) tokens -> (B, S, d) in the params' (compute) dtype; the rows
    of an int8 table are gathered, then dequantized to ``dtype``."""
    table = params["embed"]["table"]
    if QZ.is_q8(table):
        rows = {"q8": table["q8"][tokens.long()], "s8": table["s8"]}
        return QZ.dequantize_params(rows, dtype)
    return L.embed(params["embed"], tokens)


def _mm_f32(a, b):
    """``a @ b`` of two 2-D tensors of one dtype, returned in float32: a
    bf16 pair on a card asks cuBLAS for the float32 result of the bf16
    product; the CPU has no such product, so there both operands are
    widened first (their values are exact in float32)."""
    if a.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def lm_logits(params, hidden, comm=None):
    """(B, S, d) -> (B, S, V) logits in float32; with a mesh ``comm`` the
    unembedding holds the rank's vocab shard and the shards' logits are
    all-gathered, tiled on the last axis.

    The reference multiplies in the compute dtype and accumulates into a
    float32 result (``preferred_element_type``).  Here a float32 model
    multiplies in float32, a bf16 one through :func:`_mm_f32`.  An int8
    unembedding is dequantized to the hidden states' dtype first."""
    w = params["unembed"]["w"]
    if QZ.is_q8(w):
        w = QZ.dequantize_params(w, hidden.dtype)
    out = _mm_f32(hidden.reshape(-1, hidden.shape[-1]), w)
    out = out.reshape(*hidden.shape[:-1], w.shape[-1])
    return out if comm is None else comm.all_gather(out, axis=-1, tiled=True)


def layer_windows(cfg) -> list:
    """Per-layer attention window: an int for a sliding-window layer, None
    for a global one (where the reference holds ``BIG_WINDOW``)."""
    return [cfg.window_for_layer(i) for i in range(cfg.n_layers)]


def uses_window_cache(cfg) -> bool:
    """gemma3's mixed cache: ring buffers for its sliding-window layers."""
    return bool(cfg.local_window and cfg.global_every)


def layer_groups(cfg) -> tuple[list, list]:
    """(global layer indices, sliding-window layer indices)."""
    glob = [i for i in range(cfg.n_layers) if cfg.window_for_layer(i) is None]
    loc = [i for i in range(cfg.n_layers)
           if cfg.window_for_layer(i) is not None]
    return glob, loc


# why a window-cache model is served only as an aligned batch, for every
# refusal
WINDOW_ALIGNED_ONLY = (
    "served only as an aligned batch (prompts of one length, then decode "
    "steps at one position for the whole batch), as in the reference: its "
    "window-cache decode is aligned-only (repro/models/transformer.py:603 "
    "asserts a scalar position, so the engine's per-slot positions crash "
    "it at the first decode tick)")


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


def _ffn(p, h, cfg, placement=None, comm=_SERIAL, ep_comm=None):
    """The block's feed-forward half on the normed stream ``h``: the MLP, or
    the MoE block (plus the dense residual MLP).  Returns ``(y, aux,
    stats)``: the MoE block's float32 auxiliary loss and per-expert
    telemetry (None for an MLP).  A mesh ``comm`` sums the MLP's ff-sharded
    partial outputs and splits the expert GEMMs (``shard_comm``);
    ``ep_comm`` partitions the experts."""
    if not cfg.n_experts:
        return comm.all_reduce_sum(L.mlp(p["mlp"], h)), None, None
    y, aux, stats = M.moe_apply_expert_parallel(
        p["moe"], h, cfg, _SERIAL if ep_comm is None else ep_comm,
        shard_comm=None if comm.axis is None else comm, placement=placement)
    if cfg.dense_residual:
        y = y + comm.all_reduce_sum(L.mlp(p["mlp"], h))
    return y, aux, stats


def _paged_block(p, x, delta, cfg, *, positions, kv, write, attend,
                 placement=None, comm=_SERIAL, ep_comm=None):
    """One decoder block against one layer's page storage ``kv``.

    ``delta`` is the previous block's feed-forward output, not yet added to
    the residual stream ``x`` (None before the first block): the add runs
    inside this block's first norm, as the attention output's does inside
    its second.  ``write(kv, k, v)`` commits the fresh K/V into pages (a
    whole-chunk scatter in prefill, a per-slot token scatter in decode)
    before ``attend(q, kv)`` reads them.  Returns ``(x, delta, stats)``:
    the stream, this block's pending feed-forward output and its MoE
    telemetry (None for a dense block).  With a mesh ``comm`` the heads,
    ff and KV pages are the rank's shard, and both projections back to
    d_model are summed over the ranks (module docstring)."""
    x, h = L.add_rmsnorm(p["ln1"], x, delta)
    q, k, v = A.qkv_project(p["attn"], h, cfg, positions)
    write(kv, k, v)
    o = attend(q, kv)
    x, h = L.add_rmsnorm(p["ln2"], x,
                         comm.all_reduce_sum(A.out_project(p["attn"], o)))
    y, _, stats = _ffn(p, h, cfg, placement, comm, ep_comm)
    return x, y, stats


def _paged_layers(params, cfg, storage, x, *, positions, write, attend,
                  placement, comm, ep_comm):
    """Every block over its layer's storage; returns the final normed
    hidden states and the layer-summed telemetry ``{"expert_tokens",
    "expert_dropped"}``."""
    acc = M.empty_expert_stats(cfg.n_experts, x.device)
    delta = None
    for i, p in enumerate(_blocks(params, cfg)):
        x, delta, stats = _paged_block(p, x, delta, cfg, positions=positions,
                                       kv=_layer(storage, i), write=write,
                                       attend=attend, placement=placement,
                                       comm=comm, ep_comm=ep_comm)
        if stats is not None:
            for k in acc:
                acc[k] += stats[k]
    hidden = L.final_rmsnorm(params["final_norm"], x, delta)
    return hidden, {"expert_tokens": acc["tokens"],
                    "expert_dropped": acc["dropped"]}


def _check_paged(cfg):
    if uses_window_cache(cfg):
        raise NotImplementedError("paged decode is global-attention only")


def _blocks(params, cfg):
    """Each layer's params in turn, int8 weights dequantized to the
    compute dtype one layer at a time."""
    dtype = torch_dtype(cfg.dtype)
    for i in range(cfg.n_layers):
        yield QZ.dequantize_params(_layer(params["blocks"], i), dtype)


def chunk_embeddings(params, tokens, embeds, dtype):
    """A prefill chunk's input rows: the table's rows of the real tokens,
    and ``embeds``' rows (1, C, d) where ``tokens`` is negative (a VLM's
    image pseudo-tokens).  The table is read at ``max(tokens, 0)``: the
    pseudo-tokens themselves are no index."""
    x = embed_tokens(params, tokens.clamp(min=0), dtype)
    return torch.where((tokens < 0)[..., None], embeds.to(x.dtype), x)


def paged_prefill_chunk(params, cfg, storage, table_row, pages_chunk, start,
                        tokens, quant=None, placement=None, comm=None,
                        ep_comm=None, embeds=None):
    """Prefill one page-aligned prompt chunk into paged storage, in place.

    storage: {"k", "v"} of (L, N, page_size, Hkv, D), plus
    {"k_scale", "v_scale"} of (L, N, page_size, Hkv) with a ``quant``
    policy;  table_row: (P,) the slot's page table;  pages_chunk:
    (C // page_size,) pages covering positions [start, start + C);  start:
    int;  tokens: (1, C), right-padded (the validity length masks pad
    garbage);  placement: the (3, E) expert dispatch map of an MoE model
    (None: the unplaced layout);  comm / ep_comm: the mesh transports
    (module docstring; None: serial);  embeds: None, or (1, C, d) rows
    spliced in where ``tokens`` is negative (:func:`chunk_embeddings`; a
    mesh replicates them like the tokens).  Returns ``(hidden, telemetry)``:
    the final hidden states (1, C, d), replicated, and the layer-summed
    per-expert ``{"expert_tokens", "expert_dropped"}`` int32 counts ((0,)
    for a dense model), the same on every rank."""
    _check_paged(cfg)
    comm = _SERIAL if comm is None else comm
    page_size = storage["k"].shape[2]
    x = embed_tokens(params, tokens, torch_dtype(cfg.dtype)) if embeds is None \
        else chunk_embeddings(params, tokens, embeds, torch_dtype(cfg.dtype))
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

    return _paged_layers(params, cfg, storage, x, positions=positions,
                         write=write, attend=attend, placement=placement,
                         comm=comm, ep_comm=ep_comm)


def paged_decode_step(params, cfg, storage, tables, lengths, tokens,
                      write_pages, write_offs, quant=None, placement=None,
                      comm=None, ep_comm=None):
    """One token for every slot against paged storage, in place.

    tokens: (B, 1);  tables: (B, P);  lengths: (B,) tokens already cached
    (= the current token's position);  write_pages/write_offs: (B,) where
    each slot's new K/V lands (dead slots point at the pool's trash page);
    quant, placement, comm and ep_comm as in :func:`paged_prefill_chunk`.
    Returns ``(logits, telemetry)``: float32 logits (B, 1, V) (with a mesh
    ``comm``, the vocab shards all-gathered) and the telemetry of
    :func:`paged_prefill_chunk`."""
    _check_paged(cfg)
    comm = _SERIAL if comm is None else comm
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

    hidden, tel = _paged_layers(params, cfg, storage, x, positions=positions,
                                write=write, attend=attend,
                                placement=placement, comm=comm,
                                ep_comm=ep_comm)
    return lm_logits(params, hidden, comm), tel


def paged_verify_chunk(params, cfg, storage, tables, lengths, tokens,
                       write_pages, write_offs, quant=None, placement=None,
                       comm=None, ep_comm=None):
    """Score a per-slot window of candidate tokens in one batched forward,
    in place — the speculative-decode verify step.

    tokens: (B, C) — position 0 is each slot's next input token (its K/V
    not yet cached), positions 1..C-1 draft continuations (right-padded
    for slots with shorter windows);  tables: (B, P);  lengths: (B,) tokens
    already cached (= the position of tokens[:, 0]);  write_pages /
    write_offs: (B, C) where each position's K/V lands (pad and dead-slot
    positions point at the pool's trash page);  quant, placement, comm and
    ep_comm as in :func:`paged_prefill_chunk`.  Returns ``(logits,
    telemetry)``: float32
    logits (B, C, V), logits[:, i] scoring the token following
    tokens[:, i], and the telemetry of :func:`paged_prefill_chunk`.  C == 1
    is a decode step.

    Every window position's K/V is written before attention runs, and
    paged attention scores the whole (B, C) window in one call, window
    position i seeing keys below ``lengths + i + 1``; pad positions only
    influence pad logits."""
    _check_paged(cfg)
    comm = _SERIAL if comm is None else comm
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

    hidden, tel = _paged_layers(params, cfg, storage, x, positions=positions,
                                write=write, attend=attend,
                                placement=placement, comm=comm,
                                ep_comm=ep_comm)
    return lm_logits(params, hidden, comm), tel


# ---------------------------------------------------------------------------
# The block over contiguous K/V, the cache-free forwards and the loss
# ---------------------------------------------------------------------------

def block_apply(p, x, cfg, *, positions, window, delta=None, cache_k=None,
                cache_v=None, cache_pos=None, ring: bool = False,
                comm=_SERIAL, ep_comm=None, mesh=None):
    """Pre-norm block.  Returns ``(x, delta, aux, k, v)``: the residual
    stream, this block's feed-forward output (the MLP, or the MoE block
    plus any dense residual MLP) not yet added to it (the next norm adds
    it; the ``delta`` passed in is the previous block's, None before the
    first), the MoE block's float32 auxiliary loss (None for an MLP), and
    the fresh K/V of this layer without a cache (whole-prompt prefill, the
    training forward), the cache itself with one.

    With a cache (decode), ``cache_k``/``cache_v`` are this layer's
    (B, max_len, Hkv, D) views of the stacked cache: the new K/V are written
    at each slot's ``cache_pos`` (an int, or (B,) for ragged slots) **in
    place** with ``index_put_`` on those views, then the queries attend over
    the whole cache, masked by ``cache_pos + S``.  As the reference's
    ``dynamic_update_slice`` does, a start past ``max_len - S`` is clamped.
    With ``ring`` they are a sliding-window layer's (B, W, Hkv, D) ring
    (one token a step, ``cache_pos`` an int): its keys shift one slot
    towards 0, the new K/V land in slot ``W - 1``, in place, and the query
    attends over the ring as one chunk, slot ``j`` at position
    ``cache_pos - W + 1 + j`` (negative positions masked), as the
    reference's ``_window_decode_step`` does.
    ``comm`` / ``ep_comm``: the mesh transports of :func:`_paged_block`
    (the cache-free forward of the self-drafter under a mesh).  ``mesh``
    (a :class:`repro_torch.mesh.grad_comm.TrainMesh`, training): ``x`` is
    this rank's block of positions, and its queries attend to the keys of
    every position up to their last, gathered over the sequence's axes
    (``k`` and ``v`` returned are that prefix), and an MoE block's experts
    are the rank's, reached through ``ep_comm`` (its
    :meth:`repro_torch.mesh.grad_comm.TrainMesh.expert_comm`).
    """
    x, h = L.add_rmsnorm(p["ln1"], x, delta)
    q, k, v = A.qkv_project(p["attn"], h, cfg, positions)
    if cache_k is None and mesh is not None:
        k, v, off = mesh.attention_kv(k, v)
        o = A.gqa_attention(q, k, v, causal=True, window=window,
                            q_offset=off, kv_chunk=cfg.kv_chunk)
    elif cache_k is None:
        o = A.gqa_attention(q, k, v, causal=True, window=window,
                            kv_chunk=cfg.kv_chunk)
    elif ring:
        if q.shape[1] != 1 or not isinstance(cache_pos, int):
            raise ValueError("a ring cache takes one token at one position "
                             "for the whole batch a step")
        W = cache_k.shape[1]
        cache_k.copy_(torch.cat([cache_k[:, 1:], k], dim=1))
        cache_v.copy_(torch.cat([cache_v[:, 1:], v], dim=1))
        k, v = cache_k, cache_v
        o = A.gqa_attention(q, k, v, causal=True, window=window,
                            q_offset=cache_pos, k_start=cache_pos - W + 1,
                            kv_chunk=W)
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
    x, h = L.add_rmsnorm(p["ln2"], x,
                         comm.all_reduce_sum(A.out_project(p["attn"], o)))
    y, aux, _ = _ffn(p, h, cfg, None, comm, ep_comm)
    return x, y, aux, k, v


def _dots_policy(ctx, func, *args, **kwargs):
    """The reference's ``dots_with_no_batch_dims_saveable``: keep the
    output of every 2-D product (the projections, the router's logits),
    recompute everything else (norms, RoPE, attention, the MoE dispatch
    and its expert products, which have a batch dim)."""
    if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.addmm):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` recomputed in the backward pass (``"full"``: nothing of it
    saved but its inputs, the reference's ``nothing_saveable``; ``"dots"``:
    the outputs of its 2-D products saved as well, :func:`_dots_policy`),
    or as it is (``"none"``, and whenever autograd is off).  Either way
    the recompute runs the same ops in the same order, so a collective in
    ``fn`` runs again on every rank alike."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    if remat not in ("dots", "full"):
        raise ValueError(f"unknown remat {remat!r}; want none | dots | full")
    kw = {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)} \
        if remat == "dots" else {}
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False, **kw)


def compute_params(tree, dtype, defs=None):
    """A block's weights cast to the compute ``dtype`` where they are used,
    the reference's ``astype`` at every call; the norms' scales stay as
    they are (the reference reads them in float32), and so does every leaf
    whose declaration in ``defs`` (the block's :class:`Param` tree) names
    a dtype of its own (the leaves the reference reads in float32).  The
    casts are differentiable: a float32 weight's gradient arrives in
    float32."""
    if isinstance(tree, dict):
        return {k: v if k == "scale" else compute_params(
            v, dtype, None if defs is None else defs[k])
            for k, v in tree.items()}
    if defs is not None and defs.dtype is not None:
        return tree
    return tree.to(dtype)


def _blocks_forward(params, cfg, x, *, comm=_SERIAL, ep_comm=None,
                    dtype=None, remat: str = "none", mesh=None):
    """Every block over the whole sequence ``x`` (B, S, d), causal, then the
    final norm: the shared loop of the scoring forward and the training
    forward.  Returns ``(hidden, aux)``, aux the sum of the MoE blocks'
    auxiliary losses (None for a dense model).  ``dtype``: cast each
    block's weights to it inside the block (:func:`block_params`);
    ``remat``: :func:`_remat` of each block.  ``mesh`` (a
    :class:`repro_torch.mesh.grad_comm.TrainMesh`): ``x`` is this rank's
    block of rows and positions, and each block gathers its layer's shards
    inside its body (in ``dtype``; the expert stacks stay split over the
    expert axis), so remat gathers them again in the backward pass and no
    block's whole weights outlive it."""
    off = 0 if mesh is None else mesh.seq_block()[0] * x.shape[1]
    positions = off + torch.arange(x.shape[1], device=x.device)
    specs = None
    if mesh is not None:
        specs = tree_map(lambda s: s[1:], mesh.gather_specs["blocks"])
        if cfg.n_experts:
            ep_comm = mesh.expert_comm()
    delta = aux = None
    for i, window in enumerate(layer_windows(cfg)):
        def body(x, delta, p=_layer(params["blocks"], i), window=window):
            if mesh is not None or dtype is not None:
                p = block_params(p, dtype, None, mesh, specs)
            x, y, a, _, _ = block_apply(p, x, cfg, positions=positions,
                                        window=window, delta=delta,
                                        comm=comm, ep_comm=ep_comm,
                                        mesh=mesh)
            return x, y, a
        x, delta, a = _remat(body, remat)(x, delta)
        if a is not None:
            aux = a if aux is None else aux + a
    return L.final_rmsnorm(params["final_norm"], x, delta), aux


def forward(params, cfg, tokens, comm=None, ep_comm=None):
    """Scoring forward without a cache (inference only): tokens (B, S) ->
    the final hidden states (B, S, d), every layer's attention causal over
    the whole sequence (the flash-attention kernel on a card).  The
    training forward is :func:`forward_train`.  ``comm`` / ``ep_comm``:
    the mesh transports of the paged calls (the rank's shard of the
    weights)."""
    return _blocks_forward(params, cfg, embed_tokens(params, tokens),
                           comm=_SERIAL if comm is None else comm,
                           ep_comm=ep_comm)[0]


def embed_train(params, tokens, dtype, mesh=None):
    """The training forward's embeddings of ``tokens`` (B, S) in ``dtype``;
    on a ``mesh`` (a :class:`repro_torch.mesh.grad_comm.TrainMesh`) the
    table gathered whole in float32 first, its rows then cast, as on one
    device."""
    if mesh is None:
        return L.embed(params["embed"], tokens).to(dtype)
    table = mesh.gather(params["embed"]["table"],
                        mesh.specs["embed"]["table"])
    return table[tokens.long()].to(dtype)


def unembed_train(params, mesh=None):
    """The unembedding the loss reads: gathered whole in float32 on a
    ``mesh``."""
    w = params["unembed"]["w"]
    return w if mesh is None else mesh.gather(w, mesh.specs["unembed"]["w"])


def block_params(p, dtype, defs=None, mesh=None, specs=None):
    """A block's weights as its body reads them: cast to ``dtype``
    (:func:`compute_params`), or on a ``mesh`` gathered whole from this
    rank's shards under their mesh ``specs`` (:meth:`repro_torch.mesh.
    grad_comm.TrainMesh.gather_params`), the leaves ``defs`` declares a
    dtype for kept in it either way."""
    if mesh is None:
        return compute_params(p, dtype, defs)
    return mesh.gather_params(p, specs, dtype, defs)


def forward_train(params, cfg, tokens=None, inputs_embeds=None, mesh=None):
    """Training forward over the ``param_dtype`` weights: tokens (B, S),
    or their embeddings (B, S, d) -> ``(hidden, aux)``, the final hidden
    states (B, S, d) in the compute dtype and the float32 auxiliary loss:
    the MoE blocks' mean over the layers (0 for a dense model).  Each
    block runs in the compute dtype and is recomputed in the backward pass
    under ``cfg.remat``.

    ``mesh`` (a :class:`repro_torch.mesh.grad_comm.TrainMesh`): ``params``
    are this rank's ZeRO-3 shards and the input its block (B / dp rows, S /
    tp positions); the embedding table is gathered in float32 (its rows
    then cast, as on one device), each block's weights inside the block
    (:func:`_blocks_forward`); the aux is the mean over the ranks of each
    rank's (the sum's backward the identity, as the loss's)."""
    dtype = torch_dtype(cfg.dtype)
    x = inputs_embeds if inputs_embeds is not None else embed_train(
        params, tokens, dtype, mesh)
    hidden, aux = _blocks_forward(params, cfg, x, dtype=dtype,
                                  remat=cfg.remat, mesh=mesh)
    if aux is None:
        return hidden, torch.zeros((), dtype=torch.float32, device=x.device)
    aux = aux / max(cfg.n_layers, 1)
    if mesh is not None:
        aux = mesh.all_reduce_sum(aux) / mesh.n_ranks
    return hidden, aux


class _LogitsF32(torch.autograd.Function):
    """``h @ w`` in float32 from hidden states ``h`` (N, d) in the compute
    dtype and a float32 unembedding ``w`` (d, V), cast to the compute
    dtype inside (the reference's ``einsum(..., preferred_element_type=
    float32)``).  The backward takes the float32 cotangent to the compute
    dtype for ``dh`` and returns ``dw`` in float32 (a bf16 product
    accumulated into a float32 result), so no bf16 copy of ``w`` is kept
    between the passes."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return _mm_f32(h, w.to(h.dtype))

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        gc = g.to(h.dtype)
        dh = gc @ w.to(h.dtype).T
        dw = _mm_f32(h.T.contiguous(), gc)
        return dh, dw.to(w.dtype)


def loss_from_hidden(unembed_w, hidden, labels, cfg, loss_chunks: int = 8,
                     mesh=None):
    """Mean cross-entropy from the final hidden states (B, S, d) and their
    labels (B, S) (``< 0``: not scored), and the count scored.  The logits
    (float32, (B, S/chunks, V) at a time) are taken a sequence chunk at a
    time and recomputed in the backward pass, so the whole (B, S, V)
    never exists.  With a ``mesh`` (training's
    :class:`repro_torch.mesh.grad_comm.TrainMesh`) the rank's block is
    scored: its sum and count are summed over the ranks (the sum's
    backward the identity), so every rank returns the global mean and
    count, and the ranks' gradients sum to the single device's."""
    S = hidden.shape[1]
    chunks = loss_chunks if S % loss_chunks == 0 and S >= loss_chunks else 1
    c = S // chunks

    def chunk_loss(h_c, l_c, w):
        B = h_c.shape[0]
        logits = _LogitsF32.apply(h_c.reshape(-1, h_c.shape[-1]), w)
        return L.masked_ce_sums(logits.reshape(B, c, -1), l_c,
                                true_vocab=cfg.vocab, z_loss=cfg.z_loss)

    fn = _remat(chunk_loss, "full")
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(chunks):
        t, n = fn(hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c],
                  unembed_w)
        tot, cnt = tot + t, cnt + n
    if mesh is not None:
        tot = mesh.all_reduce_sum(tot)
        cnt = mesh.all_reduce_sum(cnt.detach())
    return tot / torch.clamp(cnt, min=1.0), cnt


def lm_loss(params, cfg, tokens=None, labels=None, inputs_embeds=None,
            loss_chunks: int = 8, mesh=None):
    """``(loss, {"ce", "aux", "tokens"})`` of next-token prediction
    (:func:`forward_train`, :func:`loss_from_hidden`): the mean
    cross-entropy, plus ``moe_aux_weight`` times the auxiliary loss for an
    MoE model, as in the reference; on a ``mesh`` the rank's block of
    ``tokens`` / ``labels``, the unembedding gathered in float32 and the
    loss the global mean."""
    hidden, aux = forward_train(params, cfg, tokens, inputs_embeds, mesh)
    ce, cnt = loss_from_hidden(unembed_train(params, mesh), hidden, labels,
                               cfg, loss_chunks, mesh)
    loss = ce + cfg.moe_aux_weight * aux if cfg.n_experts else ce
    return loss, {"ce": ce, "aux": aux, "tokens": cnt}


# ---------------------------------------------------------------------------
# Dense per-slot cache (the engine's paged=False path; gemma3's mixed
# window/ring cache as an aligned batch)
# ---------------------------------------------------------------------------

def cache_specs(cfg) -> dict:
    """The logical axes of :func:`init_cache`'s leaves (the reference's)."""
    spec = (None, "batch", "kv_seq", None, None)
    if not uses_window_cache(cfg):
        return {"k": spec, "v": spec}
    return {"k": spec, "v": spec, "k_loc": spec, "v_loc": spec}


def init_cache(cfg, batch: int, max_len: int, *, dtype, device) -> dict:
    """Zeroed per-slot cache: ``{"k", "v"}`` of (L, batch, max_len, Hkv,
    D); for a window-cache model the global layers' ``{"k", "v"}`` of
    (n_global, ...) and the ring buffers ``{"k_loc", "v_loc"}`` of
    (n_local, batch, W, Hkv, D), ``W = min(local_window, max_len)``."""
    tail = (cfg.padded_kv_heads, cfg.head_dim)

    def zeros(*shape):
        return torch.zeros(shape + tail, dtype=dtype, device=device)
    if not uses_window_cache(cfg):
        return {"k": zeros(cfg.n_layers, batch, max_len),
                "v": zeros(cfg.n_layers, batch, max_len)}
    glob, loc = layer_groups(cfg)
    W = min(cfg.local_window, max_len)
    return {"k": zeros(len(glob), batch, max_len),
            "v": zeros(len(glob), batch, max_len),
            "k_loc": zeros(len(loc), batch, W),
            "v_loc": zeros(len(loc), batch, W)}


def _cache_layer(cfg, cache, i: int):
    """Layer ``i``'s (k, v) views of ``cache`` and whether they are a ring."""
    if not uses_window_cache(cfg):
        return cache["k"][i], cache["v"][i], False
    glob, loc = layer_groups(cfg)
    if i in glob:
        g = glob.index(i)
        return cache["k"][g], cache["v"][g], False
    j = loc.index(i)
    return cache["k_loc"][j], cache["v_loc"][j], True


def prefill(params, cfg, tokens=None, max_len: Optional[int] = None, *,
            inputs_embeds=None):
    """Run whole prompts (B, S), or their embeddings ``inputs_embeds``
    (B, S, d), and build their cache.  Returns ``(cache, hidden)``: the
    cache (:func:`init_cache`) holds the prompt's K/V in its first S
    positions and zeros after, and hidden is the final (B, S, d) sequence,
    so a caller with right-padded prompts reads each at its own valid
    length.  A sliding-window layer keeps the last ``min(W, S)`` positions
    in its ring, right-aligned (slot ``W - 1`` is position ``S - 1``), the
    slots before them zeros (masked as negative positions at decode)."""
    x = embed_tokens(params, tokens) if inputs_embeds is None \
        else inputs_embeds
    B, S = x.shape[:2]
    max_len = max_len or S
    positions = torch.arange(S, device=x.device)
    cache = init_cache(cfg, B, max_len, dtype=x.dtype, device=x.device)
    delta = None
    for i, window in enumerate(layer_windows(cfg)):
        x, delta, _, k, v = block_apply(_layer(params["blocks"], i), x,
                                        cfg, positions=positions,
                                        window=window, delta=delta)
        ck, cv, ring = _cache_layer(cfg, cache, i)
        if ring:
            take = min(ck.shape[1], S)
            ck[:, ck.shape[1] - take:] = k[:, S - take:]
            cv[:, cv.shape[1] - take:] = v[:, S - take:]
        else:
            ck[:, :S] = k
            cv[:, :S] = v
    return cache, L.final_rmsnorm(params["final_norm"], x, delta)


def _decode_layers(params, cfg, cache, tokens, pos):
    """Every block's decode of ``tokens`` (B, 1) at ``pos`` (an int for a
    window cache, else an int or (B,) tensor, taken to the device), then
    the logits head."""
    x = embed_tokens(params, tokens)
    if not uses_window_cache(cfg):
        pos = torch.as_tensor(pos, device=x.device)
    positions = torch.as_tensor(pos, device=x.device)[..., None] \
        + torch.arange(1, device=x.device)
    delta = None
    for i, window in enumerate(layer_windows(cfg)):
        ck, cv, ring = _cache_layer(cfg, cache, i)
        x, delta, *_ = block_apply(_layer(params["blocks"], i), x, cfg,
                                   positions=positions, window=window,
                                   delta=delta, cache_k=ck, cache_v=cv,
                                   cache_pos=pos, ring=ring)
    return lm_logits(params, L.final_rmsnorm(params["final_norm"], x, delta))


def _window_decode_step(params, cfg, cache, tokens, pos):
    """One token for every row of an aligned batch against the mixed cache,
    in place: a global layer writes position ``pos`` of its full cache and
    attends below ``pos + 1``, a sliding-window layer shifts its ring and
    attends over it (:func:`block_apply`).  ``pos``: one int for the whole
    batch; a per-row vector raises ``ValueError``, as the reference's
    aligned-only decode asserts."""
    t = torch.as_tensor(pos)
    if t.ndim != 0:
        raise ValueError(f"{cfg.name}: pos must be one integer for the whole "
                         f"batch, got shape {tuple(t.shape)}: the model is "
                         f"{WINDOW_ALIGNED_ONLY}")
    return _decode_layers(params, cfg, cache, tokens, int(t.item()))


def decode_step(params, cfg, cache, tokens, pos):
    """One token for every slot against the per-slot cache, in place.

    tokens: (B, 1);  pos: an int (aligned) or (B,) int tensor (ragged
    slots): each slot's current length, where its new K/V lands; a
    window-cache model takes one int only (:func:`_window_decode_step`).
    Returns float32 logits (B, 1, V)."""
    if uses_window_cache(cfg):
        return _window_decode_step(params, cfg, cache, tokens, pos)
    return _decode_layers(params, cfg, cache, tokens, pos)
