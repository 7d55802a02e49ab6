"""Zamba2-style hybrid LM: a Mamba-2 backbone with one *shared* transformer
block applied after every ``cfg.shared_attn_every`` layers.

Counterpart of ``repro.models.zamba`` (zamba2-7b: 81 Mamba-2 layers in 3
segments of 27, the shared block after each).  The shared block has one
parameter copy but one KV cache per application.

The reference serves this family only as an **aligned batch**: every row
prefilled from position 0 with prompts of one length, then decoded with
one scalar position for the whole batch (``HybridLM.prefill`` and
``decode_step``); its serving engine refuses the family.  The same holds
here: ``pos`` is one integer, and a per-row position vector raises.

The decode state holds, per Mamba layer (stacked ``(segments,
layers_per_segment, ...)``), the float32 SSM state and conv tails, and per
application of the shared block a K/V cache of ``max_len`` rows.  The
reference scans each segment with ``jax.lax.scan`` and returns a new state;
here Python loops walk the segments and layers and advance the state **in
place** (the SSD kernel writes each layer's SSM state, the block its conv
tails, and the shared block's K/V rows land by slice assignment), so the
caller's one copy is the result.

Training (:func:`forward`, :func:`lm_loss`, the reference's) keeps no
state: each Mamba layer is cast to the compute dtype (its float32 leaves
kept) and recomputed in the backward pass under ``cfg.remat``, as the
reference's ``_mamba_segment`` is; the shared block attends causally over
the whole sequence through the flash-attention kernel and is not
recomputed.  Its weights are cast once a forward, so its one parameter copy
collects its gradient from every application.  On a card the SSD scan,
the gated norm, RMSNorm with its fused add and flash attention (at head
dim 112, padded to 128) each take their gradient through a backward
kernel.

Over a training mesh (``mesh=``, a :class:`repro_torch.mesh.grad_comm.
TrainMesh`) a rank runs its block of rows and positions: the embedding
table and the unembedding are gathered whole in float32, each Mamba
layer's weights inside its recomputed body, and the shared block's once a
forward, before the segments, so the gather's backward sums every
application's gradient as the one copy does on one device.  The SSD scan
runs on the rank's heads over every position
(:mod:`repro_torch.models.mamba2`); the shared block attends as the
transformer's blocks do under sequence parallelism (positions offset by
the rank's block, K/V gathered over the sequence, the queries' offset).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T
from repro_torch.models.module import Param, torch_dtype, tree_map

# why the family is served only as an aligned batch, for every refusal
ALIGNED_ONLY = (
    "served only as an aligned batch (prompts of one length, then decode "
    "steps at one position for the whole batch), as in the reference: its "
    "shared block writes the cache with dynamic_update_slice at one scalar "
    "start (repro/models/zamba.py:72), so per-row positions fail there, and "
    "its launcher refuses the family (repro/launch/serve.py:215)")


def _n_segments(cfg) -> int:
    k = cfg.shared_attn_every
    if k <= 0 or cfg.n_layers % k:
        raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a "
                         f"multiple of shared_attn_every={k}")
    return cfg.n_layers // k


def zamba_defs(cfg) -> dict:
    """Parameter tree of the whole model; the Mamba layers stacked as
    ``(segments, layers_per_segment, ...)``."""
    seg, k = _n_segments(cfg), cfg.shared_attn_every
    mamba_layer = {"ln": L.rmsnorm_def(cfg.d_model),
                   "mamba": M2.mamba2_def(cfg)}
    return {
        "embed": {"table": Param((cfg.padded_vocab, cfg.d_model),
                                 ("vocab", "embed_w"), init="small")},
        "mamba_blocks": T.stack_defs(T.stack_defs(mamba_layer, k), seg),
        "shared": {
            "ln1": L.rmsnorm_def(cfg.d_model),
            "attn": A.attention_def(cfg),
            "ln2": L.rmsnorm_def(cfg.d_model),
            "mlp": L.mlp_def(cfg.d_model, cfg.d_ff),
        },
        "final_norm": L.rmsnorm_def(cfg.d_model),
        "unembed": {"w": Param((cfg.d_model, cfg.padded_vocab),
                               ("embed_w", "vocab"), init="small")},
    }


def _shared_block(params, x, delta, cfg, *, positions, cache_k, cache_v,
                  cache_pos):
    """One application of the shared attention + MLP block against its own
    cache, the pending ``delta`` added to the stream ``x`` inside its first
    norm; returns ``(x, delta)``, its own MLP output pending.  The new K/V
    rows are written at ``cache_pos`` in place (a start
    past ``max_len - S`` is clamped, as ``dynamic_update_slice`` does), then
    the queries attend over the cache, masked by ``cache_pos + S``.  The
    mask's offsets are read from ``positions`` (``cache_pos + arange(S)``
    on the device), so a step copies nothing from the host."""
    x, h = L.add_rmsnorm(params["ln1"], x, delta)
    q, k, v = A.qkv_project(params["attn"], h, cfg, positions)
    S, max_len = q.shape[1], cache_k.shape[1]
    start = min(max(cache_pos, 0), max_len - S)
    cache_k[:, start:start + S] = k
    cache_v[:, start:start + S] = v
    o = A.gqa_attention(q, cache_k, cache_v, causal=True,
                        q_offset=positions[0], kv_valid_len=positions[-1] + 1,
                        kv_chunk=max(max_len, 1))
    x, h = L.add_rmsnorm(params["ln2"], x, A.out_project(params["attn"], o))
    return x, L.mlp(params["mlp"], h)


def _mamba_segment(seg_params, x, delta, cfg, states):
    """The segment's Mamba layers in order, each pre-normed and residual:
    each layer's output stays pending (``delta``) until the next norm adds
    it to the stream ``x``; returns ``(x, delta)``.  ``states``
    (``{"ssm", "conv"}`` stacked on the segment's layer axis) are advanced
    in place."""
    for i in range(cfg.shared_attn_every):
        p = T._layer(seg_params, i)
        x, h = L.add_rmsnorm(p["ln"], x, delta)
        delta, _, _ = M2.mamba2_block(
            p["mamba"], h, cfg, ssm_state=states["ssm"][i],
            conv_state={c: states["conv"][c][i] for c in "xBC"})
    return x, delta


def state_specs(cfg) -> dict:
    """The logical axes of :func:`init_state`'s leaves (the reference's)."""
    return {
        "mamba": {
            "ssm": (None, None, "batch", "ssm_heads", None, None),
            "conv": {"x": (None, None, "batch", None, "inner"),
                     "B": (None, None, "batch", None, None),
                     "C": (None, None, "batch", None, None)},
        },
        "attn_cache": {"k": (None, "batch", "kv_seq", None, None),
                       "v": (None, "batch", "kv_seq", None, None)},
    }


def init_state(cfg, batch: int, max_len: int, *, dtype, device) -> dict:
    """Zeroed decode state: ``mamba`` ``{"ssm" (seg, k, batch, H, N, P),
    "conv" {"x", "B", "C"} (seg, k, batch, K-1, C)}`` in float32, and
    ``attn_cache`` ``{"k", "v"}`` (seg, batch, max_len, Hkv, D) in
    ``dtype``."""
    seg, k = _n_segments(cfg), cfg.shared_attn_every
    layer = M2.init_mamba_state(cfg, batch, device=device)
    kv = (seg, batch, max_len, cfg.padded_kv_heads, cfg.head_dim)
    return {
        "mamba": tree_map(lambda t: t.new_zeros((seg, k) + tuple(t.shape)),
                          layer),
        "attn_cache": {"k": torch.zeros(kv, dtype=dtype, device=device),
                       "v": torch.zeros(kv, dtype=dtype, device=device)},
    }


def _check_pos(pos) -> int:
    """One position for the whole batch, as the reference serves it."""
    t = torch.as_tensor(pos)
    if t.ndim != 0:
        raise ValueError(f"zamba: pos must be one integer for the whole "
                         f"batch, got shape {tuple(t.shape)}: the family is "
                         f"{ALIGNED_ONLY}")
    return int(t.item())


def _forward_with_state(params, cfg, x, state, pos: int):
    """Shared by prefill (S >= 1) and decode (S == 1): the segments, each
    followed by the shared block, then the final norm; every residual add
    runs inside the norm after it.  ``state`` is advanced in place."""
    S = x.shape[1]
    positions = pos + torch.arange(S, device=x.device)
    mamba, cache = state["mamba"], state["attn_cache"]
    delta = None
    for s in range(_n_segments(cfg)):
        x, delta = _mamba_segment(
            T._layer(params["mamba_blocks"], s), x, delta, cfg,
            {"ssm": mamba["ssm"][s],
             "conv": {c: mamba["conv"][c][s] for c in "xBC"}})
        x, delta = _shared_block(params["shared"], x, delta, cfg,
                                 positions=positions, cache_k=cache["k"][s],
                                 cache_v=cache["v"][s], cache_pos=pos)
    return L.final_rmsnorm(params["final_norm"], x, delta)


def _shared_block_train(params, x, delta, cfg, positions, mesh=None):
    """One application of the shared block without a cache (training):
    causal attention over the whole sequence, or on a ``mesh`` this rank's
    queries over the keys up to its last position; returns ``(x,
    delta)``, its MLP output pending."""
    x, h = L.add_rmsnorm(params["ln1"], x, delta)
    q, k, v = A.qkv_project(params["attn"], h, cfg, positions)
    off = 0
    if mesh is not None:
        k, v, off = mesh.attention_kv(k, v)
    o = A.gqa_attention(q, k, v, causal=True, q_offset=off,
                        kv_chunk=cfg.kv_chunk)
    x, h = L.add_rmsnorm(params["ln2"], x, A.out_project(params["attn"], o))
    return x, L.mlp(params["mlp"], h)


def forward(params, cfg, tokens, mesh=None):
    """Training forward over the ``param_dtype`` weights: tokens (B, S) ->
    the final hidden states (B, S, d) in the compute dtype.  ``mesh``:
    ``params`` are this rank's shards and ``tokens`` its block (B / dp
    rows, S / tp positions); ``ValueError`` where the SSM heads do not
    split over the sequence's blocks or a block is shorter than the conv's
    history."""
    dtype = torch_dtype(cfg.dtype)
    layer_defs = {"ln": L.rmsnorm_def(cfg.d_model),
                  "mamba": M2.mamba2_def(cfg)}
    off, specs, shared_specs = 0, None, None
    if mesh is not None:
        mesh.heads_per_rank(cfg.ssm_heads, cfg.name)
        mesh.check_halo(tokens.shape[1], cfg.conv_kernel - 1, cfg.name)
        off = mesh.seq_block()[0] * tokens.shape[1]
        specs = tree_map(lambda s: s[2:], mesh.gather_specs["mamba_blocks"])
        shared_specs = mesh.gather_specs["shared"]
    x = T.embed_train(params, tokens, dtype, mesh)
    positions = off + torch.arange(x.shape[1], device=x.device)
    shared = T.block_params(params["shared"], dtype, None, mesh,
                            shared_specs)
    delta = None
    for s in range(_n_segments(cfg)):
        seg = T._layer(params["mamba_blocks"], s)
        for i in range(cfg.shared_attn_every):
            def body(x, delta, p=T._layer(seg, i)):
                p = T.block_params(p, dtype, layer_defs, mesh, specs)
                x, h = L.add_rmsnorm(p["ln"], x, delta)
                return x, M2.mamba2_block(p["mamba"], h, cfg, mesh=mesh)[0]
            x, delta = T._remat(body, cfg.remat)(x, delta)
        x, delta = _shared_block_train(shared, x, delta, cfg, positions,
                                       mesh)
    return L.final_rmsnorm(params["final_norm"], x, delta)


def lm_loss(params, cfg, tokens, labels, loss_chunks: int = 8, mesh=None):
    """``(loss, {"ce", "tokens"})``: the mean next-token cross-entropy of
    :func:`forward`'s hidden states (the logits in float32, a sequence
    chunk at a time); on a ``mesh`` the rank's block scored and the loss
    the global mean."""
    hidden = forward(params, cfg, tokens, mesh)
    ce, cnt = T.loss_from_hidden(T.unembed_train(params, mesh), hidden,
                                 labels, cfg, loss_chunks, mesh)
    return ce, {"ce": ce, "tokens": cnt}


def _embed(params, cfg, tokens):
    return T.embed_tokens(params, tokens).to(torch_dtype(cfg.dtype))


def prefill(params, cfg, tokens, max_len: int):
    """Prompts (B, S) of one length from position 0 -> (state with a
    ``max_len``-row cache, final hidden (B, S, d))."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"zamba prefill: {S} tokens do not fit max_len="
                         f"{max_len}")
    state = init_state(cfg, B, max_len, dtype=torch_dtype(cfg.dtype),
                       device=tokens.device)
    x = _forward_with_state(params, cfg, _embed(params, cfg, tokens), state, 0)
    return state, x


def decode_step(params, cfg, state, tokens, pos):
    """tokens (B, 1) at the one position ``pos`` (an int, or a 0-dim
    tensor) -> float32 logits (B, 1, V); ``state`` is advanced in place."""
    pos = _check_pos(pos)
    x = _forward_with_state(params, cfg, _embed(params, cfg, tokens), state,
                            pos)
    return T.lm_logits(params, x)
