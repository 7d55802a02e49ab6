"""Whisper-style encoder-decoder for serving (conv frontend stubbed).

Counterpart of the serving half of ``repro.models.whisper``: the audio
frontend is a stub, so a request brings precomputed frame embeddings
``(n_frames, d_model)`` (what the two conv layers would produce), fed
straight into the bidirectional encoder.  The decoder has causal
self-attention, cross-attention over the encoder output, LayerNorm (eps
1e-5, population variance, float32 scale and bias) and biased tanh-GELU
MLPs; whisper's attention has q and v biases and no k bias.  Params keep
the reference's keys and shapes (``enc_blocks`` / ``dec_blocks`` stacked
on a leading layer axis).  Training's ``decode_train`` and ``loss`` come
with ROADMAP A13b.

Serving runs through the paged engine: the decoder's self-attention K/V
page like a decoder-only LM's (B1, the paged-attention kernel, at G 1),
and the cross-attention K/V, one linear map of the encoder output a layer,
are computed once a clip and written into a read-only cross-KV pool.  The
encoder runs in streaming chunks (:func:`encode_chunk`) whose attention
is confined to the chunk: the reference's block-diagonal streaming
encode, which equals the whole-clip :func:`encode` only when the clip fits
one chunk.  Every encoder attention is non-causal and without offsets,
so it goes to the flash-attention kernel (B3) at any query and key count:
a chunk's right-pad is cut off the keys (K/V's first ``n_valid`` rows),
the same function as the reference's key mask, which the pad query rows
also see.

The cross read is the reference's own plain route (it runs it with
``use_pallas=False``): gather the slot's cross pages, dequantize int8
pages, then a softmax masked to the slot's ``frames_len``.  A dead decode
slot (``frames_len = 0``, table on the trash page) reads exactly zeros
(:func:`cross_attention`).

The frames are cast to the compute dtype where they enter the encoder, as
the VLM path casts its image embeddings: the reference encodes in the
frames' float32 whatever the compute dtype, and its write of the float32
cross K/V into bf16 cross pages is refused by its own dtype check
(ROADMAP, Queue C).  On the float32 SMOKE config the two are the same.

As in :mod:`repro_torch.models.transformer`, the paged calls write their
K/V **in place** into the pool's storage and a Python loop walks the
layers; int8 weights (``{"q8", "s8"}``) are dequantized a layer at a time.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.module import Param, torch_dtype
from repro_torch.optim.compress import int8_decompress
from repro_torch.serve import pages as PG
from repro_torch.serve import quant as QZ

NEG_INF = A.NEG_INF


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def _attn_def(cfg) -> dict:
    d, hd, h = cfg.d_model, cfg.head_dim, cfg.n_heads
    return {
        "wq": Param((d, h, hd), ("embed_w", "q_heads", "head_dim")),
        "wk": Param((d, h, hd), ("embed_w", "kv_heads", "head_dim")),
        "wv": Param((d, h, hd), ("embed_w", "kv_heads", "head_dim")),
        "wo": Param((h, hd, d), ("q_heads", "head_dim", "embed_w")),
        "bq": Param((h, hd), ("q_heads", "head_dim"), init="zeros"),
        "bv": Param((h, hd), ("kv_heads", "head_dim"), init="zeros"),
        "bo": Param((d,), (None,), init="zeros"),
    }


def _enc_block_def(cfg) -> dict:
    return {
        "ln1": L.layernorm_def(cfg.d_model),
        "attn": _attn_def(cfg),
        "ln2": L.layernorm_def(cfg.d_model),
        "mlp": L.mlp_plain_def(cfg.d_model, cfg.d_ff),
    }


def _dec_block_def(cfg) -> dict:
    return {
        "ln1": L.layernorm_def(cfg.d_model),
        "self_attn": _attn_def(cfg),
        "ln_x": L.layernorm_def(cfg.d_model),
        "cross_attn": _attn_def(cfg),
        "ln2": L.layernorm_def(cfg.d_model),
        "mlp": L.mlp_plain_def(cfg.d_model, cfg.d_ff),
    }


def whisper_defs(cfg) -> dict:
    """Parameter tree of the whole model (encoder and decoder blocks
    stacked); a separate unembedding, as in the reference."""
    return {
        "enc_blocks": T.stack_defs(_enc_block_def(cfg), cfg.n_layers),
        "enc_norm": L.layernorm_def(cfg.d_model),
        "embed": {"table": Param((cfg.padded_vocab, cfg.d_model),
                                 ("vocab", "embed_w"), init="small")},
        "dec_blocks": T.stack_defs(_dec_block_def(cfg), cfg.decoder_layers),
        "dec_norm": L.layernorm_def(cfg.d_model),
        "unembed": {"w": Param((cfg.d_model, cfg.padded_vocab),
                               ("embed_w", "vocab"), init="small")},
    }


# ---------------------------------------------------------------------------
# Attention helpers (MHA with q/v biases, no k bias)
# ---------------------------------------------------------------------------

def _q(p, x):
    return A._heads(x, p["wq"]) + p["bq"]


def _kv(p, x):
    """K and V of ``x``: a self-attention's, or a cross-attention's of the
    encoder output (whisper has no k bias)."""
    return A._heads(x, p["wk"]), A._heads(x, p["wv"]) + p["bv"]


def _out(p, o):
    return A.out_project(p, o) + p["bo"]


def _enc_attn(p, h, n_valid=None):
    """The encoder's bidirectional self-attention on (B, S, d): B3
    (non-causal) over every key, or over the first ``n_valid`` (an int: a
    chunk's right-pad cut off the keys)."""
    q = _q(p, h)
    k, v = _kv(p, h)
    if n_valid is not None:
        k, v = k[:, :n_valid], v[:, :n_valid]
    return _out(p, ops.flash_attention(q, k, v, causal=False))


def cross_attention(q, k, v, frames_len):
    """Non-causal attention of q (B, S, H, D) over k, v (B, F, H, D), each
    slot's keys masked to its first ``frames_len`` (B,): the reference's
    one-block online softmax (float32 scores and accumulation), the
    probabilities of masked keys set to zero.  A slot with no valid frame
    (a dead decode slot) comes out zeros, where the masked softmax alone
    would average its (stale) keys' values."""
    B, S, H, D = q.shape
    F = k.shape[1]
    qh = (q * D ** -0.5).transpose(1, 2)                     # (B, H, S, D)
    s = A._matmul_f32(qh, k.permute(0, 2, 3, 1))            # (B, H, S, F)
    valid = (torch.arange(F, device=q.device)[None, :]
             < frames_len.to(q.device)[:, None])[:, None, None, :]
    s = s + torch.where(valid, 0.0, NEG_INF)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = A._matmul_f32(p.to(v.dtype), v.transpose(1, 2))
    o = o / torch.clamp(l, min=1e-30)
    return o.transpose(1, 2).to(q.dtype)


def _layernorm_mlp(p, x):
    return x + L.mlp_plain(p["mlp"], L.layernorm(p["ln2"], x))


def _blocks(params, name: str, n: int, dtype):
    """Each layer's params of ``params[name]`` in turn, int8 weights
    dequantized to ``dtype`` one layer at a time."""
    for i in range(n):
        yield QZ.dequantize_params(T._layer(params[name], i), dtype)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _encoder(params, cfg, frames, positions, n_valid=None):
    dtype = torch_dtype(cfg.dtype)
    x = frames.to(dtype) + L.sinusoidal_pos(positions,
                                            cfg.d_model).to(dtype)
    for p in _blocks(params, "enc_blocks", cfg.n_layers, dtype):
        x = x + _enc_attn(p["attn"], L.layernorm(p["ln1"], x), n_valid)
        x = _layernorm_mlp(p, x)
    return L.layernorm(params["enc_norm"], x)


def encode(params, cfg, frames):
    """frames: (B, F, d) precomputed frame embeddings -> the encoder
    output (B, F, d); every layer's attention is B3 over the whole clip."""
    return _encoder(params, cfg, frames,
                    torch.arange(frames.shape[1], device=frames.device))


def encode_chunk(params, cfg, frames, start: int, n_valid: int):
    """Encode ONE audio chunk, the streaming unit of chunked encode.

    frames: (1, Cf, d) right-padded frame embeddings at absolute positions
    [start, start + Cf); ``n_valid`` (an int) of them are real.  Attention
    is confined to the chunk (the reference's block-diagonal streaming
    encode: exact when the whole clip fits one chunk).  Returns the
    encoder output for the chunk (1, Cf, d), for :func:`cross_kv_chunk`."""
    Cf = frames.shape[1]
    positions = int(start) + torch.arange(Cf, device=frames.device)
    return _encoder(params, cfg, frames, positions, int(n_valid))


def cross_kv_chunk(params, cfg, enc_chunk):
    """Cross-attention K/V of one encoder-output chunk, every decoder layer:
    enc_chunk (1, Cf, d) -> k, v (Ld, Cf, h, hd), shaped for a page
    scatter with ``n_prefix=1``.  A per-position linear map, so it is exact
    whatever the chunking."""
    dtype = torch_dtype(cfg.dtype)
    ks, vs = [], []
    for p in _blocks(params, "dec_blocks", cfg.decoder_layers, dtype):
        k, v = _kv(p["cross_attn"], enc_chunk)
        ks.append(k[0])
        vs.append(v[0])
    return torch.stack(ks), torch.stack(vs)


def scatter_cross(storage, pages, k, v, *, page_size: int, quant=None):
    """Write one chunk's cross K/V into its cross pages, in place (they are
    written once and only read after).

    storage: {"cross_k", "cross_v"} of (Ld, N, page_size, h, hd), plus
    {"cross_k_scale", "cross_v_scale"} of (Ld, N, page_size, h) with a
    ``quant`` policy (quantized on write, as the self-attention pages);
    pages: (n,) int page ids; k, v: (Ld, n * page_size, h, hd)."""
    def sc(name, val):
        PG.scatter_chunk(storage[name], pages, val, page_size=page_size,
                         n_prefix=1)

    if quant is None:
        sc("cross_k", k)
        sc("cross_v", v)
        return
    qk, sk = quant.quantize(k)
    qv, sv = quant.quantize(v)
    sc("cross_k", qk)
    sc("cross_v", qv)
    sc("cross_k_scale", sk)
    sc("cross_v_scale", sv)


# ---------------------------------------------------------------------------
# Paged decoder
# ---------------------------------------------------------------------------

def _pos_embed(positions, dim: int):
    """Sinusoidal embeddings of a batched position array, (B,) or (B, C) ->
    positions.shape + (dim,).  Whisper has no rope: positions enter the
    decoder only through these additive embeddings."""
    return L.sinusoidal_pos(positions.reshape(-1), dim).reshape(
        *positions.shape, dim)


def _cross_read(p, h, ckv, cross_tables, frames_len):
    """One layer's cross-attention read off its cross pages."""
    cq = _q(p, h)
    ck = PG.gather_pages(ckv["cross_k"], cross_tables)
    cv = PG.gather_pages(ckv["cross_v"], cross_tables)
    if "cross_k_scale" in ckv:
        ck = int8_decompress(ck, PG.gather_pages(ckv["cross_k_scale"],
                                                 cross_tables),
                             axis=-1, dtype=h.dtype)
        cv = int8_decompress(cv, PG.gather_pages(ckv["cross_v_scale"],
                                                 cross_tables),
                             axis=-1, dtype=h.dtype)
    return _out(p, cross_attention(cq, ck, cv, frames_len))


def _paged_decoder(params, cfg, storage, x, *, write, attend, cross_storage,
                   cross_tables, frames_len):
    """Every decoder block against its layer's self and cross pages: the
    self-attention writes its fresh K/V through ``write(kv, k, v)`` before
    ``attend(q, kv)`` reads them (as in the decoder-only model), then the
    cross read, then the MLP.  Returns the final normed hidden states and
    the (empty) expert telemetry of the engine's contract."""
    dtype = x.dtype
    for i, p in enumerate(_blocks(params, "dec_blocks", cfg.decoder_layers,
                                  dtype)):
        kv = T._layer(storage, i)
        h = L.layernorm(p["ln1"], x)
        q = _q(p["self_attn"], h)
        k, v = _kv(p["self_attn"], h)
        write(kv, k, v)
        x = x + _out(p["self_attn"], attend(q, kv))
        h = L.layernorm(p["ln_x"], x)
        x = x + _cross_read(p["cross_attn"], h, T._layer(cross_storage, i),
                            cross_tables, frames_len)
        x = _layernorm_mlp(p, x)
    hidden = L.layernorm(params["dec_norm"], x)
    none = torch.zeros((0,), dtype=torch.int32, device=x.device)
    return hidden, {"expert_tokens": none, "expert_dropped": none.clone()}


def _embed(params, cfg, tokens, positions):
    x = T.embed_tokens(params, tokens, torch_dtype(cfg.dtype))
    return x + _pos_embed(positions, cfg.d_model).to(x.dtype)


def paged_prefill_chunk(params, cfg, storage, table_row, pages_chunk, start,
                        tokens, cross_storage, cross_row, frames_len,
                        quant=None):
    """Prefill one decoder-prompt chunk against paged self and cross
    storage, in place.

    The contract of :func:`repro_torch.models.transformer.
    paged_prefill_chunk` (tokens (1, C) right-padded, pages_chunk covering
    [start, start + C)), plus the read-only cross side: ``cross_storage``
    {"cross_k", "cross_v"} (and scales) of (Ld, N, page_size, h, hd),
    ``cross_row`` (Pc,) the slot's cross page table, ``frames_len`` its
    valid frames (an int or a 0-d tensor).  Returns ``(hidden (1, C, d),
    telemetry)``."""
    page_size = storage["k"].shape[2]
    C = tokens.shape[1]
    dev = tokens.device
    x = _embed(params, cfg, tokens, start + torch.arange(C, device=dev))
    tables = table_row[None]
    lengths = A.window_lengths(start, 1, dev)
    flen = torch.as_tensor(frames_len, device=dev).reshape(1)

    def write(kv, k, v):
        T._write_kv(kv, k[0], v[0], quant,
                    lambda st, val: PG.scatter_chunk(st, pages_chunk, val,
                                                     page_size=page_size))

    def attend(q, kv):
        return A.paged_window_attention(q, kv["k"], kv["v"], tables, lengths,
                                        k_scale=kv.get("k_scale"),
                                        v_scale=kv.get("v_scale"))

    return _paged_decoder(params, cfg, storage, x, write=write, attend=attend,
                          cross_storage=cross_storage,
                          cross_tables=cross_row[None], frames_len=flen)


def paged_decode_step(params, cfg, storage, tables, lengths, tokens,
                      write_pages, write_offs, cross_storage, cross_tables,
                      frames_len, quant=None):
    """One decode token a slot with a cross read, in place.

    The self side is :func:`repro_torch.models.transformer.
    paged_decode_step`'s; ``cross_tables`` (B, Pc) and ``frames_len`` (B,)
    add each slot's cross read (dead slots: the trash page and 0 frames).
    Returns ``(float32 logits (B, 1, V), telemetry)``."""
    x = _embed(params, cfg, tokens, lengths[:, None])
    valid = A.window_lengths(lengths, lengths.shape[0], x.device)

    def write(kv, k, v):
        T._write_kv(kv, k[:, 0], v[:, 0], quant,
                    lambda st, val: PG.scatter_token(st, write_pages,
                                                     write_offs, val))

    def attend(q, kv):
        return A.paged_decode_attention(q, kv["k"], kv["v"], tables, valid,
                                        k_scale=kv.get("k_scale"),
                                        v_scale=kv.get("v_scale"))

    hidden, tel = _paged_decoder(params, cfg, storage, x, write=write,
                                 attend=attend, cross_storage=cross_storage,
                                 cross_tables=cross_tables,
                                 frames_len=frames_len)
    return T.lm_logits(params, hidden), tel


def paged_verify_chunk(params, cfg, storage, tables, lengths, tokens,
                       write_pages, write_offs, cross_storage, cross_tables,
                       frames_len, quant=None):
    """Score a (B, C) candidate window in one forward (speculative verify):
    :func:`repro_torch.models.transformer.paged_verify_chunk` plus the
    cross read.  C == 1 is a decode step.  Returns ``(float32 logits
    (B, C, V), telemetry)``."""
    C = tokens.shape[1]
    positions = lengths[:, None] + torch.arange(C, device=tokens.device)
    x = _embed(params, cfg, tokens, positions)
    valid = A.window_lengths(lengths, lengths.shape[0], x.device)

    def write(kv, k, v):
        T._write_kv(kv, k, v, quant,
                    lambda st, val: PG.scatter_window(st, write_pages,
                                                      write_offs, val))

    def attend(q, kv):
        return A.paged_window_attention(q, kv["k"], kv["v"], tables, valid,
                                        k_scale=kv.get("k_scale"),
                                        v_scale=kv.get("v_scale"))

    hidden, tel = _paged_decoder(params, cfg, storage, x, write=write,
                                 attend=attend, cross_storage=cross_storage,
                                 cross_tables=cross_tables,
                                 frames_len=frames_len)
    return T.lm_logits(params, hidden), tel


# ---------------------------------------------------------------------------
# Dense per-slot state (the reference's prefill / decode_step)
# ---------------------------------------------------------------------------

def init_state(cfg, batch: int, max_len: int, *, dtype, device) -> dict:
    """Zeroed state: self K/V of (Ld, batch, max_len, h, hd) and cross K/V
    of (Ld, batch, n_audio_frames, h, hd)."""
    h, hd, Ld = cfg.n_heads, cfg.head_dim, cfg.decoder_layers
    F = cfg.n_audio_frames

    def z(n):
        return torch.zeros((Ld, batch, n, h, hd), dtype=dtype, device=device)

    return {"self_k": z(max_len), "self_v": z(max_len),
            "cross_k": z(F), "cross_v": z(F)}


def state_specs(cfg) -> dict:
    """The logical axes of :func:`init_state`'s leaves (the reference's)."""
    s = (None, "batch", "kv_seq", None, None)
    c = (None, "batch", "frames", None, None)
    return {"self_k": s, "self_v": s, "cross_k": c, "cross_v": c}


def _cross(p, h, ek, ev, cfg):
    """Cross-attention against whole encoder K/V (every frame valid)."""
    return _out(p, A.gqa_attention(_q(p, h), ek, ev, causal=False,
                                   kv_chunk=cfg.kv_chunk))


def prefill(params, cfg, frames, tokens, max_len: int):
    """Encode the audio (B, F, d), precompute every layer's cross K/V, run
    the decoder prompt (B, S).  Returns ``(state, final hidden (B, S,
    d))``; the state holds the prompt's self K/V in its first S positions
    and zeros after."""
    B, S = tokens.shape
    enc_out = encode(params, cfg, frames)
    dev = tokens.device
    x = _embed(params, cfg, tokens, torch.arange(S, device=dev))
    state = init_state(cfg, B, max_len, dtype=x.dtype, device=dev)
    for i, p in enumerate(_blocks(params, "dec_blocks", cfg.decoder_layers,
                                  x.dtype)):
        h = L.layernorm(p["ln1"], x)
        k, v = _kv(p["self_attn"], h)
        x = x + _out(p["self_attn"], A.gqa_attention(
            _q(p["self_attn"], h), k, v, causal=True))
        ek, ev = _kv(p["cross_attn"], enc_out)
        x = x + _cross(p["cross_attn"], L.layernorm(p["ln_x"], x), ek, ev,
                       cfg)
        x = _layernorm_mlp(p, x)
        state["self_k"][i, :, :S] = k
        state["self_v"][i, :, :S] = v
        state["cross_k"][i] = ek
        state["cross_v"][i] = ev
    return state, L.layernorm(params["dec_norm"], x)


def decode_step(params, cfg, state, tokens, pos):
    """One new token a row (B, 1) against the self cache and the fixed cross
    K/V, the self K/V written into ``state`` in place at ``pos`` (an int,
    or (B,) ragged rows).  Returns float32 logits (B, 1, V)."""
    dev = tokens.device
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=dev)
    positions = pos.expand(B).long()
    x = _embed(params, cfg, tokens, positions[:, None])
    max_len = state["self_k"].shape[2]
    rows = torch.arange(B, device=dev)
    cols = positions.clamp(0, max_len - 1)
    for i, p in enumerate(_blocks(params, "dec_blocks", cfg.decoder_layers,
                                  x.dtype)):
        h = L.layernorm(p["ln1"], x)
        k, v = _kv(p["self_attn"], h)
        ck, cv = state["self_k"][i], state["self_v"][i]
        ck.index_put_((rows, cols), k[:, 0])
        cv.index_put_((rows, cols), v[:, 0])
        x = x + _out(p["self_attn"], A.gqa_attention(
            _q(p["self_attn"], h), ck, cv, causal=True, q_offset=pos,
            kv_valid_len=pos + 1, kv_chunk=max(max_len, 1)))
        x = x + _cross(p["cross_attn"], L.layernorm(p["ln_x"], x),
                       state["cross_k"][i], state["cross_v"][i], cfg)
        x = _layernorm_mlp(p, x)
    return T.lm_logits(params, L.layernorm(params["dec_norm"], x))
