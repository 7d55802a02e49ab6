"""RWKV-6 language model: embed -> layernorm -> [rwkv blocks] -> layernorm
-> head.

Counterpart of ``repro.models.rwkv_lm``.  The decode
state is O(1) in the sequence length: per layer a (B, H, K, V) float32 wkv
state plus the one-token shift buffers of the time and channel mix, float32
too.  The reference scans the stacked layers with ``jax.lax.scan`` and
returns a new state; here a Python loop walks the layers and writes each
layer's slice of the state **in place** (the kernel writes the wkv state,
the loop the shift buffers), so the caller's one copy is the result.

Training (:func:`forward`, :func:`lm_loss`) runs the blocks from a zero
state with no state kept: each block is cast to the compute dtype (its
float32 leaves kept) and recomputed in the backward pass under
``cfg.remat``, and the wkv kernel's backward is a kernel too
(:func:`repro_torch.kernels.ops.rwkv6_scan`).  Over a mesh (``mesh=``, a
:class:`repro_torch.mesh.grad_comm.TrainMesh`) a rank runs its block of
rows and positions: the embedding table and the unembedding are gathered
whole in float32, each block's weights inside its recomputed body, and
the wkv scan runs on the rank's heads over every position
(:mod:`repro_torch.models.rwkv6`).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import rwkv6 as R
from repro_torch.models import transformer as T
from repro_torch.models.module import Param, torch_dtype, tree_map


def rwkv_lm_defs(cfg) -> dict:
    """Parameter tree of the whole model (blocks stacked)."""
    return {
        "embed": {"table": Param((cfg.padded_vocab, cfg.d_model),
                                 ("vocab", "embed_w"), init="small")},
        "ln_in": L.layernorm_def(cfg.d_model),
        "blocks": T.stack_defs(R.rwkv_block_def(cfg), cfg.n_layers),
        "final_norm": L.layernorm_def(cfg.d_model),
        "unembed": {"w": Param((cfg.d_model, cfg.padded_vocab),
                               ("embed_w", "vocab"), init="small")},
    }


def state_specs(cfg) -> dict:
    """The logical axes of :func:`init_state`'s leaves (the reference's)."""
    return {"wkv": (None, "batch", None, None, "rwkv_v"),
            "tm_prev": (None, "batch", None, None),
            "cm_prev": (None, "batch", None, None)}


def init_state(cfg, batch: int, *, device) -> dict:
    """Zeroed decode state: ``wkv`` (L, batch, H, K, V), ``tm_prev`` and
    ``cm_prev`` (L, batch, 1, d), all float32."""
    Lh, H, hd, d = cfg.n_layers, cfg.rwkv_heads, cfg.rwkv_head_dim, cfg.d_model
    f32 = torch.float32
    return {
        "wkv": torch.zeros(Lh, batch, H, hd, hd, dtype=f32, device=device),
        "tm_prev": torch.zeros(Lh, batch, 1, d, dtype=f32, device=device),
        "cm_prev": torch.zeros(Lh, batch, 1, d, dtype=f32, device=device),
    }


def forward(params, cfg, tokens, mesh=None):
    """Training forward over the ``param_dtype`` weights: tokens (B, S) ->
    the final hidden states (B, S, d) in the compute dtype.  ``mesh``:
    ``params`` are this rank's shards and ``tokens`` its block (B / dp
    rows, S / tp positions); ``ValueError`` where the heads do not split
    over the sequence's blocks."""
    dtype = torch_dtype(cfg.dtype)
    defs = R.rwkv_block_def(cfg)
    specs = None
    if mesh is not None:
        mesh.heads_per_rank(cfg.rwkv_heads, cfg.name)
        specs = tree_map(lambda s: s[1:], mesh.gather_specs["blocks"])
    x = L.layernorm(params["ln_in"], T.embed_train(params, tokens, dtype,
                                                   mesh))
    for i in range(cfg.n_layers):
        def body(x, p=T._layer(params["blocks"], i)):
            p = T.block_params(p, dtype, defs, mesh, specs)
            return R.rwkv_block(p, x, cfg, mesh=mesh)[0]
        x = T._remat(body, cfg.remat)(x)
    return L.layernorm(params["final_norm"], x)


def lm_loss(params, cfg, tokens, labels, loss_chunks: int = 8, mesh=None):
    """``(loss, {"ce", "tokens"})``: the mean next-token cross-entropy of
    :func:`forward`'s hidden states, the logits taken a sequence chunk at
    a time in float32 (:func:`repro_torch.models.transformer.
    loss_from_hidden`); on a ``mesh`` the rank's block scored and the loss
    the global mean."""
    hidden = forward(params, cfg, tokens, mesh)
    ce, cnt = T.loss_from_hidden(T.unembed_train(params, mesh), hidden,
                                 labels, cfg, loss_chunks, mesh)
    return ce, {"ce": ce, "tokens": cnt}


def _embed(params, cfg, tokens):
    return T.embed_tokens(params, tokens).to(torch_dtype(cfg.dtype))


def _forward_with_state(params, cfg, x, state):
    """Run the blocks over ``x`` (B, S, d) from ``state``, which is updated
    in place; returns the final-normed hidden states."""
    x = L.layernorm(params["ln_in"], x)
    for i in range(cfg.n_layers):
        tm_prev, cm_prev = state["tm_prev"][i], state["cm_prev"][i]
        x, _, new_tm, new_cm = R.rwkv_block(
            T._layer(params["blocks"], i), x, cfg, tm_state=state["wkv"][i],
            tm_prev=tm_prev, cm_prev=cm_prev)
        tm_prev.copy_(new_tm)           # float32, as the reference stores it
        cm_prev.copy_(new_cm)
    return L.layernorm(params["final_norm"], x)


def prefill(params, cfg, tokens):
    """Whole prompts (B, S) from a zero state -> (state, final hidden
    (B, S, d)).  A right-padded prompt runs its pad tokens through the
    recurrence too, as in the reference: the state is the padded
    sequence's."""
    state = init_state(cfg, tokens.shape[0], device=tokens.device)
    x = _forward_with_state(params, cfg, _embed(params, cfg, tokens), state)
    return state, x


def decode_step(params, cfg, state, tokens, pos=None):
    """tokens (B, 1) -> float32 logits (B, 1, V); ``state`` is advanced in
    place.  ``pos`` is ignored: the position enters through the state."""
    del pos
    x = _forward_with_state(params, cfg, _embed(params, cfg, tokens), state)
    return T.lm_logits(params, x)
