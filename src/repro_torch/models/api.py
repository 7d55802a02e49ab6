"""Model API of the port: :class:`DecoderLM`, :class:`VLM`,
:class:`RwkvLM`, :class:`HybridLM`, :class:`Whisper` and
:func:`build_model`.

Counterpart of ``repro.models.api`` for the serving paths:
the dense and MoE decoders paged (chunked prefill, decode and speculative
verify windows against a page pool, and a cache-free scoring forward)
and dense per-slot (whole-prompt prefill and decode against a per-slot
cache), llava's VLM as a decoder whose prompts may start with precomputed
image embeddings, rwkv6 on the dense per-slot path (a recurrent state per
slot), zamba2 as an aligned batch (prefill, then decode at one position
for every row), and whisper's encoder-decoder paged, its cross-attention
K/V in a read-only cross-KV pool.  The members are plain functions over
dict-of-tensor params, which is all the serving engine calls.

The serving-mesh rules are the reference's (``SERVE_TP_AXES``): a family
with a paged KV cache serves Megatron-style tensor-parallel — attention
heads, MLP ff, the experts and the unembedding's vocab split over the
``"model"`` axis (:meth:`DecoderLM.serve_param_specs`), the KV pages' head
axis too (:meth:`DecoderLM.paged_storage_specs`) — and, on a 2-D
``("expert", "model")`` mesh, the expert stacks over both axes, expert
major.  A family without one (rwkv6, and a dense-path ``DecoderLM``)
serves slot-parallel: the params replicated, the decode state's slot axis
split over ``"model"`` (``serve_state_specs``).  Specs are tuples, one
entry an axis: None, a mesh axis name, or a tuple of names.
"""
from __future__ import annotations

__all__ = ["ArraySpec", "DecoderLM", "HybridLM", "RwkvLM", "SERVE_TP_AXES",
           "VLM", "Whisper", "build_model"]

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv_lm as RW
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models import zamba as Z
from repro_torch.models.module import (init_params, mesh_spec,
                                       resolve_device, torch_dtype, tree_map)

# -- serving-mesh sharding rules (the reference's) ---------------------------
# logical axis -> serving-mesh axis; every other logical axis is replicated
SERVE_TP_AXES: dict = {
    "q_heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
}


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Shape, dtype and logical axis names of one input array (the
    reference's ``ArraySpec`` without its JAX sharding)."""
    shape: tuple
    dtype: torch.dtype
    spec: tuple


def _param_specs(defs, table) -> dict:
    return tree_map(lambda p: mesh_spec(p.logical_axes(), table), defs)


def _slot_specs(logical) -> dict:
    """Slot-parallel specs of a decode state: the logical ``"batch"`` axis
    of every leaf split over ``"model"``, the rest replicated."""
    return tree_map(lambda spec: tuple("model" if ax == "batch" else None
                                       for ax in spec), logical)


def _no_tp_specs(cfg):
    return NotImplementedError(
        f"{cfg.family} has no TP serving specs (engine slot-parallel mode "
        "replicates params instead)")


def _validate_mesh(model, tp: int, ep: int) -> None:
    """The reference's ``validate_serve_mesh``: raise with every
    indivisible dimension named for a (tp, ep) serving mesh."""
    cfg = model.cfg
    if ep > 1 and not cfg.n_experts:
        raise ValueError(
            f"{cfg.name} ({cfg.family}) is a dense family with no "
            f"experts: expert-parallel ep={ep} cannot apply — drop the "
            "expert axis (--mesh tp=N)")
    if tp <= 1 and ep <= 1:
        return
    bad = []
    if model.supports_paged_decode():
        if tp > 1:
            dims = {"padded_q_heads": cfg.padded_q_heads,
                    "padded_kv_heads": cfg.padded_kv_heads,
                    "padded_vocab": cfg.padded_vocab}
            if not cfg.n_experts or cfg.dense_residual:
                dims["d_ff"] = cfg.d_ff
            bad += [f"{k}={v} (tp={tp})" for k, v in dims.items() if v % tp]
        if cfg.n_experts and cfg.n_experts % (ep * tp):
            # the experts split over both axes (tp cuts expert rows even on
            # a 1-D mesh), so the product must divide the stack
            shards = f"ep*tp={ep * tp}" if ep > 1 else f"tp={tp}"
            bad.append(f"n_experts={cfg.n_experts} ({shards})")
    elif ep > 1:
        bad.append(f"family={cfg.family} has no paged expert path (ep={ep})")
    if bad:
        raise ValueError(f"{cfg.name}: serving mesh (tp={tp}, ep={ep}) does "
                         "not divide " + ", ".join(bad))


def _generator(generator_or_seed, dev) -> torch.Generator:
    if isinstance(generator_or_seed, torch.Generator):
        return generator_or_seed
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(generator_or_seed))
    return gen


def _init_float(model, generator_or_seed, device, dtype, weight_quant,
                serves: str) -> dict:
    """``init`` of a family that serves off the paged path: random weights
    without quantization (``weight_quant="int8"`` is refused, naming where
    the family ``serves``)."""
    cfg = model.cfg
    if weight_quant not in (None, "off"):
        raise ValueError(
            f"weight_quant={weight_quant!r} is refused for {cfg.name} "
            f"({cfg.family}): int8 weights are wired through the paged "
            f"serving path only, and this family serves {serves}")
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype) if dtype is None else dtype
    return init_params(model.param_defs(), _generator(generator_or_seed, dev),
                       device=dev, dtype=dt)


class DecoderLM:
    """Decoder-only transformer LM, dense or MoE: paged prefill chunks,
    decode and verify windows (each returning the per-expert telemetry
    beside its output), whole-prompt prefill and decode on a per-slot
    cache, the logits head."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def param_defs(self) -> dict:
        """Tree of :class:`repro_torch.models.module.Param` for every weight."""
        return T.transformer_defs(self.cfg)

    def init(self, generator_or_seed: Union[torch.Generator, int] = 0, *,
             device=None, dtype: Optional[torch.dtype] = None,
             weight_quant: Optional[str] = None) -> dict:
        """Random weights on ``device`` (``cuda`` unless named) in ``dtype``
        (the config's compute dtype unless named).  A seed builds a
        ``torch.Generator`` on the device; a generator must live there.

        ``weight_quant="int8"`` quantizes each weight as soon as it is drawn
        (:func:`repro_torch.serve.quant.quantize_params`, leaf by leaf), so
        the float weights never exist all at once; the result equals
        ``quantize_params(init(...))``."""
        from repro_torch.serve.quant import quantize_params
        dev = resolve_device(device)
        dt = torch_dtype(self.cfg.dtype) if dtype is None else dtype
        if weight_quant not in (None, "off", "int8"):
            raise ValueError(f"unknown weight_quant {weight_quant!r}; want "
                             "'int8' or 'off'")
        finish = quantize_params if weight_quant == "int8" else None
        return init_params(self.param_defs(), _generator(generator_or_seed,
                                                         dev),
                           device=dev, dtype=dt, finish=finish)

    def supports_paged_decode(self) -> bool:
        """Whether the family has a per-token KV cache that can page."""
        return not T.uses_window_cache(self.cfg)

    def engine_refusal(self) -> Optional[str]:
        """None: the serving engine serves the model; for a window-cache
        model (gemma3) why it does not: its mixed cache decodes only as an
        aligned batch, as in the reference."""
        return T.WINDOW_ALIGNED_ONLY if T.uses_window_cache(self.cfg) \
            else None

    # -- training ---------------------------------------------------------------

    def loss(self, params, batch: dict, mesh=None):
        """Mean next-token loss of ``batch`` ``{"tokens", "labels"}`` (B, S)
        over float32 weights -> ``(loss, {"ce", "aux", "tokens"})``; an
        MoE model raises ``NotImplementedError`` (ROADMAP A13b).  ``mesh``:
        a :class:`repro_torch.mesh.grad_comm.TrainMesh` (``params`` this
        rank's shards, ``batch`` its block; the loss the global mean)."""
        return T.lm_loss(params, self.cfg, tokens=batch["tokens"],
                         labels=batch["labels"], mesh=mesh)

    def train_batch_specs(self, shape) -> dict:
        """:class:`ArraySpec` of each training-batch key at ``shape``'s
        ``global_batch`` x ``seq_len``."""
        B, S = shape.global_batch, shape.seq_len
        tok = ArraySpec((B, S), torch.int32, ("batch", "seq"))
        return {"tokens": tok, "labels": tok}

    def prefill_batch_specs(self, shape) -> dict:
        """The training specs without ``labels``: what prefill takes."""
        specs = dict(self.train_batch_specs(shape))
        specs.pop("labels")
        return specs

    def paged_leaf_specs(self, quant=None):
        """``{"k", "v"}`` :class:`repro_torch.serve.pages.PagedLeafSpec`:
        (L, num_pages, page_size, Hkv, D) in the compute dtype; with a KV
        ``quant`` policy, int8 pages plus ``k_scale``/``v_scale`` leaves
        (:func:`repro_torch.serve.quant.quantize_leaf_specs`)."""
        from repro_torch.serve.pages import PagedLeafSpec
        from repro_torch.serve.quant import quantize_leaf_specs
        cfg = self.cfg
        leaf = PagedLeafSpec((cfg.n_layers,),
                             (cfg.padded_kv_heads, cfg.head_dim),
                             torch_dtype(cfg.dtype))
        return quantize_leaf_specs({"k": leaf, "v": leaf}, quant)

    def paged_prefill_chunk(self, params, storage, table_row, pages_chunk,
                            start, tokens, *, quant=None, placement=None,
                            comm=None, ep_comm=None, embeds=None):
        """Prefill tokens (1, C) at positions [start, start + C) into pages
        (in place, quantized on write with a KV ``quant`` policy; an MoE
        model's experts dispatched through the (3, E) ``placement`` map);
        returns ``(hidden (1, C, d), telemetry)``, telemetry the
        layer-summed ``{"expert_tokens", "expert_dropped"}`` int32 (E,)
        ((0,) for a dense model).  ``comm`` / ``ep_comm``: the serving
        mesh's ``"model"`` / ``"expert"`` transports, with ``params`` and
        ``storage`` the rank's shards (None: one device).  ``embeds``: None,
        or (1, C, d) rows that replace the embeddings where ``tokens`` is
        negative (a VLM's image prefix)."""
        return T.paged_prefill_chunk(params, self.cfg, storage, table_row,
                                     pages_chunk, start, tokens, quant=quant,
                                     placement=placement, comm=comm,
                                     ep_comm=ep_comm, embeds=embeds)

    def paged_decode_step(self, params, storage, tables, lengths, tokens,
                          write_pages, write_offs, *, quant=None,
                          placement=None, comm=None, ep_comm=None):
        """tokens (B, 1) -> ``(float32 logits (B, 1, V), telemetry)``; K/V
        written in place (quantized on write with a KV ``quant`` policy);
        ``comm`` / ``ep_comm`` as in :meth:`paged_prefill_chunk` (the
        logits all-gathered over the vocab shards)."""
        return T.paged_decode_step(params, self.cfg, storage, tables, lengths,
                                   tokens, write_pages, write_offs,
                                   quant=quant, placement=placement,
                                   comm=comm, ep_comm=ep_comm)

    def paged_verify(self, params, storage, tables, lengths, tokens,
                     write_pages, write_offs, *, quant=None, placement=None,
                     comm=None, ep_comm=None):
        """A speculative verify window: tokens (B, C) -> ``(float32 logits
        (B, C, V), telemetry)``; the window's K/V written in place at
        (write_pages, write_offs) (B, C) (quantized on write with a KV
        ``quant`` policy); ``comm`` / ``ep_comm`` as in
        :meth:`paged_decode_step`."""
        return T.paged_verify_chunk(params, self.cfg, storage, tables,
                                    lengths, tokens, write_pages, write_offs,
                                    quant=quant, placement=placement,
                                    comm=comm, ep_comm=ep_comm)

    def forward(self, params, tokens, *, comm=None, ep_comm=None):
        """Scoring forward without a cache: tokens (B, S) -> final hidden
        states (B, S, d) (the self-drafter runs it on a truncated model;
        under a mesh on the rank's shards, with the mesh's transports)."""
        return T.forward(params, self.cfg, tokens, comm, ep_comm)

    def prefill(self, params, tokens, max_len: Optional[int] = None):
        """Whole prompts (B, S) -> (cache, final hidden (B, S, d)); the
        cache's sequence axis is ``max_len`` (S unless named)."""
        return T.prefill(params, self.cfg, tokens, max_len)

    def init_decode_state(self, batch: int, max_len: int, *, device=None):
        """Zeroed per-slot cache ``{"k", "v"}`` of (L, batch, max_len, Hkv, D)
        in the compute dtype on ``device`` (``cuda`` unless named); for a
        window-cache model the mixed cache of the global layers' ``{"k",
        "v"}`` and the sliding-window layers' rings ``{"k_loc", "v_loc"}``
        (:func:`repro_torch.models.transformer.init_cache`)."""
        return T.init_cache(self.cfg, batch, max_len,
                            dtype=torch_dtype(self.cfg.dtype),
                            device=resolve_device(device))

    def decode_step(self, params, state, tokens, pos):
        """tokens (B, 1) at positions ``pos`` ((B,) or an int) -> float32
        logits (B, 1, V); the K/V are written into ``state`` in place.  A
        window-cache model takes one int for the whole batch, and a
        position vector raises ``ValueError``."""
        return T.decode_step(params, self.cfg, state, tokens, pos)

    def lm_head(self, params, hidden, comm=None):
        """Project final hidden states to float32 vocab logits (an int8
        unembedding dequantized to the hidden states' dtype first); with a
        mesh ``comm`` the rank's vocab shard, all-gathered."""
        return T.lm_logits(params, hidden, comm)

    # -- serving-mesh rules ---------------------------------------------------

    def serve_param_specs(self, ep: int = 1) -> dict:
        """Mesh specs of the params under tensor-parallel paged serving:
        attention heads, MLP ff, the experts and the unembedding's vocab
        split over ``"model"``; the norms, the router and the embedding
        table (its lookup needs every row) replicated.  ``ep > 1``: the
        expert stacks split over ``("expert", "model")``, expert major."""
        table = dict(SERVE_TP_AXES)
        if ep > 1:
            table["experts"] = ("expert", "model")
        specs = _param_specs(self.param_defs(), table)
        specs["embed"]["table"] = (None, None)
        return specs

    def serve_state_specs(self, batch: int, max_len: int) -> dict:
        """Slot-parallel specs of the dense per-slot cache (a window-cache
        model's mixed one): its slot axis over ``"model"``."""
        del batch, max_len
        return _slot_specs(T.cache_specs(self.cfg))

    def paged_storage_specs(self, quant=None) -> dict:
        """Mesh specs of the page pool's storage under tensor-parallel
        serving: the leading suffix axis of every :meth:`paged_leaf_specs`
        leaf (the KV-head axis; a scale leaf's whole suffix) over
        ``"model"``."""
        return tree_map(
            lambda s: (None,) * (len(s.prefix) + 2) + ("model",)
            + (None,) * (len(s.suffix) - 1), self.paged_leaf_specs(quant))

    def validate_serve_mesh(self, tp: int = 1, ep: int = 1) -> None:
        """Raise with every indivisible dimension named for a (tp, ep)
        serving mesh; ``ep > 1`` on a dense family is refused outright."""
        _validate_mesh(self, tp, ep)

    def validate_serve_tp(self, tp: int) -> None:
        """:meth:`validate_serve_mesh` on a 1-D mesh."""
        self.validate_serve_mesh(tp=tp)

    def validate_serve_encoder(self, *, page_size: int, max_len: int,
                               prefix_cache: bool = False) -> None:
        """A text-only family has no encoder: nothing to check."""


class VLM(DecoderLM):
    """LLaVA-style: precomputed anyres patch embeddings in front of the text
    (the modality frontend is a stub, as in the reference).  On the paged
    engine the image rides as a prefix of pseudo-tokens whose rows
    :meth:`DecoderLM.paged_prefill_chunk` takes from ``embeds``."""

    def loss(self, params, batch: dict, mesh=None):
        """Refused: training with image prefixes comes with ROADMAP A13b."""
        raise NotImplementedError(
            f"{self.cfg.name}: VLM training (image-prefix batches) comes "
            "with ROADMAP A13b")

    def train_batch_specs(self, shape) -> dict:
        """Refused with :meth:`loss`."""
        raise NotImplementedError(
            f"{self.cfg.name}: VLM training batches come with ROADMAP A13b")

    def _embeds(self, params, batch):
        txt = T.embed_tokens(params, batch["tokens"],
                             torch_dtype(self.cfg.dtype))
        img = batch["image_embeds"].to(txt.dtype)
        return torch.cat([img, txt], dim=1)

    def prefill(self, params, batch, max_len: Optional[int] = None):
        """``batch``: ``{"tokens": (B, S), "image_embeds": (B, I, d)}`` ->
        (cache, final hidden (B, I + S, d)); the image rows come first."""
        return T.prefill(params, self.cfg, max_len=max_len,
                         inputs_embeds=self._embeds(params, batch))

    def validate_serve_encoder(self, *, page_size: int, max_len: int,
                               prefix_cache: bool = False) -> None:
        """The image prefix takes ``n_image_tokens`` leading positions of
        every image request, so it must leave room for text and one
        generated token inside ``max_len``, and, with the prefix cache
        sharing image pages, tile exactly into pages (a boundary page would
        mix image and text and never be sharable).  The reference's
        messages."""
        cfg = self.cfg
        I = cfg.n_image_tokens
        if I + 1 >= max_len:
            raise ValueError(
                f"{cfg.name}: n_image_tokens={I} leaves no room inside "
                f"max_len={max_len} for a text prompt plus one generated "
                f"token; raise max_len to at least {I + 2} (--max-len)")
        if prefix_cache and I % page_size:
            fix = max(d for d in range(1, page_size + 1) if I % d == 0)
            raise ValueError(
                f"{cfg.name}: n_image_tokens={I} is not a multiple of "
                f"page_size={page_size}, so image-prefix pages can never be "
                "shared through the prefix cache (the boundary page would "
                "mix image and text content).  Fix: pass a page size that "
                f"divides {I} — e.g. --page-size {fix} — or disable "
                "--prefix-cache")


class RwkvLM:
    """RWKV-6 LM: an O(1) recurrent decode state per slot, so it serves on
    the dense per-slot path only (whole-prompt prefill, batched decode, the
    logits head)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def param_defs(self) -> dict:
        """Tree of :class:`repro_torch.models.module.Param` for every weight
        (the norms, ``u``, ``decay_base`` and ``w_o`` declared float32)."""
        return RW.rwkv_lm_defs(self.cfg)

    def loss(self, params, batch: dict, mesh=None):
        """Refused: rwkv6 training (B4's backward) comes with ROADMAP A13b
        item 4."""
        raise NotImplementedError(
            f"{self.cfg.name}: rwkv6 training (the wkv scan's backward) "
            "comes with ROADMAP A13b item 4")

    def train_batch_specs(self, shape) -> dict:
        """Refused with :meth:`loss`."""
        raise NotImplementedError(
            f"{self.cfg.name}: rwkv6 training batches come with ROADMAP "
            "A13b item 4")

    def init(self, generator_or_seed: Union[torch.Generator, int] = 0, *,
             device=None, dtype: Optional[torch.dtype] = None,
             weight_quant: Optional[str] = None) -> dict:
        """Random weights on ``device`` (``cuda`` unless named) in ``dtype``
        (the config's compute dtype unless named), the float32 leaves in
        float32.  A seed builds a ``torch.Generator`` on the device; a
        generator must live there.  ``weight_quant="int8"`` is refused: int8
        weights are wired through the paged serving path only."""
        return _init_float(self, generator_or_seed, device, dtype,
                           weight_quant, "on the dense per-slot path")

    def supports_paged_decode(self) -> bool:
        """False: a recurrent state has no per-token KV cache to page."""
        return False

    def engine_refusal(self) -> Optional[str]:
        """None: the serving engine serves the family (dense path)."""
        return None

    def prefill(self, params, tokens):
        """Whole prompts (B, S) -> (state, final hidden (B, S, d))."""
        return RW.prefill(params, self.cfg, tokens)

    def init_decode_state(self, batch: int, max_len: int, *, device=None):
        """Zeroed per-slot state ``{"wkv", "tm_prev", "cm_prev"}`` (float32)
        on ``device`` (``cuda`` unless named); ``max_len`` is ignored."""
        del max_len
        return RW.init_state(self.cfg, batch, device=resolve_device(device))

    def decode_step(self, params, state, tokens, pos=None):
        """tokens (B, 1) -> float32 logits (B, 1, V); ``state`` advanced in
        place; ``pos`` is ignored."""
        return RW.decode_step(params, self.cfg, state, tokens, pos)

    def lm_head(self, params, hidden):
        """Project final hidden states to float32 vocab logits."""
        return T.lm_logits(params, hidden)

    def serve_param_specs(self, ep: int = 1):
        """Refused: the family serves slot-parallel, params replicated."""
        raise _no_tp_specs(self.cfg)

    def serve_state_specs(self, batch: int, max_len: int) -> dict:
        """Slot-parallel specs of the recurrent state: its slot axis over
        ``"model"``."""
        del batch, max_len
        return _slot_specs(RW.state_specs(self.cfg))

    def validate_serve_mesh(self, tp: int = 1, ep: int = 1) -> None:
        """The reference's checks; ``ep > 1`` is refused (no paged expert
        path)."""
        _validate_mesh(self, tp, ep)


class HybridLM:
    """Zamba2-style Mamba-2 / shared-attention hybrid: served as an aligned
    batch, as in the reference (prefill of prompts of one length, then
    decode steps at one position for the whole batch, the logits head).
    The serving engine refuses the family, as the reference's launcher
    does."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def param_defs(self) -> dict:
        """Tree of :class:`repro_torch.models.module.Param` for every weight
        (each Mamba layer's ``A_log``, ``D``, ``dt_bias`` and conv weights
        declared float32)."""
        return Z.zamba_defs(self.cfg)

    def loss(self, params, batch: dict, mesh=None):
        """Refused: zamba2 training (B5's backward, B3 at D 112) comes
        with ROADMAP A13b item 4."""
        raise NotImplementedError(
            f"{self.cfg.name}: zamba2 training (the SSD scan's and the gated "
            "norm's backward, B3 at head dim 112) comes with ROADMAP A13b "
            "item 4")

    def train_batch_specs(self, shape) -> dict:
        """Refused with :meth:`loss`."""
        raise NotImplementedError(
            f"{self.cfg.name}: zamba2 training batches come with ROADMAP "
            "A13b item 4")

    def init(self, generator_or_seed: Union[torch.Generator, int] = 0, *,
             device=None, dtype: Optional[torch.dtype] = None,
             weight_quant: Optional[str] = None) -> dict:
        """Random weights on ``device`` (``cuda`` unless named) in ``dtype``
        (the config's compute dtype unless named), the float32 leaves in
        float32.  A seed builds a ``torch.Generator`` on the device; a
        generator must live there.  ``weight_quant="int8"`` is refused: int8
        weights are wired through the paged serving path only."""
        return _init_float(self, generator_or_seed, device, dtype,
                           weight_quant, "as an aligned batch")

    def supports_paged_decode(self) -> bool:
        """False: the Mamba state has no per-token KV cache to page."""
        return False

    def engine_refusal(self) -> Optional[str]:
        """Why the serving engine does not serve the family: it serves only
        as an aligned batch, as in the reference."""
        return Z.ALIGNED_ONLY

    def prefill(self, params, tokens, max_len: int):
        """Prompts (B, S) of one length -> (state, final hidden (B, S, d));
        the shared block's caches hold ``max_len`` rows."""
        return Z.prefill(params, self.cfg, tokens, max_len)

    def init_decode_state(self, batch: int, max_len: int, *, device=None):
        """Zeroed state (:func:`repro_torch.models.zamba.init_state`) on
        ``device`` (``cuda`` unless named)."""
        return Z.init_state(self.cfg, batch, max_len,
                            dtype=torch_dtype(self.cfg.dtype),
                            device=resolve_device(device))

    def decode_step(self, params, state, tokens, pos):
        """tokens (B, 1) at the one position ``pos`` of the whole batch ->
        float32 logits (B, 1, V); ``state`` advanced in place.  A per-row
        position vector raises ``ValueError``."""
        return Z.decode_step(params, self.cfg, state, tokens, pos)

    def lm_head(self, params, hidden):
        """Project final hidden states to float32 vocab logits."""
        return T.lm_logits(params, hidden)

    def serve_param_specs(self, ep: int = 1):
        """Refused: the family has no paged TP specs."""
        raise _no_tp_specs(self.cfg)

    def serve_state_specs(self, batch: int, max_len: int) -> dict:
        """Slot-parallel specs of the state: its slot axis over
        ``"model"`` (the engine refuses the family, as the reference's
        launcher does)."""
        del batch, max_len
        return _slot_specs(Z.state_specs(self.cfg))

    def validate_serve_mesh(self, tp: int = 1, ep: int = 1) -> None:
        """The reference's checks; ``ep > 1`` is refused."""
        _validate_mesh(self, tp, ep)


class Whisper:
    """Encoder-decoder audio model: a bidirectional frame encoder and a
    causal token decoder with cross-attention.  Serves paged only: the
    decoder's self-attention K/V page as a decoder-only LM's, and the cross
    K/V (computed once a clip by :meth:`encode_chunk` and
    :meth:`cross_kv_chunk`) live in a read-only
    :class:`repro_torch.serve.pages.CrossKVPool`; every paged call takes a
    ``cross={"storage", "tables", "frames_len"}`` bundle."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    def param_defs(self) -> dict:
        """Tree of :class:`repro_torch.models.module.Param` for every weight
        (the LayerNorms' scale and bias declared float32)."""
        return W.whisper_defs(self.cfg)

    # the decoder-only model's: random weights (the LayerNorms in float32,
    # as declared), int8 ones quantized as they are drawn
    init = DecoderLM.init

    def supports_paged_decode(self) -> bool:
        """True: the decoder's self-attention cache pages."""
        return True

    def engine_refusal(self) -> Optional[str]:
        """None: the serving engine serves the family (paged only)."""
        return None

    def _leaf(self):
        from repro_torch.serve.pages import PagedLeafSpec
        cfg = self.cfg
        return PagedLeafSpec((cfg.decoder_layers,),
                             (cfg.n_heads, cfg.head_dim),
                             torch_dtype(cfg.dtype))

    def paged_leaf_specs(self, quant=None):
        """``{"k", "v"}`` self-attention page leaves of (Ld, num_pages,
        page_size, h, hd), int8 with scale leaves under a KV ``quant``."""
        from repro_torch.serve.quant import quantize_leaf_specs
        leaf = self._leaf()
        return quantize_leaf_specs({"k": leaf, "v": leaf}, quant)

    def cross_leaf_specs(self, quant=None):
        """``{"cross_k", "cross_v"}`` leaves of the cross-KV pool: pages over
        audio-frame rows, otherwise the self pages' layout (int8 scale
        leaves ride along the same way)."""
        from repro_torch.serve.quant import quantize_leaf_specs
        leaf = self._leaf()
        return quantize_leaf_specs({"cross_k": leaf, "cross_v": leaf}, quant)

    def encode_chunk(self, params, frames, start: int, n_valid: int):
        """The encoder over ONE audio chunk (1, Cf, d) at absolute positions
        [start, start + Cf), ``n_valid`` real frames: the streaming chunked
        encode (:func:`repro_torch.models.whisper.encode_chunk`)."""
        return W.encode_chunk(params, self.cfg, frames, start, n_valid)

    def cross_kv_chunk(self, params, enc_chunk):
        """Encoder-output chunk (1, Cf, d) -> cross K/V (Ld, Cf, h, hd)."""
        return W.cross_kv_chunk(params, self.cfg, enc_chunk)

    def scatter_cross(self, storage, pages, k, v, *, page_size: int,
                      quant=None) -> None:
        """Write one chunk's cross K/V into its pages, in place (quantized
        on write under a KV ``quant`` policy)."""
        W.scatter_cross(storage, pages, k, v, page_size=page_size,
                        quant=quant)

    def paged_prefill_chunk(self, params, storage, table_row, pages_chunk,
                            start, tokens, *, cross, quant=None):
        """A decoder-prompt chunk (1, C) into the self pages, reading the
        slot's cross pages: ``cross = {"storage", "tables" (Pc,),
        "frames_len"}``.  Returns ``(hidden (1, C, d), telemetry)``."""
        return W.paged_prefill_chunk(
            params, self.cfg, storage, table_row, pages_chunk, start, tokens,
            cross["storage"], cross["tables"], cross["frames_len"],
            quant=quant)

    def paged_decode_step(self, params, storage, tables, lengths, tokens,
                          write_pages, write_offs, *, cross, quant=None):
        """tokens (B, 1) -> ``(float32 logits (B, 1, V), telemetry)``;
        ``cross``'s tables (B, Pc) and frames_len (B,), 0 on dead slots."""
        return W.paged_decode_step(
            params, self.cfg, storage, tables, lengths, tokens, write_pages,
            write_offs, cross["storage"], cross["tables"],
            cross["frames_len"], quant=quant)

    def paged_verify(self, params, storage, tables, lengths, tokens,
                     write_pages, write_offs, *, cross, quant=None):
        """A speculative verify window (B, C) -> ``(float32 logits
        (B, C, V), telemetry)``, with the cross read of
        :meth:`paged_decode_step`."""
        return W.paged_verify_chunk(
            params, self.cfg, storage, tables, lengths, tokens, write_pages,
            write_offs, cross["storage"], cross["tables"],
            cross["frames_len"], quant=quant)

    def prefill(self, params, batch, max_len: int):
        """``batch``: ``{"frames": (B, F, d), "tokens": (B, S)}`` -> (state,
        final hidden (B, S, d)): the whole clip encoded, every layer's cross
        K/V, the decoder prompt."""
        return W.prefill(params, self.cfg, batch["frames"], batch["tokens"],
                         max_len)

    def init_decode_state(self, batch: int, max_len: int, *, device=None):
        """Zeroed self and cross K/V (:func:`repro_torch.models.whisper.
        init_state`) in the compute dtype on ``device``."""
        return W.init_state(self.cfg, batch, max_len,
                            dtype=torch_dtype(self.cfg.dtype),
                            device=resolve_device(device))

    def decode_step(self, params, state, tokens, pos):
        """tokens (B, 1) at ``pos`` -> float32 logits (B, 1, V); the self
        K/V written into ``state`` in place."""
        return W.decode_step(params, self.cfg, state, tokens, pos)

    def lm_head(self, params, hidden):
        """Project final hidden states to float32 vocab logits."""
        return T.lm_logits(params, hidden)

    # -- serving-mesh rules: whisper serves on no mesh, as in the reference

    def serve_param_specs(self, ep: int = 1):
        """Refused, as the reference's: no TP serving specs."""
        raise _no_tp_specs(self.cfg)

    def serve_state_specs(self, batch: int, max_len: int) -> dict:
        """Slot-parallel specs of the dense state: its slot axis over
        ``"model"``, the reference's rule; no serving path reaches it, as
        whisper serves on no mesh."""
        del batch, max_len
        return _slot_specs(W.state_specs(self.cfg))

    # the rules of the decoder-only model: the pages' head axis over
    # "model"; a 1-D mesh check through this class's validate_serve_mesh
    paged_storage_specs = DecoderLM.paged_storage_specs
    validate_serve_tp = DecoderLM.validate_serve_tp

    def validate_serve_mesh(self, tp: int = 1, ep: int = 1) -> None:
        """Any serving mesh is refused, with the reference's message: the
        cross-KV pool is not wired for one."""
        if tp > 1 or ep > 1:
            raise ValueError(
                f"{self.cfg.name} (audio/enc-dec) serves single-device only "
                f"in this release: mesh (tp={tp}, ep={ep}) is not wired for "
                "the cross-KV pool (see ROADMAP item 5 follow-ups) — drop "
                "--mesh")

    def validate_serve_encoder(self, *, page_size: int, max_len: int,
                               prefix_cache: bool = False) -> None:
        """Audio frames need at least one frame, and the decoder max_len >= 2
        (prompt plus one generated token).  The prefix cache never applies
        (the engine turns it off).  The reference's messages."""
        cfg = self.cfg
        if cfg.n_audio_frames < 1:
            raise ValueError(
                f"{cfg.name}: n_audio_frames={cfg.n_audio_frames} — an "
                "enc-dec request needs at least one audio frame")
        if max_len < 2:
            raise ValueError(
                f"{cfg.name}: max_len={max_len} cannot hold a decoder "
                "prompt plus one generated token; raise --max-len")


_FAMILIES = {"dense": DecoderLM, "moe": DecoderLM, "vlm": VLM,
             "ssm": RwkvLM, "hybrid": HybridLM, "audio": Whisper}


def build_model(cfg: ModelConfig):
    """The family's model class bound to ``cfg``: :class:`DecoderLM` for
    dense and MoE decoders, :class:`VLM` for llava (``vlm``),
    :class:`RwkvLM` for rwkv6 (``ssm``), :class:`HybridLM` for zamba2
    (``hybrid``), :class:`Whisper` for whisper (``audio``)."""
    return _FAMILIES[cfg.family](cfg)
