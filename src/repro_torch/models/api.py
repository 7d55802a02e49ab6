"""Model API of the port: :class:`DecoderLM`, :class:`RwkvLM`,
:class:`HybridLM` and :func:`build_model`.

Counterpart of ``repro.models.api`` for the serving paths ported so far:
the dense decoders paged (chunked prefill, decode and speculative verify
windows against a page pool, and a cache-free scoring forward)
and dense per-slot (whole-prompt prefill and decode against a per-slot
cache), rwkv6 on the dense per-slot path (a recurrent state per slot), and
zamba2 as an aligned batch (prefill, then decode at one position for every
row).  The members are plain functions over dict-of-tensor params, which
is all the serving engine calls.
"""
from __future__ import annotations

__all__ = ["DecoderLM", "RwkvLM", "HybridLM", "build_model"]

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rwkv_lm as RW
from repro_torch.models import transformer as T
from repro_torch.models import zamba as Z
from repro_torch.models.module import (init_params, resolve_device,
                                       torch_dtype)


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
    """Dense decoder-only transformer LM: paged prefill chunks and decode,
    whole-prompt prefill and decode on a per-slot cache, the logits head."""

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
        """None: the serving engine serves the family."""
        return None

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
                            start, tokens, *, quant=None):
        """Prefill tokens (1, C) at positions [start, start + C) into pages
        (in place, quantized on write with a KV ``quant`` policy); returns
        the final hidden states (1, C, d)."""
        return T.paged_prefill_chunk(params, self.cfg, storage, table_row,
                                     pages_chunk, start, tokens, quant=quant)

    def paged_decode_step(self, params, storage, tables, lengths, tokens,
                          write_pages, write_offs, *, quant=None):
        """tokens (B, 1) -> float32 logits (B, 1, V); K/V written in place
        (quantized on write with a KV ``quant`` policy)."""
        return T.paged_decode_step(params, self.cfg, storage, tables, lengths,
                                   tokens, write_pages, write_offs,
                                   quant=quant)

    def paged_verify(self, params, storage, tables, lengths, tokens,
                     write_pages, write_offs, *, quant=None):
        """A speculative verify window: tokens (B, C) -> float32 logits
        (B, C, V); the window's K/V written in place at (write_pages,
        write_offs) (B, C) (quantized on write with a KV ``quant``
        policy)."""
        return T.paged_verify_chunk(params, self.cfg, storage, tables,
                                    lengths, tokens, write_pages, write_offs,
                                    quant=quant)

    def forward(self, params, tokens):
        """Scoring forward without a cache: tokens (B, S) -> final hidden
        states (B, S, d) (the self-drafter runs it on a truncated
        model)."""
        return T.forward(params, self.cfg, tokens)

    def prefill(self, params, tokens, max_len: Optional[int] = None):
        """Whole prompts (B, S) -> (cache, final hidden (B, S, d)); the
        cache's sequence axis is ``max_len`` (S unless named)."""
        return T.prefill(params, self.cfg, tokens, max_len)

    def init_decode_state(self, batch: int, max_len: int, *, device=None):
        """Zeroed per-slot cache ``{"k", "v"}`` of (L, batch, max_len, Hkv, D)
        in the compute dtype on ``device`` (``cuda`` unless named)."""
        return T.init_cache(self.cfg, batch, max_len,
                            dtype=torch_dtype(self.cfg.dtype),
                            device=resolve_device(device))

    def decode_step(self, params, state, tokens, pos):
        """tokens (B, 1) at positions ``pos`` ((B,) or an int) -> float32
        logits (B, 1, V); the K/V are written into ``state`` in place."""
        return T.decode_step(params, self.cfg, state, tokens, pos)

    def lm_head(self, params, hidden):
        """Project final hidden states to float32 vocab logits (an int8
        unembedding dequantized to the hidden states' dtype first)."""
        return T.lm_logits(params, hidden)


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


_FAMILIES = {"dense": DecoderLM, "ssm": RwkvLM, "hybrid": HybridLM}
# families of the reference still to port, and the ROADMAP item they wait for
_NOT_PORTED = {"moe": "MoE (ROADMAP A9)",
               "vlm": "multimodal (ROADMAP A10)",
               "audio": "multimodal (ROADMAP A10)"}


def build_model(cfg: ModelConfig):
    """The family's model class bound to ``cfg``: :class:`DecoderLM` for
    dense decoders, :class:`RwkvLM` for rwkv6 (``ssm``), :class:`HybridLM`
    for zamba2 (``hybrid``)."""
    if cfg.family not in _FAMILIES:
        slice_name = _NOT_PORTED.get(cfg.family, "an unplanned")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet: it comes "
            f"with the {slice_name} slice")
    return _FAMILIES[cfg.family](cfg)
