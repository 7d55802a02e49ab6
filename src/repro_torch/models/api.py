"""Model API of the port: :class:`DecoderLM` and :func:`build_model`.

Counterpart of ``repro.models.api`` for the dense decoders' serving paths:
paged (chunked prefill and decode against a page pool) and dense per-slot
(whole-prompt prefill and decode against a per-slot cache).  The members
are plain functions over dict-of-tensor params, which is all the serving
engine calls.
"""
from __future__ import annotations

__all__ = ["DecoderLM", "build_model"]

from typing import Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.module import (init_params, resolve_device,
                                       torch_dtype)


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
        if isinstance(generator_or_seed, torch.Generator):
            gen = generator_or_seed
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(generator_or_seed))
        dt = torch_dtype(self.cfg.dtype) if dtype is None else dtype
        if weight_quant not in (None, "off", "int8"):
            raise ValueError(f"unknown weight_quant {weight_quant!r}; want "
                             "'int8' or 'off'")
        finish = quantize_params if weight_quant == "int8" else None
        return init_params(self.param_defs(), gen, device=dev, dtype=dt,
                           finish=finish)

    def supports_paged_decode(self) -> bool:
        """Whether the family has a per-token KV cache that can page."""
        return not T.uses_window_cache(self.cfg)

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


def build_model(cfg: ModelConfig) -> DecoderLM:
    """The :class:`DecoderLM` bound to ``cfg`` (dense family only)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet (dense only)")
    return DecoderLM(cfg)
