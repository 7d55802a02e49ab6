"""Quantization policies for serving: int8 KV pages and int8 weights.

Counterpart of ``repro.serve.quant``:

* :class:`Int8KVQuant` — per-(token row, KV head) symmetric int8 for the
  paged KV cache.  ``quantize`` maps a K/V block ``(..., Hkv, D)`` to int8
  codes plus a float32 scale ``(..., Hkv)``; the scale's leading axes line
  up with the block's token axes, so values and scales are written through
  the same page op, and a new token never rescales an older row.
* :func:`quantize_leaf_specs` — gives a model's ``{"k", "v"}`` page leaves
  the int8 dtype and a sibling ``*_scale`` leaf each.  The scales are
  ordinary pool leaves, so refcounts, the prefix cache, copy-on-write and
  preemption move them with their pages, and the trash page's zeroed scales
  dequantize to zeros.
* weights-only int8: :func:`quantize_params` / :func:`dequantize_params` —
  one per-tensor scale for every floating leaf of two or more axes, each
  becoming ``{"q8": int8, "s8": float32 0-dim}``.  The rule runs on the
  stacked tree, so the stacked norm scales ``(L, d)``, the QKV biases
  ``(L, H, D)`` and both embedding tables are quantized too, each with one
  scale across all layers; only ``final_norm`` ``(d,)`` stays float.  The
  model dequantizes a layer's pairs inside its layer loop (one layer's
  full-precision copy at a time) straight to its compute dtype, which
  gives the reference's numbers: the scale is per tensor, so slicing
  before or after the multiply is the same, and the reference casts each
  dequantized float32 weight to the compute dtype where it is used.
* :func:`quantize_param_specs` — the mesh layout of a quantized tree: the
  int8 payload keeps its weight's spec, the per-tensor scale is replicated.
  The engine quantizes the whole tree before it cuts the shards, so every
  shard dequantizes with its whole weight's scale and the cut commutes
  with dequantization.
"""
from __future__ import annotations

__all__ = ["Int8KVQuant", "SCALE_SUFFIX", "dequantize_params", "is_q8",
           "kv_bytes_per_token", "make_kv_quant", "quantize_leaf_specs",
           "quantize_param_specs", "quantize_params"]

import math

import torch

from repro_torch.models.module import tree_leaves
from repro_torch.optim.compress import int8_compress, int8_decompress
from repro_torch.serve.pages import PagedLeafSpec

SCALE_SUFFIX = "_scale"


class Int8KVQuant:
    """Per-(token, head) symmetric int8 for paged KV blocks: the trailing D
    axis is reduced into one float32 scale per row and head."""

    name = "int8"
    storage_dtype = torch.int8
    scale_dtype = torch.float32

    def quantize(self, block):
        """(..., Hkv, D) -> (int8 (..., Hkv, D), float32 scale (..., Hkv))."""
        return int8_compress(block, axis=-1)

    def dequantize(self, q, scale, dtype=torch.float32):
        """int8 rows and their per-row scale -> ``dtype`` values."""
        return int8_decompress(q, scale, axis=-1, dtype=dtype)


_KV_QUANTS = {"int8": Int8KVQuant}


def make_kv_quant(spec):
    """``None``/"off"/False -> None; "int8" -> :class:`Int8KVQuant`; a
    policy object (with quantize/dequantize) passes through."""
    if spec in (None, "off", False):
        return None
    if isinstance(spec, str):
        if spec not in _KV_QUANTS:
            raise ValueError(
                f"unknown kv_quant {spec!r}; known: "
                f"{sorted(_KV_QUANTS)} or 'off'")
        return _KV_QUANTS[spec]()
    if not (hasattr(spec, "quantize") and hasattr(spec, "dequantize")):
        raise ValueError(f"kv_quant policy {spec!r} lacks "
                         "quantize/dequantize")
    return spec


def quantize_leaf_specs(specs: dict, quant) -> dict:
    """A flat ``{name: PagedLeafSpec}`` KV tree in its quantized layout:
    each leaf in the policy's storage dtype plus a ``{name}_scale`` sibling
    (same prefix, suffix without its trailing axis, the scale dtype)."""
    if quant is None:
        return specs
    if not isinstance(specs, dict):
        raise TypeError(f"quantized KV needs a dict leaf tree, got "
                        f"{type(specs).__name__}")
    out = {}
    for name, leaf in specs.items():
        if not leaf.suffix:
            raise ValueError(f"KV leaf {name!r} has no trailing axis to "
                             "reduce a scale over")
        out[name] = PagedLeafSpec(leaf.prefix, leaf.suffix,
                                  quant.storage_dtype)
        out[name + SCALE_SUFFIX] = PagedLeafSpec(
            leaf.prefix, leaf.suffix[:-1], quant.scale_dtype)
    return out


def kv_bytes_per_token(leaf_specs) -> int:
    """Device bytes one cached token costs across every pool leaf, scale
    leaves included."""
    return sum(math.prod(s.prefix) * math.prod(s.suffix) * s.dtype.itemsize
               for s in tree_leaves(leaf_specs))


# ---------------------------------------------------------------------------
# Weights-only int8 (per-tensor scale, dequantized where a weight is used)
# ---------------------------------------------------------------------------

def _weight_quantizable(a) -> bool:
    return (isinstance(a, torch.Tensor) and a.ndim >= 2
            and a.is_floating_point())


def is_q8(x) -> bool:
    """Whether ``x`` is one quantized weight, ``{"q8", "s8"}``."""
    return isinstance(x, dict) and set(x) == {"q8", "s8"}


def quantize_params(params):
    """Per-tensor symmetric int8 for every floating leaf of two or more axes
    (vectors stay as they are); each becomes ``{"q8": int8, "s8": float32
    0-dim}``.  A tree already quantized comes back unchanged."""
    if isinstance(params, dict) and not is_q8(params):
        return {k: quantize_params(v) for k, v in params.items()}
    if _weight_quantizable(params):
        q, s = int8_compress(params)
        return {"q8": q, "s8": s}
    return params


def dequantize_params(params, dtype=torch.float32):
    """Inverse of :func:`quantize_params`: every ``{"q8", "s8"}`` pair as a
    ``dtype`` tensor; other leaves unchanged."""
    if is_q8(params):
        return int8_decompress(params["q8"], params["s8"], dtype=dtype)
    if isinstance(params, dict):
        return {k: dequantize_params(v, dtype) for k, v in params.items()}
    return params



def quantize_param_specs(specs, params):
    """Mirror a tree of mesh specs (tuples) onto the quantized layout of
    ``params``: a weight :func:`quantize_params` quantizes (a float leaf of
    two or more axes, or a ``{"q8", "s8"}`` pair already) becomes
    ``{"q8": its spec, "s8": ()}`` — the payload keeps the weight's spec,
    the 0-dim scale is replicated; every other leaf keeps its spec."""
    if is_q8(params):
        return {"q8": specs, "s8": ()}
    if isinstance(params, dict):
        return {k: quantize_param_specs(specs[k], params[k]) for k in params}
    if _weight_quantizable(params):
        return {"q8": specs, "s8": ()}
    return specs
