"""Parameter declarations and seeded initialization for the port.

Models declare parameters as nested dicts of :class:`Param` (shape plus
initializer), the same trees as the reference's ``repro.models.module``
without the logical partition specs: the port serves on one card, so there
is nothing to shard.  :func:`init_params` materializes a declaration tree
into tensors on one device, each leaf in the model's dtype unless its
declaration names its own (the reference's ``dtype`` override: a leaf the
model always reads in float32 is kept in float32).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Param:
    """Declaration of one parameter tensor."""

    shape: tuple
    init: str = "normal"          # normal | zeros | ones | small
    dtype: Optional[torch.dtype] = None   # overrides the model's dtype

    def stddev(self) -> float:
        """The normal initializer's standard deviation (1/sqrt(fan_in))."""
        fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]
        return 1.0 / math.sqrt(max(fan_in, 1))


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a nested dict, keeping its keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in key-insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when ``cuda`` is asked for (or implied) and no card is
    visible, so a missing card never turns into a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the port "
            "on the CPU")
    return dev


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` / ``"float32"`` (a config's dtype field) -> torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    return getattr(torch, str(name))


_WHOLE_DRAW = 1 << 32      # elements of the largest leaf drawn in one piece
_PIECE = 1 << 28           # ... and the pieces of a larger one


def init_params(defs, generator: torch.Generator, *, device: torch.device,
                dtype: torch.dtype, finish: Callable | None = None):
    """Materialize a declaration tree on ``device``.

    Each leaf is drawn in float32 from ``generator`` (which must live on
    ``device``) and cast to ``dtype`` (or to its declared dtype) before the
    next is drawn, so a full-width model
    never holds a float32 copy of more than one leaf.  A leaf of more than
    ``2**32`` elements (a stack of a full-width MoE model's experts) is
    drawn and cast ``2**28`` elements at a time instead, so its float32
    draw never exists whole either; its values are then not those of one
    draw.  ``finish``, if given, maps each cast leaf to what the tree keeps
    (the int8 weight quantizer), before the next leaf is drawn."""
    def make(p: Param):
        dt = p.dtype or dtype
        if p.init == "zeros":
            w = torch.zeros(p.shape, dtype=dt, device=device)
        elif p.init == "ones":
            w = torch.ones(p.shape, dtype=dt, device=device)
        else:
            std = 0.02 if p.init == "small" else p.stddev()
            n = math.prod(p.shape)
            if n <= _WHOLE_DRAW:
                w = torch.randn(p.shape, generator=generator,
                                dtype=torch.float32, device=device)
                w = w.mul_(std).to(dt)
            else:
                w = torch.empty(p.shape, dtype=dt, device=device)
                flat = w.view(-1)
                for i in range(0, n, _PIECE):
                    m = min(_PIECE, n - i)
                    flat[i:i + m] = torch.randn(
                        m, generator=generator, dtype=torch.float32,
                        device=device).mul_(std)
        return w if finish is None else finish(w)

    return tree_map(make, defs)
