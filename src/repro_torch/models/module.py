"""Parameter declarations and seeded initialization for the port.

Models declare parameters as nested dicts of :class:`Param` (shape,
logical axis names and initializer), the same trees as the reference's
``repro.models.module``.  :func:`init_params` materializes a declaration
tree into tensors on one device, each leaf in the model's dtype unless its
declaration names its own (the reference's ``dtype`` override: a leaf the
model always reads in float32 is kept in float32).

The logical axes (``"q_heads"``, ``"mlp"``, ``"vocab"``, ...) are the
reference's, leaf for leaf.  A serving mesh maps them onto its axes through
a table (:func:`mesh_spec`), and :func:`shard_leaf` cuts a rank's shard of
a tensor from the mapped spec: the serving engine's tensor- and
expert-parallel layout (``repro_torch.models.api.SERVE_TP_AXES``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Param:
    """Declaration of one parameter tensor: its shape, the logical name of
    each axis (None: an axis no mesh splits; ``spec=None``: none is named)
    and its initializer."""

    shape: tuple
    spec: Optional[tuple] = None  # logical axis names, one an axis
    init: str = "normal"          # normal | zeros | ones | small
    dtype: Optional[torch.dtype] = None   # overrides the model's dtype

    def __post_init__(self):
        if self.spec is not None and len(self.spec) != len(self.shape):
            raise ValueError(f"spec {self.spec} does not name the "
                             f"{len(self.shape)} axes of {self.shape}")

    def logical_axes(self) -> tuple:
        """The logical name of every axis (None where none is named)."""
        return tuple(self.spec) if self.spec is not None \
            else (None,) * len(self.shape)

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


def mesh_spec(logical: tuple, table: dict) -> tuple:
    """Logical axis names -> the mesh axes each tensor axis is split over
    (None: not split), through ``table`` (logical name -> a mesh axis, or
    a tuple of them, major first); names the table lacks are not split."""
    return tuple(table.get(ax) if ax is not None else None for ax in logical)


def shard_leaf(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's shard of ``x`` under the mesh spec ``spec`` (one entry an
    axis of ``x``: None, a mesh axis name, or a tuple of names, major
    first; :meth:`repro_torch.core.comm.Mesh.index`).  A tensor no axis of
    which is split on more than one rank is returned itself; otherwise the
    shard is copied out on its own (``clone``), so the whole tensor can be
    let go and no second whole copy is kept."""
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} names more axes than {tuple(x.shape)}")
    out = x
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        idx, n = mesh.index(axes)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"axis {dim} of {tuple(x.shape)} does not "
                             f"split over {n} ranks ({axes})")
        size = x.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return x if out is x else out.clone()


def shard_params(params, specs, mesh):
    """:func:`shard_leaf` over a tree: ``specs`` mirrors ``params`` (a
    quantized weight's ``{"q8", "s8"}`` pair with its own pair of specs)."""
    if isinstance(params, dict):
        return {k: shard_params(v, specs[k], mesh) for k, v in params.items()}
    return shard_leaf(params, specs, mesh)


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
