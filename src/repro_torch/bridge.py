"""Weight bridge: the reference package's params as the port's tensors.

The input is the reference model's param tree with every leaf converted to
numpy (``jax.tree.map(np.asarray, model.init(key))``), so this module needs
no JAX.  Keys and shapes stay as they are — ``blocks`` stacked on the
leading layer axis — and every leaf is cast to one dtype on one device,
which is the one cast the reference instead makes at every call.  Given
the model's declaration tree (``defs``), a leaf declared with its own
dtype keeps that dtype instead: the reference reads such a leaf in
float32 whatever the compute dtype (rwkv6's norms, ``u``, ``decay_base``
and ``w_o``; each zamba2 Mamba layer's ``A_log``, ``D``, ``dt_bias`` and
conv weights, stacked two deep as ``(segments, layers, ...)``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.module import resolve_device, torch_dtype


def params_from_numpy(tree, *, device=None, dtype=torch.float32,
                      defs: Optional[dict] = None) -> dict:
    """Nested dict of numpy arrays -> the same tree of tensors in ``dtype``
    on ``device`` (``cuda`` unless named); with ``defs`` (the model's
    ``param_defs()``), a leaf whose :class:`Param` names a dtype is cast to
    that one."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)

    def convert(a, p):
        if isinstance(a, dict):
            return {k: convert(v, None if p is None else p[k])
                    for k, v in a.items()}
        # through float32: exact for the reference's float32 and bf16 leaves
        leaf_dt = getattr(p, "dtype", None) or dt
        return torch.tensor(np.asarray(a, np.float32)).to(device=dev,
                                                          dtype=leaf_dt)

    return convert(tree, defs)
