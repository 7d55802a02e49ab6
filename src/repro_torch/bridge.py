"""Weight bridge: the reference package's params as the port's tensors.

The input is the reference model's param tree with every leaf converted to
numpy (``jax.tree.map(np.asarray, model.init(key))``), so this module needs
no JAX.  Keys and shapes stay as they are — ``blocks`` stacked on the
leading layer axis — and every leaf is cast to one dtype on one device,
which is the one cast the reference instead makes at every call.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.module import resolve_device, torch_dtype, tree_map


def params_from_numpy(tree, *, device=None, dtype=torch.float32) -> dict:
    """Nested dict of numpy arrays -> the same tree of tensors in ``dtype``
    on ``device`` (``cuda`` unless named)."""
    dev = resolve_device(device)
    dt = torch_dtype(dtype)

    def leaf(a):
        # through float32: exact for the reference's float32 and bf16 leaves
        return torch.tensor(np.asarray(a, np.float32)).to(device=dev,
                                                          dtype=dt)

    return tree_map(leaf, tree)
