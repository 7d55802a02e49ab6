"""Production meshes, and the card's constants for the roofline.

Functions, so that importing this module starts no process group.  Each
builds a :class:`repro_torch.core.comm.Mesh` over the ranks of the world
it runs in (a ``run_ranks`` world: one card a rank with NCCL, one process
a rank with gloo on the CPU), so it needs as many ranks as its shape:

* single pod: (16, 16) = 256 ranks, axes ("data", "model");
* multi-pod: (2, 16, 16) = 512 ranks, axes ("pod", "data", "model");
* debug: (4, 2) = 8 ranks, axes ("data", "model").

The "pod" axis is pure data parallelism (batch rows over ("pod",
"data")); the compressed-gradient path (:mod:`repro_torch.train.pod_dp`)
targets it because the links between pods are the slow tier.
"""
from __future__ import annotations

from repro_torch.core.comm import make_mesh


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_debug_mesh(n_data: int = 4, n_model: int = 2):
    """A small mesh for multi-rank CPU tests (and ``(1, 1)`` on one card)."""
    return make_mesh((n_data, n_model), ("data", "model"))


# NVIDIA H100 SXM data sheet (per card): the roofline's constants
PEAK_FLOPS = 989e12          # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 900e9            # NVLink 4 bytes/s, both directions together
