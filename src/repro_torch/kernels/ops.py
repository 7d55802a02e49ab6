"""Public wrappers of the port's kernels, with launch counters.

A wrapper picks its route from where its input lies: a CUDA tensor goes to
the hand-written kernel (a build or launch failure raises; there is no
fallback), a CPU tensor to the kernel's plain PyTorch version.  Each
wrapper counts kernel launches and plain calls in :data:`COUNTS`, so a run
can show which route its main path took; :func:`reset_counts` zeroes them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rmsnorm as _rn


@dataclasses.dataclass
class LaunchCount:
    """Calls of one wrapper: kernel launches and plain-version calls."""
    kernel: int = 0
    plain: int = 0


COUNTS = {"rmsnorm": LaunchCount(), "paged_attention_mq": LaunchCount()}


def reset_counts() -> None:
    """Zero every wrapper's counters."""
    for c in COUNTS.values():
        c.kernel = c.plain = 0


def _route(x, name: str) -> bool:
    """True for the kernel route (x on a card), False for the plain one."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{name}: no route for a tensor on {x.device}")
    return False


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x`` with a ``(d,)`` scale."""
    if _route(x, "rmsnorm"):
        out = _rn.rmsnorm_cuda(x, scale, eps=eps)
        COUNTS["rmsnorm"].kernel += 1
        return out
    COUNTS["rmsnorm"].plain += 1
    return _rn.rmsnorm_plain(x, scale, eps=eps)


def paged_attention_mq(q, k_pages, v_pages, tables, lengths):
    """Paged multi-query attention, (B, W, Hq, D) -> (B, W, Hq, D); see
    :mod:`repro_torch.kernels.paged_attention`."""
    if _route(q, "paged_attention_mq"):
        out = _pa.paged_attention_mq_cuda(q, k_pages, v_pages, tables, lengths)
        COUNTS["paged_attention_mq"].kernel += 1
        return out
    COUNTS["paged_attention_mq"].plain += 1
    return _pa.paged_attention_mq_plain(q, k_pages, v_pages, tables, lengths)
