"""Greedy token selection, vocab-padding aware (counterpart of the greedy
head of ``repro.serve.sampling``; seeded sampling comes with a later port
slice)."""

from __future__ import annotations

__all__ = ["greedy"]

import torch


def _mask_pad(logits, true_vocab):
    if true_vocab is not None and true_vocab < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= true_vocab
        logits = torch.where(pad, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=logits.device), logits)
    return logits


def greedy(logits, *, true_vocab=None):
    """logits (..., V) -> (...,) int32 argmax (first index on ties); the
    padded vocab tail past ``true_vocab`` never wins."""
    return torch.argmax(_mask_pad(logits, true_vocab), dim=-1).to(torch.int32)
