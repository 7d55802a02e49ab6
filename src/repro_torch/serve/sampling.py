"""Token sampling heads (vocab-padding aware) and the speculative-decode
acceptance rules: the counterpart of ``repro.serve.sampling``.

The draws come from :mod:`repro_torch.serve.prng` (the reference's
``jax.random``) on the logits' device: a draw over a full vocabulary is one
threefry lane a token, on the card when the logits are there.  The
acceptance rules run on the host, per slot, as in the reference.
"""

from __future__ import annotations

__all__ = ["greedy", "sample_temperature", "sample_top_k",
           "sample_top_p", "spec_rejection_sample", "spec_verify_greedy"]

import numpy as np
import torch

from repro_torch.serve import prng


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


def _top_k(logits, k: int):
    """The ``k`` largest values in descending order and their indices, ties
    to the lower index (``jax.lax.top_k``'s order)."""
    _, idx = torch.topk(logits, k, dim=-1)
    idx, _ = torch.sort(idx, dim=-1)
    vals = torch.gather(logits, -1, idx)
    vals, order = torch.sort(vals, dim=-1, descending=True, stable=True)
    return vals, torch.gather(idx, -1, order)


def sample_top_k(key, logits, *, k: int = 40, temperature: float = 1.0,
                 true_vocab=None):
    """Sample from the ``k`` highest logits at ``temperature`` (greedy
    when temperature <= 0); pad-vocab rows are masked out first."""
    logits = _mask_pad(logits, true_vocab).to(torch.float32)
    if temperature <= 0:
        return greedy(logits)
    top_v, top_i = _top_k(logits, k)
    gs = prng.categorical(key, top_v / temperature)
    return torch.gather(top_i, -1, gs[..., None])[..., 0].to(torch.int32)


def sample_temperature(key, logits, *, temperature: float = 1.0,
                       true_vocab=None):
    """Plain categorical sampling at a temperature (0 -> greedy)."""
    logits = _mask_pad(logits, true_vocab).to(torch.float32)
    if temperature <= 0:
        return greedy(logits)
    return prng.categorical(key, logits / temperature).to(torch.int32)


# ---------------------------------------------------------------------------
# Speculative decode: acceptance rules
#
# ``logits[i]`` is the target model's distribution for the token FOLLOWING
# verify position i (position 0 = the slot's next input token, positions
# 1..n = the drafts), as produced by one batched verify forward.  Both rules
# return ``(accepted, emitted)``: how many drafts the target agreed with and
# the tokens to emit — the accepted drafts plus exactly one more (the
# correction on the first rejection, or the bonus token when every draft
# survived).
# ---------------------------------------------------------------------------


def spec_verify_greedy(row_argmax, draft) -> tuple[int, list[int]]:
    """Greedy acceptance: draft i survives iff it IS the target argmax at
    its position, so the emitted tokens are exactly the prefix sequential
    greedy decode would have produced.

    ``row_argmax``: (C,) per-position argmax of the target verify logits
    (pad-vocab already masked); ``draft``: (n,) proposed tokens, n < C.
    """
    emitted: list[int] = []
    for i, d in enumerate(draft):
        t = int(row_argmax[i])
        emitted.append(t)                  # == d when accepted
        if t != int(d):
            return i, emitted              # correction token, stop
    emitted.append(int(row_argmax[len(draft)]))     # bonus token
    return len(draft), emitted


def spec_rejection_sample(keys, logits, draft, *, temperature: float = 1.0,
                          true_vocab=None) -> tuple[int, list[int]]:
    """Speculative rejection sampling against a deterministic drafter
    (draft distribution one-hot at the proposed token).

    Draft ``d`` at position ``i`` is accepted with probability ``p_i(d)``;
    on rejection the correction is drawn from ``p`` with ``d`` zeroed and
    renormalized, so every emitted token's marginal is exactly
    ``softmax(logits / temperature)``.

    ``keys``: one key per verify position; ``logits``: (C, V) target
    logits on the host (numpy or a CPU tensor); ``draft``: (n,) tokens,
    n < C.  ``temperature <= 0`` degenerates to the greedy rule.  The
    probabilities are float64 numpy, the draws float32 on the CPU, as in
    the reference.
    """
    logits = np.asarray(logits, np.float32)
    v = logits.shape[-1]
    pad = true_vocab is not None and true_vocab < v
    if temperature <= 0:
        masked = logits.copy()
        if pad:
            masked[..., true_vocab:] = -1e30
        return spec_verify_greedy(masked.argmax(-1), draft)

    def probs(i):
        row = logits[i].astype(np.float64) / temperature
        if pad:
            row[true_vocab:] = -np.inf
        row -= row.max()
        e = np.exp(row)
        return e / e.sum()

    def draw(key, p):
        # the reference's jnp.asarray(p) is float32: round, then add and log
        lp = torch.log(torch.from_numpy(p).to(torch.float32) + 1e-30)
        return int(prng.categorical(key, lp))

    emitted: list[int] = []
    for i, d in enumerate(draft):
        d = int(d)
        p = probs(i)
        if float(prng.uniform(keys[i])) < p[d]:
            emitted.append(d)
            continue
        residual = p.copy()
        residual[d] = 0.0
        residual = residual / max(residual.sum(), 1e-30)
        emitted.append(draw(prng.fold_in(keys[i], 1), residual))
        return i, emitted
    n = len(draft)
    emitted.append(draw(keys[n], probs(n)))
    return n, emitted


def sample_top_p(key, logits, *, p: float = 0.9, temperature: float = 1.0,
                 true_vocab=None):
    """Nucleus sampling: keep the smallest prefix of the sorted distribution
    whose mass reaches ``p`` (the top token always survives), renormalize,
    sample.  0 temperature -> greedy."""
    logits = _mask_pad(logits, true_vocab).to(torch.float32)
    if temperature <= 0:
        return greedy(logits)
    scaled = logits / temperature
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.gather(scaled, -1, order)
    probs = torch.softmax(sorted_logits, dim=-1)
    # cumulative mass *before* each token: token i survives iff the nucleus
    # isn't already full without it — keeps the top token unconditionally
    before = torch.cumsum(probs, dim=-1) - probs
    sorted_logits = torch.where(before < p, sorted_logits,
                                torch.tensor(-1e30, device=logits.device))
    gs = prng.categorical(key, sorted_logits)
    return torch.gather(order, -1, gs[..., None])[..., 0].to(torch.int32)
