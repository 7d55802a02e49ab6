"""Speculative multi-token decode: pluggable drafter functions (the
counterpart of ``repro.serve.spec``).

A *drafter* is a function ``propose(tokens, k)`` that guesses the next
``k`` tokens of a stream; the engine's verify tick scores every guess in
one batched forward through the target model
(:meth:`repro_torch.models.api.DecoderLM.paged_verify`) and accepts the
longest prefix the target agrees with.  The engine never looks inside a
drafter.  Two weight-free drafters ship here:

* :class:`NgramDrafter` — prompt-lookup decoding on the host (numpy).
* :class:`TruncatedSelfDrafter` — the target's first ``layers`` blocks
  with its embedding, final norm and lm head, run greedily as a causal
  forward over the bucketed stream: on a card, the flash-attention and
  RMSNorm kernels.

Drafts are proposals: a wrong draft is rejected by the verify rule, and a
drafter that raises costs its slot the drafts of that tick — unless it is
the :class:`TruncatedSelfDrafter`, whose every exception the engine
re-raises (its kernels' wrappers refuse input with ``ValueError`` or
``TypeError``, a failed build or launch raises
:class:`repro_torch.kernels.build.KernelError`, an asynchronous CUDA fault
surfaces as ``RuntimeError``), or what raised is a ``KernelError`` from
any drafter: a kernel fault inside a drafter never reads as "no drafts".
"""

from __future__ import annotations

__all__ = ["Drafter", "NgramDrafter", "TruncatedSelfDrafter",
           "make_drafter"]

from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.serve.sampling import greedy


@runtime_checkable
class Drafter(Protocol):
    """The pluggable proposer contract — one function.

    ``propose(tokens, k)``: ``tokens`` is the request's full visible stream
    (prompt + every generated token, the last element being the token whose
    successor is wanted) as ``(n,) int32``; return up to ``k`` proposed
    continuation tokens as ``(m,) int32`` (``m <= k``; empty means "no
    guess").  Must be deterministic in ``tokens``.
    """

    def propose(self, tokens: np.ndarray, k: int) -> np.ndarray:
        """Up to ``k`` draft tokens continuing ``tokens`` (may be empty)."""
        ...


class NgramDrafter:
    """Prompt-lookup decoding (n-gram matching against the own stream).

    Find the most recent earlier occurrence of the stream's final n-gram
    (longest ``max_n`` first, down to ``min_n``) and propose the tokens
    that followed it.  Pure host-side numpy — zero device work.
    """

    def __init__(self, max_n: int = 3, min_n: int = 1):
        assert 1 <= min_n <= max_n
        self.max_n, self.min_n = max_n, min_n

    def propose(self, tokens: np.ndarray, k: int) -> np.ndarray:
        """Tokens that followed the stream's own last n-gram, up to ``k``."""
        t = np.ascontiguousarray(tokens, np.int32)
        best = np.zeros(0, np.int32)
        if k <= 0:
            return best
        for n in range(min(self.max_n, len(t) - 1), self.min_n - 1, -1):
            tail = t[-n:]
            # windows[j] = t[j:j+n]; candidate matches must have a
            # continuation (j + n < len(t)) and not be the tail itself
            win = np.lib.stride_tricks.sliding_window_view(t[:-1], n)
            hits = np.nonzero((win == tail).all(axis=1))[0]
            if not hits.size:
                continue
            # prefer the most recent occurrence with a FULL k-token
            # continuation: in a loop of period p the very last match sits
            # p tokens from the end and could only propose p tokens — one
            # period earlier proposes the whole window
            full = hits[hits + n + k <= len(t)]
            if full.size:
                j = int(full[-1])
                return t[j + n:j + n + k].copy()
            j = int(hits[-1])
            if len(t) - (j + n) > len(best):
                best = t[j + n:].copy()
        return best


def _bucket(n: int, buckets=(16, 32, 64, 128, 256, 512, 1024, 2048)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return ((n + 2047) // 2048) * 2048


class TruncatedSelfDrafter:
    """Draft with the first ``layers`` blocks of the target model itself:
    shared token embedding, blocks ``0..layers-1`` (views of the target's
    stacked weights, no copy), the final norm and the shared lm head.
    Proposals are greedy and autoregressive: each draft token re-runs the
    truncated forward over the stream right-padded to a length bucket (16
    to 2048), on the device the weights lie on.  Under a serving mesh
    ``params`` are the rank's shards and ``comm`` / ``ep_comm`` the mesh's
    transports, which the truncated forward and lm head take as the
    target's paged calls do."""

    def __init__(self, model, params, *, layers: int = 2, comm=None,
                 ep_comm=None):
        cfg = model.cfg
        if not model.supports_paged_decode():
            raise ValueError(
                f"{cfg.name} ({cfg.family}) has no stacked decoder blocks "
                "to truncate; use the ngram drafter")
        k = max(1, min(layers, cfg.n_layers))
        self.layers = k
        self.model = type(model)(cfg.replace(n_layers=k))
        self.vocab = cfg.vocab
        self.params = {
            "embed": params["embed"],
            "blocks": tree_map(lambda a: a[:k], params["blocks"]),
            "final_norm": params["final_norm"],
            "unembed": params["unembed"],
        }
        self.device = tree_leaves(params)[0].device
        self.comm, self.ep_comm = comm, ep_comm

    def _next_logits(self, toks: torch.Tensor, n_valid: int):
        hidden = self.model.forward(self.params, toks, comm=self.comm,
                                    ep_comm=self.ep_comm)
        return self.model.lm_head(self.params,
                                  hidden[:, n_valid - 1:n_valid], self.comm)

    def propose(self, tokens: np.ndarray, k: int) -> np.ndarray:
        """Greedy rollout of the truncated model, one token at a time."""
        t = list(np.asarray(tokens, np.int32))
        out = []
        for _ in range(max(0, k)):
            n = len(t)
            buf = np.zeros((1, _bucket(n)), np.int32)
            buf[0, :n] = t
            logits = self._next_logits(torch.tensor(buf, device=self.device),
                                       n)
            nxt = int(greedy(logits, true_vocab=self.vocab)[0, 0])
            out.append(nxt)
            t.append(nxt)
        return np.asarray(out, np.int32)


def make_drafter(name: str, model=None, params=None, comm=None,
                 ep_comm=None) -> Drafter:
    """Resolve a CLI-style drafter name.

    ``"ngram"`` (or ``"ngram-N"`` for a max n-gram of N) needs no model;
    ``"self-K"`` (or ``"self"``, K defaulting to 2) truncates the target to
    its first K layers and needs ``model`` + ``params`` (under a mesh the
    rank's shards, with the mesh's ``comm`` / ``ep_comm``).
    """
    base, _, arg = name.partition("-")
    if base == "ngram":
        return NgramDrafter(max_n=int(arg) if arg else 3)
    if base == "self":
        if model is None or params is None:
            raise ValueError("the self-K drafter needs model= and params=")
        return TruncatedSelfDrafter(model, params,
                                    layers=int(arg) if arg else 2,
                                    comm=comm, ep_comm=ep_comm)
    raise ValueError(f"unknown drafter {name!r} (want ngram[-N] or self[-K])")
