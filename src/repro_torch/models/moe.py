"""Mixture-of-Experts block: sort-based dispatch into capacity-bounded
expert buffers, the expert GEMMs, and a combine in a fixed order.

Counterpart of ``repro.models.moe`` on one card, and over a
:class:`repro_torch.core.comm.Comm` for expert parallelism.  The block is
the paper's §3.2 load balancing applied to tokens: the capacity factor is
``find_optimal_workload``'s balanced target, and the ``all_to_all`` that
hands each rank its experts' rows is ``redistribute_work``.  With
:class:`repro_torch.core.comm.SerialComm` the same code is the serial block.

The reference's ``jnp`` steps map one for one, with two changes that keep
the block deterministic on a card:

* the sort of the assignments by expert is ``torch.argsort(stable=True)``
  (``jnp.argsort`` is stable), and each assignment's rank within its expert
  is its sorted position less the expert's first position, the integers of
  the reference's one-hot cumsum;
* the combine, ``y.at[sorted_tok].add(contrib)`` in the reference, would be
  an ``index_add_`` here, whose CUDA form adds a token's ``top_k``
  contributions in whatever order its atomics land.  Instead each token's
  contributions are gathered in sorted (expert) order, the order the
  reference's scatter adds them in, and summed one after another from zero.

Dropped assignments (past an expert's capacity, or to an evicted expert)
are written to a spare row ``E * C`` of the dispatch buffer that is thrown
away; many writes to it race harmlessly.  No step reads a count back to the
host, so a decode step can be captured in a CUDA graph.

The expert GEMMs are batched products (``torch.bmm``) outside any kernel of
the reference's, as its ``jnp.einsum`` is; the router runs in float32.

Serving tensor parallelism (``shard_comm``, the engine's ``"model"`` axis)
keeps the activations, the routing, the capacity rule and the combine
replicated and splits only the expert GEMMs: each rank computes its own
experts' rows of the replicated dispatch buffer and one tiled
``all_gather`` restores the buffer in expert order, so every expert's rows
meet the same weights as in the serial block, on one rank, and the block
is bit for bit the serial one.  ``tp_comm`` (expert TP: the expert ff
axis split, the down projection's partial sums all-reduced in float32) is
the reference's training layout; the reference's ``rules`` /
``shard_map`` training path comes with ROADMAP A13b.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.comm import SerialComm
from repro_torch.models.module import Param

# placement split fractions are q8 fixed-point: a dispatch map entry of
# ``split_q`` sends the first ``split_q * C // PLACE_Q`` capacity positions
# of an expert to its first physical slot and the rest to its second
PLACE_Q = 256


def moe_def(cfg) -> dict:
    """Declaration of one MoE block: the router (d, E), the expert stacks
    gate/up (E, d, eff) and down (E, eff, d)."""
    d, E, eff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    return {
        "router": Param((d, E), ("embed", None), init="small"),
        "gate": Param((E, d, eff), ("experts", "expert_embed", "expert_mlp")),
        "up": Param((E, d, eff), ("experts", "expert_embed", "expert_mlp")),
        "down": Param((E, eff, d), ("experts", "expert_mlp", "expert_embed")),
    }


def capacity(tokens_local: int, top_k: int, n_experts: int, cf: float) -> int:
    """Per-expert slot budget: the balanced split of the assignments scaled
    by the capacity factor ``cf``, rounded up to a multiple of 4, at least
    4.  ``cf < 1`` under-provisions on purpose (the assignments past the
    budget are dropped and counted); ``top_k > n_experts`` can never route
    and is refused."""
    if top_k > n_experts:
        raise ValueError(
            f"top_k={top_k} > n_experts={n_experts}: every token would need "
            "more distinct experts than exist")
    c = math.ceil(tokens_local * top_k / n_experts * cf)
    return max(4, ((c + 3) // 4) * 4)


def identity_placement(n_experts: int) -> np.ndarray:
    """The (3, E) int32 dispatch map of the unplaced layout (expert e in
    physical slot e, no replicas): rows [slot_a, slot_b, split_q]."""
    e = np.arange(n_experts, dtype=np.int32)
    return np.stack([e, e, np.zeros(n_experts, np.int32)])


def empty_expert_stats(n_experts: int, device=None) -> dict:
    """Zero per-expert telemetry ``{"tokens", "dropped"}`` (int32)."""
    z = torch.zeros(n_experts, dtype=torch.int32, device=device)
    return {"tokens": z, "dropped": z.clone()}


def _dispatch_compute_combine(x2d, wr, wg, wu, wd, cfg, comm, tp_comm=None,
                              shard_comm=None, placement=None):
    """The routed computation on one rank.  x2d: (T, d), replicated on every
    rank of ``comm``; ``wg``/``wu``/``wd``: this rank's E/ep experts (with
    ``shard_comm``, its E/(ep*tp)).

    ``tp_comm``: expert TP — the expert ff axis of ``wg``/``wu``/``wd`` is
    split over this axis, and the down projection's partial sums are
    all-reduced over it in float32.

    ``shard_comm``: serving TP — the activations are replicated over this
    axis too and the expert stacks are split over it; each rank takes its
    experts' rows of the (replicated) exchanged buffer and a tiled
    ``all_gather`` restores the buffer in expert order (module
    docstring).

    ``placement``: a (3, E) int32 tensor [slot_a, slot_b, split_q] from
    :mod:`repro_torch.serve.placement`: logical expert e's first
    ``split_q[e] * C // PLACE_Q`` capacity positions go to physical slot
    ``slot_a[e]``, the rest to ``slot_b[e]``; a slot of -1 holds no weights
    (its assignments are dropped and counted).  The expert stacks must be
    permuted to match (``apply_placement``).  None and the identity map
    give the same integer slots.

    Returns ``(y, aux, stats)``: y (T, d) in x2d's dtype, the float32
    auxiliary balancing + router z-loss, and int32 per-logical-expert
    ``{"tokens": routed assignments, "dropped": assignments lost to
    capacity or eviction}``."""
    T, d = x2d.shape
    E, k = cfg.n_experts, cfg.top_k
    ep = comm.size()
    assert E % ep == 0, (E, ep)
    C = capacity(T, k, E, cfg.capacity_factor)
    dev = x2d.device

    # --- route (float32 throughout) ------------------------------------------
    logits = x2d.float() @ wr.float()                                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)                      # (T, k)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # --- aux losses (global means over the ranks) ----------------------------
    flat_e = top_e.reshape(-1)                                       # (T*k,)
    me = probs.mean(0)
    ce_frac = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, flat_e, torch.full_like(flat_e, 1.0 / (T * k), dtype=torch.float32))
    n = max(ep, 1)
    me = comm.all_reduce_sum(me) / n
    ce_frac = comm.all_reduce_sum(ce_frac) / n
    aux = E * (me * ce_frac).sum()
    zl = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    aux = aux + cfg.router_z_weight * comm.all_reduce_sum(zl) / n

    # --- sort-based dispatch --------------------------------------------------
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = order // k
    counts = torch.zeros(E, dtype=torch.long, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    first = torch.cumsum(counts, 0) - counts                 # expert's start
    pos_in_e = torch.arange(T * k, device=dev) - first[sorted_e]
    keep = pos_in_e < C
    if placement is None:
        slot_e, pos = sorted_e, pos_in_e
    else:
        pl = placement.to(dev).long()
        sp = (pl[2][sorted_e] * C) // PLACE_Q          # per-assignment split
        use_b = pos_in_e >= sp
        slot_e = torch.where(use_b, pl[1][sorted_e], pl[0][sorted_e])
        pos = torch.where(use_b, pos_in_e - sp, pos_in_e)
        keep = keep & (slot_e >= 0)                    # evicted -> dropped
    slot = torch.where(keep, slot_e * C + pos, torch.full_like(pos, E * C))
    buf = torch.zeros(E * C + 1, d, dtype=x2d.dtype, device=dev)
    buf[slot] = x2d[sorted_tok]
    buf = buf[:-1].reshape(E, C, d)

    # --- telemetry: per-logical-expert routed / dropped assignments ----------
    routed = counts.int()
    kept = torch.zeros(E, dtype=torch.int32, device=dev).index_add_(
        0, sorted_e, keep.int())
    stats = {"tokens": routed, "dropped": routed - kept}

    # --- EP exchange: each rank gets its experts' rows from every rank -------
    buf = comm.all_to_all(buf, split_axis=0, concat_axis=1)   # (E/ep, C*ep, d)
    if shard_comm is not None:
        # serving TP: the buffer is replicated; take my experts' rows
        n_sh, e_sh = shard_comm.size(), wg.shape[0]
        assert e_sh * n_sh == E // ep, (tuple(wg.shape), n_sh, E // ep)
        buf = buf.narrow(0, shard_comm.rank() * e_sh, e_sh)

    # --- expert GEMMs ---------------------------------------------------------
    g = torch.bmm(buf, wg.to(buf.dtype))
    u = torch.bmm(buf, wu.to(buf.dtype))
    h = F.silu(g) * u
    out = torch.bmm(h, wd.to(h.dtype))
    if tp_comm is not None:
        # expert TP: the ff axis is split; sum the down projection's parts
        out = tp_comm.all_reduce_sum(out.float()).to(out.dtype)
    if shard_comm is not None:
        # rank order is expert order: the gather is the serial layout
        out = shard_comm.all_gather(out, axis=0, tiled=True)  # (E/ep, ., d)

    # --- return + combine in sorted order ------------------------------------
    out = comm.all_to_all(out, split_axis=1, concat_axis=0)   # (E, C, d)
    out = out.reshape(E * C, d)
    gathered = torch.where(keep[:, None], out[slot.clamp(max=E * C - 1)],
                           torch.zeros((), dtype=out.dtype, device=dev))
    w_sorted = top_p.reshape(-1)[order]
    contrib = gathered * w_sorted[:, None].to(gathered.dtype)  # sorted order
    # each token's k assignments at their sorted positions, ascending: the
    # order the reference's scatter-add visits them
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * k, device=dev)
    per_tok = contrib[inv.reshape(T, k).sort(dim=1).values]   # (T, k, d)
    y = torch.zeros(T, d, dtype=x2d.dtype, device=dev)
    for j in range(k):
        y = y + per_tok[:, j]
    return y, aux, stats


def moe_apply_expert_parallel(params, x, cfg, ep_comm, shard_comm=None,
                              placement=None):
    """MoE block with the experts partitioned over ``ep_comm``'s ranks.

    Activations, and so routing, the capacity rule and the combine, are
    replicated on every rank; the (E, C, d) dispatch buffer goes through
    ``ep_comm.all_to_all`` so each rank holds the capacity rows of its own
    E/ep experts, runs their GEMMs against its expert weights (``params``'
    gate/up/down: (E/ep, ...)), and the reverse ``all_to_all`` gives every
    rank the whole combined buffer.  Each expert's rows meet the same
    weights as in the serial block, on one rank.  ``SerialComm()`` is the
    serial block.

    Composes with serving TP as a 2-D ``("expert", "model")`` mesh: pass
    the model axis's Comm as ``shard_comm``, and each rank's expert stacks
    arrive (E/(ep*tp), ...), expert-major.  Returns ``(y, aux, stats)``
    (see :func:`_dispatch_compute_combine`)."""
    y2d, aux, stats = _dispatch_compute_combine(
        x.reshape(-1, x.shape[-1]), params["router"], params["gate"],
        params["up"], params["down"], cfg, ep_comm, shard_comm=shard_comm,
        placement=placement)
    return y2d.reshape(x.shape), aux, stats


def moe_apply_serve_tp(params, x, cfg, shard_comm, placement=None):
    """The MoE block under serving TP alone: activations replicated over
    ``shard_comm``'s ranks, the expert stacks split over them (E/tp each),
    the router replicated; bit for bit the serial block.  Returns ``(y,
    aux, stats)``."""
    return moe_apply_expert_parallel(params, x, cfg, SerialComm(),
                                     shard_comm=shard_comm,
                                     placement=placement)


def moe_apply(params, x, cfg):
    """x: (B, S, d) -> (y, aux_loss), the serial block."""
    y, aux, _ = moe_apply_expert_parallel(params, x, cfg, SerialComm())
    return y, aux
