"""Load-aware expert placement: the paper's §3.2 rebalancer applied to
experts instead of host tasks.

Counterpart of ``repro.serve.placement``.  The serving engine measures
per-expert routed-token counts (the telemetry of
:func:`repro_torch.models.moe.moe_apply_expert_parallel`); this module
turns a measured window into a :class:`PlacementPlan`:

* per-rank token **targets** come from the paper's
  :func:`repro_torch.core.load_balance.find_optimal_workload` (uniform rank
  timings: the balanced ±1 split; measured per-rank seconds a token:
  targets in proportion to speed),
* experts are assigned **greedily, hottest first**, to the rank with the
  largest remaining deficit that still has a free slot (each of the ``ep``
  ranks holds exactly ``E/ep`` physical expert slots),
* **hot-expert replication**: while a rank still exceeds its target, its
  hottest expert may claim a second slot from a zero-traffic expert on the
  most underloaded rank.  The replica pair splits the expert's capacity
  positions at a q8 fixed-point fraction (``PLACE_Q``); the combine sums,
  since each capacity row is computed once whichever slot holds it.  The
  evicted zero-traffic expert keeps no weights: a token routed to it later
  is **dropped and counted**, as a capacity-factor drop is.

A plan is applied between engine ticks as a permutation of the
expert-stacked weight leaves (:func:`apply_placement`) plus a (3, E)
dispatch map that the model reads as a tensor argument.  The identity plan
gives the unplaced integer slot indices, so token streams are unchanged.
All of it is host-side numpy, line for line the reference's; the weight
permutation indexes the tensors with the plan's numpy index array.
"""

from __future__ import annotations

__all__ = ["PlacementPlan", "apply_placement", "identity_plan",
           "imbalance", "plan_placement"]

import dataclasses

import numpy as np

from repro_torch.core.load_balance import find_optimal_workload
from repro_torch.models.moe import PLACE_Q


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """Expert → physical-slot assignment for ``ep`` expert-parallel ranks.

    Physical slot ``s`` lives on rank ``s // (n_experts // ep)`` and holds
    the weights of logical expert ``phys_expert[s]``.  Logical expert ``e``
    sends its first ``split_q[e] * C // PLACE_Q`` capacity positions to
    ``slot_a[e]`` and the rest to ``slot_b[e]`` (unsplit experts have
    ``slot_a == slot_b`` and ``split_q == 0``); ``-1`` slots mean the
    expert was evicted and its tokens are dropped + counted.
    """
    n_experts: int
    ep: int
    phys_expert: np.ndarray        # (E,) occupant of each physical slot
    slot_a: np.ndarray             # (E,) per logical expert
    slot_b: np.ndarray             # (E,)
    split_q: np.ndarray            # (E,) q8 fraction routed to slot_a

    def dispatch_arrays(self) -> np.ndarray:
        """(3, E) int32 [slot_a, slot_b, split_q] for the jitted dispatch."""
        return np.stack([self.slot_a, self.slot_b,
                         self.split_q]).astype(np.int32)

    def rank_loads(self, expert_tokens) -> np.ndarray:
        """(ep,) token load per rank if ``expert_tokens`` routed under this
        plan (replica splits approximated at the q8 fraction)."""
        counts = np.asarray(expert_tokens, np.int64).reshape(-1)
        spr = self.n_experts // self.ep
        loads = np.zeros(self.ep, np.int64)
        for e in range(self.n_experts):
            a, b = int(self.slot_a[e]), int(self.slot_b[e])
            if a < 0:
                continue
            na = int(counts[e]) * int(self.split_q[e]) // PLACE_Q
            loads[a // spr] += na
            loads[b // spr] += int(counts[e]) - na
        return loads


def identity_plan(n_experts: int, ep: int = 1) -> PlacementPlan:
    """Expert e in slot e, no replicas — bitwise-identical dispatch."""
    e = np.arange(n_experts, dtype=np.int64)
    return PlacementPlan(n_experts, ep, e.copy(), e.copy(), e.copy(),
                         np.zeros(n_experts, np.int64))


def imbalance(loads) -> float:
    """max/mean per-rank load; 1.0 (perfectly balanced) when idle."""
    loads = np.asarray(loads, np.float64)
    if loads.size == 0 or loads.sum() <= 0:
        return 1.0
    return float(loads.max() / loads.mean())


def plan_placement(expert_tokens, ep: int, *, rank_time_per_token=None,
                   replicate: bool = True) -> PlacementPlan:
    """Map measured per-expert token counts to a placement plan.

    ``rank_time_per_token``: optional (ep,) measured seconds/token per rank
    — fed to ``find_optimal_workload`` so slower ranks get proportionally
    smaller token targets (the paper's heterogeneous-farm rule).  ``None``
    means uniform ranks (balanced ±1 targets).

    Fully deterministic: ties break toward the lowest expert id / lowest
    rank (stable argsorts, first-max argmax).
    """
    counts = np.asarray(expert_tokens, np.int64).reshape(-1)
    E = counts.size
    if E == 0 or ep < 1 or E % ep:
        raise ValueError(f"n_experts={E} not divisible by ep={ep}")
    spr = E // ep
    total = int(counts.sum())

    times = (np.ones(ep) if rank_time_per_token is None
             else np.asarray(rank_time_per_token, np.float64))
    base = total // ep
    cur = np.full(ep, base, np.int64)
    cur[: total - base * ep] += 1
    targets = (find_optimal_workload(times, cur).astype(np.float64)
               if total else cur.astype(np.float64))

    # greedy LPT under per-rank slot budgets: hottest expert first, onto
    # the rank with the largest remaining deficit that has a free slot
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(ep, np.float64)
    free = np.full(ep, spr, np.int64)
    phys_expert = np.full(E, -1, np.int64)
    slot_a = np.full(E, -1, np.int64)
    slot_b = np.full(E, -1, np.int64)
    split_q = np.zeros(E, np.int64)
    for e in order:
        deficit = targets - load
        deficit[free == 0] = -np.inf
        r = int(np.argmax(deficit))
        s = r * spr + int(spr - free[r])
        phys_expert[s] = e
        slot_a[e] = slot_b[e] = s
        load[r] += counts[e]
        free[r] -= 1

    if replicate and total:
        for _ in range(2 * E):
            r_hot = int(np.argmax(load))
            surplus = load[r_hot] - targets[r_hot]
            if surplus <= 0:
                break
            cand = [e for e in range(E)
                    if slot_a[e] >= 0 and slot_a[e] == slot_b[e]
                    and int(slot_b[e]) // spr == r_hot and counts[e] > 1]
            if not cand:
                break
            h = max(cand, key=lambda e: (counts[e], -e))
            # replica slot: a zero-traffic expert's slot on the most
            # underloaded rank — measured-hot experts are never evicted
            best = None
            for s in range(E):
                z = int(phys_expert[s])
                if (s // spr == r_hot or counts[z] != 0
                        or int(slot_a[z]) != s):
                    continue
                d = targets[s // spr] - load[s // spr]
                if best is None or d > best[0]:
                    best = (d, s)
            if best is None:
                # every zero-traffic expert sits on the hot rank (LPT packs
                # real traffic elsewhere first): swap one with the coldest
                # rank's smallest expert, then retry — pure permutation
                zeros = [e for e in range(E) if counts[e] == 0
                         and slot_a[e] >= 0 and slot_a[e] == slot_b[e]
                         and int(slot_a[e]) // spr == r_hot]
                order_r = np.argsort(load, kind="stable")
                r_cold = next((int(r) for r in order_r if r != r_hot), None)
                if not zeros or r_cold is None:
                    break
                small = [e for e in range(E)
                         if slot_a[e] >= 0 and slot_a[e] == slot_b[e]
                         and int(slot_a[e]) // spr == r_cold and e != h]
                if not small:
                    break
                z = min(zeros)
                w = min(small, key=lambda e: (counts[e], e))
                sz, sw = int(slot_a[z]), int(slot_a[w])
                slot_a[z] = slot_b[z] = sw
                slot_a[w] = slot_b[w] = sz
                phys_expert[sz], phys_expert[sw] = w, z
                load[r_hot] += counts[w]
                load[r_cold] -= counts[w]
                continue
            s_cold = best[1]
            r_cold = s_cold // spr
            move = min(surplus, targets[r_cold] - load[r_cold],
                       float(counts[h] - 1))
            if move < 1:
                break
            keep_frac = (counts[h] - move) / counts[h]
            q = int(np.clip(round(keep_frac * PLACE_Q), 1, PLACE_Q - 1))
            z = int(phys_expert[s_cold])
            slot_a[z] = slot_b[z] = -1                 # evicted
            phys_expert[s_cold] = h
            slot_b[h] = s_cold                         # overflow replica
            split_q[h] = q
            moved = counts[h] - counts[h] * q // PLACE_Q
            load[r_hot] -= moved
            load[r_cold] += moved

    return PlacementPlan(E, ep, phys_expert, slot_a, slot_b, split_q)


def apply_placement(params, plan: PlacementPlan):
    """Permute the expert-stacked MoE weight leaves into physical-slot
    order (slot s gets expert ``phys_expert[s]``'s rows).  Returns a new
    params tree sharing every other leaf; the router is NOT permuted —
    routing stays logical, only the dispatch map is physical.  Handles
    weights-only int8 leaves ({"q8", "s8"}: per-tensor scale, so only the
    int8 payload permutes)."""
    idx = np.asarray(plan.phys_expert, np.int64)
    if (idx < 0).any():
        raise ValueError("placement plan leaves a physical slot unassigned")

    def permute(leaf):
        if isinstance(leaf, dict):                     # {"q8", "s8"}
            return dict(leaf, q8=leaf["q8"][:, idx])
        return leaf[:, idx]

    blocks = dict(params["blocks"])
    if "moe" not in blocks:
        raise ValueError("model has no expert-stacked weights to place")
    moe = dict(blocks["moe"])
    for k in ("gate", "up", "down"):
        moe[k] = permute(moe[k])
    blocks["moe"] = moe
    out = dict(params)
    out["blocks"] = blocks
    return out
