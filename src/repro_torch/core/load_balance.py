"""Dynamic load balancing — the paper's §3.2 machinery.

Counterpart of ``repro.core.load_balance``.  Two regimes:

* **Host level (paper-faithful)**: :func:`find_optimal_workload` gives
  each worker work in proportion to its measured speed (workers that
  measured slower get fewer items), and :func:`redistribute_plan` is the
  paper's iterative max -> min transfer schedule.  The thread farm
  (:mod:`repro_torch.core.runtime`) uses both to rebalance queued tasks.
* **SPMD level**: populations live in fixed-capacity, compacted tensors
  (``data[:count]`` are live).  :func:`redistribute_work` equalizes counts
  across the ranks of a :class:`~repro_torch.core.comm.Comm` with a
  deterministic all-gather and a global re-slice, and
  :func:`dynamic_load_balancing` wraps it in the paper's threshold test.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree


def find_optimal_workload(timing_list, current_work_per_proc):
    """The paper's implementation (numpy).

    ``C = total_work / sum(1/t_i)``; rank i gets ``C / t_i`` items, remainders
    distributed greedily by largest fractional part.
    """
    timing_list = np.asarray(timing_list, dtype=np.float64)
    current_work_per_proc = np.asarray(current_work_per_proc, dtype=np.int64)
    total_work = int(current_work_per_proc.sum())
    C = total_work / np.sum(1.0 / timing_list)
    tmp = C / timing_list
    rebalanced = tmp.astype(np.int64)
    remainders = tmp - rebalanced
    while rebalanced.sum() < total_work:
        k = int(np.argmax(remainders))
        rebalanced[k] += 1
        remainders[k] = 0
    return rebalanced


def redistribute_plan(work_per_proc, rebalanced_work):
    """Paper's transfer schedule: repeatedly move surplus from the most
    overloaded rank to the most underloaded.  Returns [(src, dst, n), ...]."""
    diff = (np.asarray(work_per_proc, np.int64)
            - np.asarray(rebalanced_work, np.int64))
    plan: list[tuple[int, int, int]] = []
    while diff.any():
        src = int(np.argmax(diff))
        dst = int(np.argmin(diff))
        n = int(min(diff[src], -diff[dst]))
        if n <= 0:
            break
        plan.append((src, dst, n))
        diff[src] -= n
        diff[dst] += n
    return plan


# ---------------------------------------------------------------------------
# SPMD count-based rebalancing
# ---------------------------------------------------------------------------

def balanced_counts(total, n: int) -> torch.Tensor:
    """Target per-rank counts (±1 rule), as an int32 tensor of shape (n,)
    on ``total``'s device."""
    total = torch.as_tensor(total, dtype=torch.int32)
    base = total // n
    extra = total - base * n
    return base + (torch.arange(n, device=total.device) < extra).to(
        torch.int32)


def _gather_counts(local_count, comm) -> torch.Tensor:
    c = torch.as_tensor(local_count).reshape(()).to(torch.int32)
    return comm.all_gather(c).reshape(comm.size())


def redistribute_work(local_data, local_count, comm, target_counts=None):
    """Equalize a compacted fixed-capacity population across ``comm``'s
    ranks.

    Args:
      local_data: pytree; every leaf has shape (capacity, ...) and live items
        occupy slots [0, local_count).
      local_count: int32 scalar tensor of live items on this rank.
      comm: :class:`~repro_torch.core.comm.Comm` over the population's ranks.
      target_counts: optional (n,) target; defaults to balanced ±1 split.

    Returns (new_local_data, new_local_count), the count int32 in the
    shape it came in.  Deterministic: the global rank-major order of live
    items is preserved (the paper's rank-ordered cut/paste semantics).
    """
    n, rank = comm.size(), comm.rank()
    count_shape = torch.as_tensor(local_count).shape
    counts = _gather_counts(local_count, comm)
    if target_counts is None:
        target_counts = balanced_counts(counts.sum(), n)
    target_counts = torch.as_tensor(target_counts, dtype=torch.int32,
                                    device=counts.device)
    zero = counts.new_zeros(1)
    src_offsets = torch.cat([zero, torch.cumsum(counts, 0)[:-1]]).to(
        torch.int32)
    dst_offsets = torch.cat([zero, torch.cumsum(target_counts, 0)[:-1]]).to(
        torch.int32)
    my_target = target_counts[rank]
    my_dst_off = dst_offsets[rank]

    def reslice(leaf):
        cap = leaf.shape[0]
        gathered = comm.all_gather(leaf)           # (n, cap, ...)
        # global index of my new slot s is my_dst_off + s; its source rank r
        # satisfies src_offsets[r] <= g < src_offsets[r] + counts[r].
        s = torch.arange(cap, dtype=torch.int32, device=leaf.device)
        g = my_dst_off + s
        r = (torch.searchsorted(src_offsets, g, right=True) - 1).clamp(0,
                                                                       n - 1)
        j = g - src_offsets[r]
        valid = s < my_target
        j = torch.where(valid, j.clamp(0, cap - 1), 0).long()
        out = gathered[r, j]
        # zero out dead slots so padding stays inert
        mask = valid.reshape((cap,) + (1,) * (out.ndim - 1))
        return torch.where(mask, out, torch.zeros_like(out))

    new_data = pytree.tree_map(reslice, local_data)
    return new_data, my_target.to(torch.int32).reshape(count_shape)


def dynamic_load_balancing(local_data, local_count, comm,
                           threshold_factor: float = 1.1):
    """Paper's ``dynamic_load_balancing``: rebalance only when
    ``max_count > threshold_factor * min_count``.

    The reference decides inside the compiled program (``lax.cond``); here
    the counts' all-gather is read on the host and the branch is taken in
    Python.  Every rank reads the same counts, so every rank takes the same
    branch and calls the same collectives.

    Returns (data, count, counts_per_rank, did_rebalance).
    """
    count_shape = torch.as_tensor(local_count).shape
    counts = _gather_counts(local_count, comm).cpu().numpy()
    # float32, as the reference compares
    need = bool(np.float32(counts.max()) > np.float32(threshold_factor)
                * np.float32(max(counts.min(), 1)))
    if need:
        data, count = redistribute_work(local_data, local_count, comm)
    else:
        data = local_data
        count = torch.as_tensor(local_count).to(torch.int32).reshape(
            count_shape)
    return data, count, _gather_counts(count, comm), need
