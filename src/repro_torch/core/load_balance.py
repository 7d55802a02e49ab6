"""Dynamic load balancing at host level — the paper's §3.2 machinery.

Counterpart of the host-level half of ``repro.core.load_balance``:
:func:`find_optimal_workload` gives each worker work in proportion to its
measured speed (workers that measured slower get fewer items), and
:func:`redistribute_plan` is the paper's iterative max -> min transfer
schedule.  The thread farm (:mod:`repro_torch.core.runtime`) uses both to
rebalance queued tasks.  The SPMD count-based functions come with the
runtime's mesh executor.
"""
from __future__ import annotations

import numpy as np


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
