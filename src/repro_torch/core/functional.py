"""The paper's §2 entry points, kept as thin wrappers over the executor
runtime (:mod:`repro_torch.core.runtime`), as in ``repro.core.functional``:

1. :func:`solve_problem` — :class:`~repro_torch.core.runtime.SerialExecutor`
   (paper-faithful serial semantics, any Python callables).
2. :func:`vmap_solve_problem` — :class:`~repro_torch.core.runtime.VmapExecutor`
   (one device, ``torch.func.vmap`` over the stacked tasks).
3. :func:`parallel_solve_problem` —
   :class:`~repro_torch.core.runtime.MeshExecutor` (the ranks of a
   :class:`~repro_torch.core.comm.Comm`; pad+mask replaces the paper's ±1
   rule, and two-argument finalizers receive ``finalize(outputs,
   valid_mask)``).
4. :func:`host_task_farm` —
   :class:`~repro_torch.core.runtime.ThreadFarmExecutor` (concurrent
   master/worker farm for arbitrary host callables, with work stealing,
   timing-proportional rebalancing and deadline-based straggler
   re-dispatch).
"""
from __future__ import annotations

from typing import Callable, Sequence

from repro_torch.core.comm import Comm
from repro_torch.core.runtime import (MeshExecutor, SerialExecutor,
                                      ThreadFarmExecutor, VmapExecutor)


def solve_problem(initialize: Callable, func: Callable, finalize: Callable):
    """``output = [func(*a, **kw) for a, kw in initialize()]; finalize(output)``."""
    return SerialExecutor().run(initialize, func, finalize)


def vmap_solve_problem(initialize: Callable, func: Callable,
                       finalize: Callable):
    """``initialize()`` returns a tree whose leaves stack the per-task args
    along axis 0; ``func`` maps one task's slice to outputs."""
    return VmapExecutor().run(initialize, func, finalize)


def parallel_solve_problem(initialize: Callable, func: Callable,
                           finalize: Callable, comm: Comm | None = None):
    """Task farm over the ranks of ``comm`` (the paper's
    ``parallel_solve_problem``); see
    :class:`repro_torch.core.runtime.MeshExecutor`."""
    return MeshExecutor(comm).run(initialize, func, finalize)


def host_task_farm(tasks: Sequence[Callable[[], object]], *,
                   num_workers: int | None = None,
                   deadline_factor: float | None = None):
    """Run independent zero-arg callables on the concurrent thread farm.

    Returns (results list, stats dict) with the ``timings`` /
    ``stragglers`` keys plus the farm's ``steals`` / ``rebalances`` /
    ``worker_tasks`` counters.  Each call gets its own farm (released on
    return), so concurrent callers stay fully independent.  Hot loops that
    farm work every tick should hold a
    :class:`~repro_torch.core.runtime.ThreadFarmExecutor` instead and reuse
    its persistent pool (the serving engine does).
    """
    farm = ThreadFarmExecutor(num_workers=num_workers,
                              deadline_factor=deadline_factor)
    try:
        return farm.map_callables(list(tasks))
    finally:
        farm.shutdown()
