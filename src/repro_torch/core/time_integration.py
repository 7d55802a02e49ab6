"""Generic time-integration loops — the paper's §3.2.

Counterpart of ``repro.core.time_integration``.  :func:`time_integration`
is the paper's serial loop, verbatim.  :func:`parallel_time_integration`
is the host loop around a per-step body (``do_timestep``) that runs on
the device or across the ranks of a group: the host plays the paper's
rank-0 orchestration (timing, load-balance trigger, ``finalize_timestep``
bookkeeping, fault hooks).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree


def time_integration(initialize: Callable, do_timestep: Callable,
                     finalize: Callable):
    """Paper-faithful serial loop (walkers = any object with __len__ and
    finalize_timestep)."""
    walkers, timesteps = initialize()
    output = []
    for _ in range(timesteps):
        old_len = len(walkers)
        output.append(do_timestep(walkers))
        walkers.finalize_timestep(old_len, len(walkers))
    return finalize(output)


def _to_host(x):
    return x.cpu() if isinstance(x, torch.Tensor) else x


def parallel_time_integration(
    initialize: Callable[[], tuple[Any, int]],
    do_timestep: Callable[[Any], tuple[Any, Any]],
    finalize: Callable[[list], Any],
    *,
    finalize_timestep: Optional[Callable[[Any, int, Any], Any]] = None,
    on_step_end: Optional[Callable[[int, Any, dict], None]] = None,
    should_stop: Optional[Callable[[int, Any], bool]] = None,
):
    """Generic host loop driving a device (or SPMD) step.

    Args:
      initialize: () -> (state, timesteps).  ``state`` lives on the device.
      do_timestep: (state) -> (new_state, observables).
      finalize: (list of host observables) -> result, run once at the end
        (paper's rank-0 finalize).
      finalize_timestep: optional (state, step, observables) -> state hook
        (paper's ``walkers.finalize_timestep``).
      on_step_end: optional host callback (step, observables, stats).
      should_stop: optional early-exit predicate.

    Each step's observables move to the host (one sync a step), so the
    step time covers the device's work.  Returns (finalize result, stats
    dict with per-step host timings).
    """
    state, timesteps = initialize()
    output = []
    timings = []
    for step in range(timesteps):
        t0 = time.perf_counter()
        state, obs = do_timestep(state)
        obs = pytree.tree_map(_to_host, obs)
        dt = time.perf_counter() - t0
        timings.append(dt)
        output.append(obs)
        if finalize_timestep is not None:
            state = finalize_timestep(state, step, obs)
        if on_step_end is not None:
            on_step_end(step, obs, {"step_time": dt})
        if should_stop is not None and should_stop(step, obs):
            break
    result = finalize(output)
    return result, {"timings": timings, "state": state}
