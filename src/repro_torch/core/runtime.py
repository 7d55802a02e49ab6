"""The function-centric executor runtime — one scheduling subsystem for the
paper's ``(initialize, func, finalize)`` contract.

Counterpart of ``repro.core.runtime``: the same four executors over the
same user functions, on torch.

=============================  ============================================
Executor                       Parallelism
=============================  ============================================
:class:`SerialExecutor`        none — the paper's §2.1 loop, verbatim
                               semantics
:class:`VmapExecutor`          one device — ``torch.func.vmap`` over the
                               stacked tasks
:class:`MeshExecutor`          SPMD — each rank of a
                               :class:`~repro_torch.core.comm.Comm` takes
                               its share of the padded tasks, gather to all
:class:`ThreadFarmExecutor`    host threads — a genuinely concurrent
                               master/worker farm (device launches and
                               I/O release the GIL)
=============================  ============================================

Every executor accepts the same user functions:

* ``initialize() -> tasks`` — either the paper's host form (a list of
  ``(args, kwargs)`` pairs) or the stacked form (a tree of tensors whose
  leaves stack the per-task arguments along axis 0).
* ``func`` — maps one task to its output (``func(*args, **kwargs)`` in host
  form; ``func(task_slice)`` in stacked form).
* ``finalize(outputs)`` or ``finalize(outputs, valid_mask)`` — run once on
  the master with the collected results.  Executors that pad (the mesh tier)
  pass the valid-task mask when ``finalize`` takes two arguments, otherwise
  they trim padding first — so serial user code never sees padding.

The vmap and mesh tiers run ``torch.func.vmap(func, randomness="error")``:
no generator state can hide in a task, so a task that draws random numbers
takes an explicit key (:mod:`repro_torch.serve.prng`'s tensor keys).

The :class:`ThreadFarmExecutor` carries the paper's §3.2 dynamic-scheduling
machinery at host level.  The serving engine's dense path farms one
whole-prompt prefill a task through :meth:`ThreadFarmExecutor.map_callables`;
on a card a task's kernels launch from its worker thread onto that
thread's current stream.

* **work stealing** — tasks start on per-worker deques (the paper's ±1
  partition, order-preserving); an idle worker steals from the back of the
  longest queue.
* **timing-proportional rebalancing** — queued work is periodically
  redistributed with
  :func:`repro_torch.core.load_balance.find_optimal_workload` and
  :func:`repro_torch.core.load_balance.redistribute_plan` (workers that
  measured slower keep fewer items).
* **straggler re-dispatch** — with ``deadline_factor`` set, an idle worker
  re-issues any task whose elapsed time exceeds
  ``max(deadline_factor * median_runtime, min_straggler_s)``; the first
  completion wins (the classic backup-task trick).
"""
from __future__ import annotations

import bisect
import collections
import inspect
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Any, Callable, Protocol, Sequence, runtime_checkable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import partition as _part
from repro_torch.core.collect import collect_subproblem_output_args
from repro_torch.core.comm import Comm
from repro_torch.core.load_balance import (find_optimal_workload,
                                           redistribute_plan)


# ---------------------------------------------------------------------------
# Shared contract helpers
# ---------------------------------------------------------------------------

def _finalize_arity(finalize: Callable) -> int:
    """How many positional arguments ``finalize`` accepts (1 or 2).

    Two-argument finalizers receive ``(outputs, valid_mask)`` — the documented
    padded-farm signature; one-argument finalizers get padding trimmed off.
    Only a second *required* positional counts: a defaulted second parameter
    (``np.mean``'s ``axis``, a ``verbose=False`` flag) or ``*args`` keeps the
    one-argument calling convention, so the mask can never land in an
    unrelated parameter.
    """
    try:
        sig = inspect.signature(finalize)
    except (TypeError, ValueError):
        return 1
    required = [p for p in sig.parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty]
    return 2 if len(required) >= 2 else 1


def _call_finalize(finalize: Callable, outputs, mask, n_valid: int):
    """Invoke ``finalize`` honoring its arity: padded outputs + mask for
    two-argument finalizers, trimmed outputs for one-argument ones."""
    if _finalize_arity(finalize) >= 2:
        return finalize(outputs, mask)
    leaves = pytree.tree_leaves(outputs)
    if leaves and leaves[0].shape[0] != n_valid:        # only the mesh pads
        outputs = pytree.tree_map(lambda x: x[:n_valid], outputs)
    return finalize(outputs)


def _normalize_tasks(tasks):
    """Materialize non-tree iterables (generators of task pairs are valid
    input to the paper's ``for a, kw in initialize()`` loop)."""
    if (not isinstance(tasks, (list, tuple, dict))
            and not hasattr(tasks, "shape") and hasattr(tasks, "__iter__")):
        return list(tasks)
    return tasks


def _is_host_tasks(tasks) -> bool:
    """Paper host form (list of ``(args, kwargs)`` pairs) vs stacked-tree
    form.  A tuple of stacked tensors — e.g. ``(a_vals, b_vals)`` — is a
    valid stacked form, so only the exact pair shape selects the host
    path."""
    return (isinstance(tasks, (list, tuple))
            and all(isinstance(t, (tuple, list)) and len(t) == 2
                    and isinstance(t[0], (tuple, list))
                    and isinstance(t[1], dict)
                    for t in tasks))


def _n_stacked(tasks) -> int:
    return pytree.tree_leaves(tasks)[0].shape[0]


def _all_valid(tasks, n: int) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool,
                      device=pytree.tree_leaves(tasks)[0].device)


def _task_slice(tasks, i: int):
    return pytree.tree_map(lambda x: x[i], tasks)


def _stack_outputs(outputs: Sequence):
    return pytree.tree_map(lambda *xs: torch.stack(xs), *outputs)


def _vmap(func: Callable) -> Callable:
    return torch.func.vmap(func, randomness="error")


def straggler_deadline(timings: Sequence[float], factor: float,
                       floor: float = 0.0) -> float:
    """Shared deadline rule: ``max(factor * median(timings), floor)``
    (upper median of an even-length list)."""
    if not timings:
        return floor                 # no history yet: only the floor applies
    med = sorted(timings)[len(timings) // 2]
    return max(factor * med, floor)


# ---------------------------------------------------------------------------
# The Executor protocol
# ---------------------------------------------------------------------------

@runtime_checkable
class Executor(Protocol):
    """Anything that can drive the paper's three user functions."""

    def run(self, initialize: Callable, func: Callable, finalize: Callable):
        ...


class SerialExecutor:
    """Paper-faithful §2.1: a Python loop over tasks, no parallelism.

    Host form keeps the paper's exact semantics
    (``output = [func(*a, **kw) for a, kw in initialize()]``); stacked form
    loops over leading-axis slices and stacks the outputs, so it is the
    reference for the vectorized tiers.
    """

    def run(self, initialize, func, finalize):
        tasks = _normalize_tasks(initialize())
        if _is_host_tasks(tasks):
            output = [func(*args, **kwargs) for args, kwargs in tasks]
            return finalize(output)
        n = _n_stacked(tasks)
        outputs = _stack_outputs([func(_task_slice(tasks, i))
                                  for i in range(n)])
        return _call_finalize(finalize, outputs, _all_valid(tasks, n), n)


class VmapExecutor:
    """Single-device tier: ``torch.func.vmap(func)`` over the stacked task
    tree."""

    def run(self, initialize, func, finalize):
        tasks = _normalize_tasks(initialize())
        if _is_host_tasks(tasks):
            raise TypeError("VmapExecutor needs stacked-tree tasks; use "
                            "SerialExecutor or ThreadFarmExecutor for host "
                            "(args, kwargs) task lists")
        n = _n_stacked(tasks)
        outputs = _vmap(func)(tasks)
        return _call_finalize(finalize, outputs, _all_valid(tasks, n), n)


class MeshExecutor:
    """SPMD tier: the tasks split over the ranks of ``comm``.

    Every rank pads the tasks to a multiple of the world size (the paper's
    ±1 rule becomes pad+mask), runs ``vmap(func)`` on its own equal share
    of the rows and all-gathers the outputs in rank-major order.
    Two-argument finalizers receive the *padded* outputs plus the
    valid-task mask (the documented ``finalize(outputs, valid_mask)``
    contract); one-argument finalizers get the padding trimmed.  Without a
    ``comm``, the default process group's, or with none initialized this
    process alone (world 1: it pads, masks and runs with no group).
    """

    def __init__(self, comm: Comm | None = None):
        self.comm = Comm() if comm is None else comm

    def run(self, initialize, func, finalize):
        tasks = _normalize_tasks(initialize())
        if _is_host_tasks(tasks):
            raise TypeError("MeshExecutor needs stacked-tree tasks")
        n_tasks = _n_stacked(tasks)
        size = self.comm.size()
        padded = _part.pad_to_multiple(n_tasks, size)
        tasks, mask = _part.pad_leading(tasks, padded)
        mine = _part.shard_tasks(tasks, self.comm.rank(), size)
        out = collect_subproblem_output_args(_vmap(func)(mine), self.comm)
        return _call_finalize(finalize, out, mask, n_tasks)


# ---------------------------------------------------------------------------
# The concurrent host-level task farm
# ---------------------------------------------------------------------------

class _FarmState:
    """Shared master/worker state, guarded by one condition variable."""

    def __init__(self, n: int, num_workers: int):
        self.n = n
        self.cond = threading.Condition()
        # per-worker deques seeded with the paper's ±1 contiguous partition
        offs = _part.partition_offsets(n, num_workers)
        self.queues = [collections.deque(range(offs[w], offs[w + 1]))
                       for w in range(num_workers)]
        self.results: list = [None] * n
        self.done = [False] * n
        self.attempts = [0] * n          # attempts dispatched (0, 1, or 2)
        self.attempts_done = [0] * n     # attempts finished (incl. failures)
        self.errors: list = [None] * n
        self.started: dict[int, float] = {}     # idx -> first-attempt start
        self.completed = 0
        self.task_timings: list = [None] * n   # per task INDEX
        self.sorted_timings: list[float] = []  # for O(1) median at the poll
        self.worker_times: list[list[float]] = [[] for _ in range(num_workers)]
        self.worker_tasks = [0] * num_workers
        self.stragglers: list[int] = []
        self.steals = 0
        self.rebalances = 0
        self._since_rebalance = 0
        self.worker_crash: BaseException | None = None
        self.failed = False              # a task settled with an error


class ThreadFarmExecutor:
    """A genuinely concurrent master/worker farm over host threads.

    Each task is typically a sequence of device launches or an I/O-bound
    callable — both release the GIL, so a thread pool gives real overlap.

    Args:
      num_workers: pool size (default ``min(n_tasks, os.cpu_count())``).
      deadline_factor: enable straggler re-dispatch — an *idle* worker
        re-issues a task whose elapsed time exceeds
        ``max(deadline_factor * median_runtime, min_straggler_s)``; first
        completion wins and each task is re-issued at most once.
      rebalance: enable timing-proportional redistribution of queued work
        (paper's ``find_optimal_workload`` + ``redistribute_plan``).
      steal: enable idle workers stealing from the longest queue.
      min_straggler_s: floor under which a running task is never considered a
        straggler (guards against µs-scale medians re-issuing healthy tasks).
      poll_interval: idle-worker wait granularity in seconds.
    """

    def __init__(self, num_workers: int | None = None, *,
                 deadline_factor: float | None = None,
                 rebalance: bool = True, steal: bool = True,
                 min_straggler_s: float = 0.01,
                 poll_interval: float = 0.002):
        self.num_workers = num_workers
        self.deadline_factor = deadline_factor
        self.rebalance = rebalance
        self.steal = steal
        self.min_straggler_s = min_straggler_s
        self.poll_interval = poll_interval
        # the OS thread pool persists across map calls (admission loops call
        # the farm every tick; per-call pool teardown is pure overhead)
        self._pool: ThreadPoolExecutor | None = None
        self._pool_size = 0
        self._call_lock = threading.Lock()
        self._in_worker = threading.local()   # marks this farm's own threads

    def _get_pool(self, n_workers: int) -> ThreadPoolExecutor:
        if self._pool is None or self._pool_size < n_workers:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
            self._pool = ThreadPoolExecutor(max_workers=n_workers)
            self._pool_size = n_workers
        return self._pool

    def shutdown(self):
        """Release the persistent pool.  Safe against an in-flight
        ``map_callables`` (waits for it); a later call transparently
        recreates the pool."""
        with self._call_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=False)
                self._pool = None
                self._pool_size = 0

    # -- the Executor contract ----------------------------------------------

    def run(self, initialize, func, finalize):
        tasks = _normalize_tasks(initialize())
        if _is_host_tasks(tasks):
            thunks = [partial(func, *args, **kwargs) for args, kwargs in tasks]
            results, _ = self.map_callables(thunks)
            return finalize(results)
        n = _n_stacked(tasks)
        thunks = [partial(func, _task_slice(tasks, i)) for i in range(n)]
        results, _ = self.map_callables(thunks)
        return _call_finalize(finalize, _stack_outputs(results),
                              _all_valid(tasks, n), n)

    # -- the farm itself ------------------------------------------------------

    def map_callables(self, thunks: Sequence[Callable[[], Any]]):
        """Run independent zero-arg callables; returns (results, stats).

        Results are indexed by task position regardless of execution order
        (work stealing and re-dispatch never reorder outputs).
        """
        n = len(thunks)
        if n == 0:
            return [], {"timings": [], "stragglers": [], "steals": 0,
                        "rebalances": 0, "worker_tasks": [], "num_workers": 0}
        W = self.num_workers or (os.cpu_count() or 1)
        W = max(1, min(W, n))
        if getattr(self._in_worker, "active", False):
            # a task of THIS farm instance is calling back into the same
            # instance (e.g. a task on a long-lived engine farm): taking
            # _call_lock would deadlock against the outer run, so nest
            # serially — the paper's serial semantics
            return self._map_serial(thunks)
        # serialize whole-farm runs: one pool, one run at a time per instance
        with self._call_lock:
            st = _FarmState(n, W)
            pool = self._get_pool(W)
            for wid in range(W):
                pool.submit(self._safe_worker, st, wid, thunks)
            # Wait for every TASK to settle, not for every WORKER to return:
            # with straggler re-dispatch, a backup completion must unblock
            # the caller even while the original attempt is still stuck in
            # its thunk (that worker keeps its pool slot until the thunk
            # returns — the cost of backing up a truly hung task).
            with st.cond:
                while (st.completed < st.n and st.worker_crash is None
                       and not st.failed):
                    st.cond.wait()
            if st.worker_crash is not None:
                raise st.worker_crash   # a bug in the farm itself, not a task
        for err in st.errors:
            if err is not None:
                raise err
        stats = {"timings": st.task_timings, "stragglers": st.stragglers,
                 "steals": st.steals, "rebalances": st.rebalances,
                 "worker_tasks": st.worker_tasks, "num_workers": W}
        return st.results, stats

    # -- worker internals -----------------------------------------------------

    def _safe_worker(self, st: _FarmState, wid: int, thunks):
        """Worker-loop bugs must wake the master, never silently strand it."""
        self._in_worker.active = True
        try:
            self._worker(st, wid, thunks)
        except BaseException as e:                      # noqa: BLE001
            with st.cond:
                st.worker_crash = e
                st.cond.notify_all()
        finally:
            self._in_worker.active = False

    def _map_serial(self, thunks: Sequence[Callable[[], Any]]):
        """Serial fallback for nested calls: one task after another,
        including the post-hoc straggler redo."""
        results, timings, stragglers = [], [], []
        for i, thunk in enumerate(thunks):
            t0 = time.perf_counter()
            out = thunk()
            dt = time.perf_counter() - t0
            if (self.deadline_factor is not None and timings
                    and dt > straggler_deadline(timings, self.deadline_factor,
                                                self.min_straggler_s)):
                stragglers.append(i)
                t0 = time.perf_counter()
                try:
                    redo, redo_ok = thunk(), True
                except BaseException:                   # noqa: BLE001
                    redo, redo_ok = None, False
                redo_dt = time.perf_counter() - t0
                if redo_ok and redo_dt < dt:
                    out, dt = redo, redo_dt
            results.append(out)
            timings.append(dt)
        return results, {"timings": timings, "stragglers": stragglers,
                         "steals": 0, "rebalances": 0,
                         "worker_tasks": [len(thunks)], "num_workers": 1}

    def _worker(self, st: _FarmState, wid: int, thunks):
        while True:
            with st.cond:
                idx = None
                while idx is None:
                    if (st.completed >= st.n or st.failed
                            or st.worker_crash is not None):
                        return
                    idx = self._pop_task(st, wid)
                    if idx is None:
                        # nothing queued: wait for a completion.  Only time
                        # the wait when straggler re-dispatch is on — that is
                        # the one event that arrives by clock, not by notify.
                        st.cond.wait(self.poll_interval
                                     if self.deadline_factor is not None
                                     else None)
            t0 = time.perf_counter()
            try:
                out, err = thunks[idx](), None
            except BaseException as e:                  # noqa: BLE001
                # BaseException too: a task calling sys.exit() must settle
                # the task (error re-raised at the join), not kill the
                # worker loop and deadlock the farm
                out, err = None, e
            dt = time.perf_counter() - t0
            with st.cond:
                st.attempts_done[idx] += 1
                # single-worker farm: no idle peer can ever back up a
                # straggler, so keep the serial semantics — re-run a task
                # that breached the deadline BEFORE settling it, so the
                # master cannot return while the redo still mutates state
                inline_redo = (
                    err is None
                    and not st.done[idx]
                    and self.deadline_factor is not None
                    and len(st.queues) == 1
                    and st.attempts[idx] == 1
                    and len(st.sorted_timings) > 0
                    and dt > straggler_deadline(
                        st.sorted_timings, self.deadline_factor,
                        self.min_straggler_s))
                if inline_redo:
                    st.attempts[idx] = 2
                    st.stragglers.append(idx)
            if inline_redo:
                t0 = time.perf_counter()
                try:
                    out2, redo_ok = thunks[idx](), True
                except BaseException:                   # noqa: BLE001
                    out2, redo_ok = None, False         # keep the original
                dt2 = time.perf_counter() - t0
                if redo_ok and dt2 < dt:
                    out, dt = out2, dt2                 # faster attempt wins
            with st.cond:
                if inline_redo:
                    st.attempts_done[idx] += 1
                # An errored attempt only settles the task once no other
                # attempt is in flight — a fast-failing backup must not
                # discard an original that is still about to succeed.
                settles = not st.done[idx] and (
                    err is None
                    or st.attempts_done[idx] >= st.attempts[idx])
                if settles:                             # first success wins
                    st.done[idx] = True
                    st.started.pop(idx, None)   # keep the straggler scan
                    st.results[idx] = out       # proportional to in-flight
                    st.errors[idx] = err
                    st.completed += 1
                    st.task_timings[idx] = dt
                    bisect.insort(st.sorted_timings, dt)
                    st.worker_times[wid].append(dt)
                    st.worker_tasks[wid] += 1
                    st._since_rebalance += 1
                    if err is not None:
                        # fail fast: stop starting queued tasks (the serial
                        # farm propagated the first error immediately)
                        st.failed = True
                        for q in st.queues:
                            q.clear()
                    if self.rebalance:
                        self._maybe_rebalance(st)
                st.cond.notify_all()

    def _pop_task(self, st: _FarmState, wid: int):
        """Own queue -> steal from longest queue -> straggler re-dispatch."""
        now = time.perf_counter()
        q = st.queues[wid]
        if q:
            idx = q.popleft()
        else:
            idx = None
            if self.steal:
                victim = max(range(len(st.queues)),
                             key=lambda w: len(st.queues[w]))
                if st.queues[victim]:
                    idx = st.queues[victim].pop()
                    st.steals += 1
            if idx is None:
                return self._pop_straggler(st, now)
        st.attempts[idx] = 1
        st.started[idx] = now
        return idx

    def _pop_straggler(self, st: _FarmState, now: float):
        if self.deadline_factor is None or not st.sorted_timings:
            return None
        # sorted list maintained at settle time -> O(1) median per poll
        med = st.sorted_timings[len(st.sorted_timings) // 2]
        deadline = max(self.deadline_factor * med, self.min_straggler_s)
        for idx, t0 in st.started.items():
            if (not st.done[idx] and st.attempts[idx] == 1
                    and now - t0 > deadline):
                st.attempts[idx] = 2                    # re-issue at most once
                st.stragglers.append(idx)
                return idx
        return None

    @staticmethod
    def _maybe_rebalance(st: _FarmState):
        """Paper §3.2: redistribute queued work in proportion to measured
        per-worker speed.  Runs under the lock, at most once per W
        completions, once every worker has a timing sample."""
        W = len(st.queues)
        if (W < 2 or st._since_rebalance < W
                or any(not t for t in st.worker_times)):
            return
        queued = [len(q) for q in st.queues]
        if sum(queued) < 2:
            return
        st._since_rebalance = 0
        means = [max(sum(t) / len(t), 1e-9) for t in st.worker_times]
        targets = find_optimal_workload(means, queued)
        plan = redistribute_plan(queued, targets)
        for src, dst, k in plan:
            for _ in range(k):
                if st.queues[src]:
                    st.queues[dst].append(st.queues[src].pop())
        if plan:
            st.rebalances += 1


# ---------------------------------------------------------------------------
# Stage coordination
# ---------------------------------------------------------------------------

def run_stages(executor: Executor, stages: Sequence[Callable[[], Any]]) -> bool:
    """One coordination step of a multi-role pipeline, driven through the
    generic ``(initialize, func, finalize)`` contract: each stage is a
    zero-arg callable returning a truthy busy flag; ``initialize`` yields
    one host-form task per stage, ``func`` runs it, ``finalize`` ORs the
    busy flags.

    The SAME stage functions run serially (:class:`SerialExecutor`:
    deterministic order, stage i completes before i+1 starts) or
    overlapped (:class:`ThreadFarmExecutor`: stages that release the GIL
    run concurrently).  Stacked-form executors (vmap/mesh) cannot run host
    callables and reject host-form tasks themselves.  Returns True if any
    stage reported work.
    """
    return executor.run(
        lambda: [((stage,), {}) for stage in stages],
        lambda stage: bool(stage()),
        lambda outs: any(outs))


# ---------------------------------------------------------------------------
# Factory
# ---------------------------------------------------------------------------

_HOST_EXECUTORS = {
    "serial": SerialExecutor,
    "thread": ThreadFarmExecutor,
}


def make_executor(spec: str | Executor = "vmap", *, comm: Comm | None = None,
                  **kwargs) -> Executor:
    """Executor from a spec string: ``serial`` | ``vmap`` | ``mesh`` |
    ``thread``.  Passing an existing :class:`Executor` returns it unchanged;
    ``mesh`` runs over ``comm`` (default: see :class:`MeshExecutor`).
    """
    if not isinstance(spec, str):
        if kwargs or comm is not None:
            opts = (["comm"] if comm is not None else []) + sorted(kwargs)
            raise ValueError(
                "make_executor received an Executor instance together with "
                f"constructor options {opts} — options only apply to spec "
                "strings; configure the instance directly instead")
        return spec
    if spec in _HOST_EXECUTORS:
        return _HOST_EXECUTORS[spec](**kwargs)
    if spec == "vmap":
        return VmapExecutor(**kwargs)
    if spec == "mesh":
        return MeshExecutor(comm, **kwargs)
    raise ValueError(f"unknown executor spec {spec!r}; expected one of "
                     "'serial', 'vmap', 'mesh', 'thread'")
