"""The paper's concurrent master/worker farm over host threads.

Counterpart of :class:`repro.core.runtime.ThreadFarmExecutor`, the part of
the reference's executor runtime that the serving engine runs on: the
dense per-slot path farms one whole-prompt prefill per admitted request
through :meth:`ThreadFarmExecutor.map_callables`.  A task is a zero-arg
callable; on a card its kernels launch from the worker thread (the ctypes
launch releases the GIL) onto that thread's current stream.

The farm carries the paper's §3.2 dynamic-scheduling machinery at host
level, as the reference does, both always on:

* **work stealing** — tasks start on per-worker deques (the paper's ±1
  partition, :func:`repro_torch.core.partition.partition_offsets`); an idle
  worker steals from the back of the longest queue.
* **timing-proportional rebalancing** — queued work is periodically
  redistributed with
  :func:`repro_torch.core.load_balance.find_optimal_workload` and
  :func:`repro_torch.core.load_balance.redistribute_plan`.

The reference's straggler re-dispatch (``deadline_factor``) has no user in
the serving engine; it comes with ``host_task_farm``, which needs it.  The
reference's ``(initialize, func, finalize)`` contract (``run``) and its
serial, vmap and mesh executors come with the runtime-and-transport slice.
"""
from __future__ import annotations

__all__ = ["ThreadFarmExecutor"]

import collections
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Sequence

from repro_torch.core import partition as _part
from repro_torch.core.load_balance import (find_optimal_workload,
                                           redistribute_plan)


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
        self.errors: list = [None] * n
        self.completed = 0
        self.task_timings: list = [None] * n   # per task INDEX
        self.worker_times: list[list[float]] = [[] for _ in range(num_workers)]
        self.worker_tasks = [0] * num_workers
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
    """

    def __init__(self, num_workers: int | None = None):
        self.num_workers = num_workers
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
        """The paper's ``(initialize, func, finalize)`` contract: not ported
        yet (the serving engine calls :meth:`map_callables` directly)."""
        raise NotImplementedError(
            "ThreadFarmExecutor.run is not ported yet: it comes with the "
            "runtime and transport slice (ROADMAP A7)")

    # -- the farm itself ------------------------------------------------------

    def map_callables(self, thunks: Sequence[Callable[[], Any]]):
        """Run independent zero-arg callables; returns (results, stats).

        Results are indexed by task position regardless of execution order
        (work stealing and rebalancing never reorder outputs).
        """
        n = len(thunks)
        if n == 0:
            return [], {"timings": [], "steals": 0, "rebalances": 0,
                        "worker_tasks": [], "num_workers": 0}
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
            with st.cond:
                while (st.completed < st.n and st.worker_crash is None
                       and not st.failed):
                    st.cond.wait()
            if st.worker_crash is not None:
                raise st.worker_crash   # a bug in the farm itself, not a task
        for err in st.errors:
            if err is not None:
                raise err
        stats = {"timings": st.task_timings, "steals": st.steals,
                 "rebalances": st.rebalances,
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
        """Serial fallback for nested calls: one task after another."""
        results, timings = [], []
        for thunk in thunks:
            t0 = time.perf_counter()
            results.append(thunk())
            timings.append(time.perf_counter() - t0)
        return results, {"timings": timings, "steals": 0, "rebalances": 0,
                         "worker_tasks": [len(thunks)], "num_workers": 1}

    def _worker(self, st: _FarmState, wid: int, thunks):
        while True:
            with st.cond:
                if st.failed or st.worker_crash is not None:
                    return
                idx = self._pop_task(st, wid)
                if idx is None:
                    return      # nothing queued anywhere: tasks only shrink
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
                st.results[idx] = out
                st.errors[idx] = err
                st.completed += 1
                st.task_timings[idx] = dt
                st.worker_times[wid].append(dt)
                st.worker_tasks[wid] += 1
                st._since_rebalance += 1
                if err is not None:
                    # fail fast: stop starting queued tasks (the serial
                    # farm propagated the first error immediately)
                    st.failed = True
                    for q in st.queues:
                        q.clear()
                self._maybe_rebalance(st)
                st.cond.notify_all()

    @staticmethod
    def _pop_task(st: _FarmState, wid: int):
        """Own queue first, else steal from the back of the longest."""
        if st.queues[wid]:
            return st.queues[wid].popleft()
        victim = max(range(len(st.queues)), key=lambda w: len(st.queues[w]))
        if not st.queues[victim]:
            return None
        st.steals += 1
        return st.queues[victim].pop()

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
