"""The port's thread farm and its host-level load balancing against the
reference's (``repro.core.runtime``, ``repro.core.load_balance``,
``repro.core.partition``): the same results, task order, work stealing,
rebalancing, fail-fast, nesting and pool reuse, and the same partition and
rebalance plans on the same numpy-seeded inputs."""
import threading
import time

import numpy as np
import pytest

from repro.core import load_balance as jlb
from repro.core import partition as jpart
from repro_torch.core import load_balance as lb
from repro_torch.core import partition as part
from repro_torch.core.runtime import ThreadFarmExecutor, _FarmState


def test_results_in_task_order_under_stealing():
    rng = np.random.default_rng(0)
    delays = rng.uniform(0.0, 0.004, size=64)
    farm = ThreadFarmExecutor(num_workers=8)
    results, stats = farm.map_callables(
        [lambda i=i: (time.sleep(delays[i]), i)[1] for i in range(64)])
    assert results == list(range(64))
    assert sum(stats["worker_tasks"]) == 64
    farm.shutdown()


def test_work_stealing_engages():
    """All slow work seeded on worker 0's queue (the ±1 partition gives it
    tasks 0-3 of 8) is partly stolen by worker 1."""
    farm = ThreadFarmExecutor(num_workers=2)
    results, stats = farm.map_callables(
        [lambda i=i: (time.sleep(0.03 if i < 4 else 0.0), i)[1]
         for i in range(8)])
    assert results == list(range(8))
    assert stats["steals"] >= 1
    assert min(stats["worker_tasks"]) >= 1
    farm.shutdown()


def test_timing_rebalance_triggers():
    def make(i):
        def task():
            if i < 10:                     # worker 0's seeded share is slow
                time.sleep(0.01)
            return i
        return task

    farm = ThreadFarmExecutor(num_workers=2)
    results, stats = farm.map_callables([make(i) for i in range(20)])
    assert results == list(range(20))
    assert stats["rebalances"] >= 1
    farm.shutdown()


def test_rebalance_moves_queued_work_by_measured_speed():
    """A worker measured 3x faster is handed queued work from the slower
    one's queue, by the reference's plan for the same timings."""
    st = _FarmState(20, 2)
    for q in st.queues:                    # 2 started, 8 left on each
        q.popleft(), q.popleft()
    st.worker_times = [[0.03, 0.03], [0.01, 0.01]]
    st._since_rebalance = 2
    ThreadFarmExecutor._maybe_rebalance(st)
    queued = [8, 8]
    targets = jlb.find_optimal_workload([0.03, 0.01], queued)
    moved = sum(k for _, _, k in jlb.redistribute_plan(queued, targets))
    assert moved > 0 and st.rebalances == 1
    assert [len(q) for q in st.queues] == list(targets)
    assert sorted(i for q in st.queues for i in q) == (
        list(range(2, 10)) + list(range(12, 20)))


def test_fails_fast_on_task_error():
    executed = []
    lock = threading.Lock()

    def make(i):
        def task():
            if i == 0:
                raise ValueError("early failure")
            time.sleep(0.01)
            with lock:
                executed.append(i)
            return i
        return task

    farm = ThreadFarmExecutor(num_workers=2)
    with pytest.raises(ValueError, match="early failure"):
        farm.map_callables([make(i) for i in range(40)])
    time.sleep(0.1)                        # let in-flight tasks finish
    assert len(executed) < 10              # queues were drained, not run
    farm.shutdown()


def test_nested_call_runs_serially():
    """A task calling back into its own farm nests serially, without a
    deadlock on the farm's call lock."""
    farm = ThreadFarmExecutor(num_workers=2)

    def outer(i):
        inner, stats = farm.map_callables([lambda j=j: i * 10 + j
                                           for j in range(3)])
        assert stats["num_workers"] == 1
        return inner

    results, _ = farm.map_callables([lambda i=i: outer(i) for i in range(4)])
    assert results == [[i * 10 + j for j in range(3)] for i in range(4)]
    farm.shutdown()


def test_pool_reused_across_calls_and_recreated_after_shutdown():
    farm = ThreadFarmExecutor(num_workers=4)
    farm.map_callables([lambda: 1] * 8)
    pool = farm._pool
    assert farm.map_callables([lambda: 2] * 8)[0] == [2] * 8
    assert farm._pool is pool              # no per-call pool teardown
    farm.shutdown()
    assert farm._pool is None
    assert farm.map_callables([lambda: 3] * 2)[0] == [3, 3]
    assert farm._pool is not None
    farm.shutdown()


def test_empty_single_and_run_not_ported():
    farm = ThreadFarmExecutor(num_workers=4)
    results, stats = farm.map_callables([])
    assert results == [] and stats["num_workers"] == 0
    assert farm.map_callables([lambda: 7])[0] == [7]
    with pytest.raises(NotImplementedError, match="A7"):
        farm.run(lambda: [], lambda: None, lambda o: o)
    farm.shutdown()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_balance_and_partition_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    timings = rng.uniform(0.1, 3.0, size=n)
    work = rng.integers(0, 50, size=n)
    got = lb.find_optimal_workload(timings, work)
    want = jlb.find_optimal_workload(timings, work)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == work.sum()
    assert lb.redistribute_plan(work, got) == jlb.redistribute_plan(work,
                                                                     want)
    length = int(rng.integers(0, 100))
    np.testing.assert_array_equal(part.simple_partitioning(length, n),
                                  jpart.simple_partitioning(length, n))
    np.testing.assert_array_equal(part.partition_offsets(length, n),
                                  jpart.partition_offsets(length, n))
