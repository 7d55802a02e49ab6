"""The port's executor runtime (``repro_torch.core.runtime``) against the
reference's (``repro.core.runtime``): the four executors' results on the
quickstart parabola, held against the JAX package's executors on the same
inputs (its ``MeshExecutor`` on the one-device CPU mesh is the reference
for world 1); the paper's contract (host and stacked forms, finalizer
arity and the valid mask, ``make_executor``, ``run_stages``); and the
thread farm's scheduling (task order, work stealing, rebalancing,
straggler re-dispatch with the reference's timing margins, fail-fast,
nesting, pool reuse), with the same partition and rebalance plans on the
same numpy-seeded inputs."""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import load_balance as jlb
from repro.core import partition as jpart
from repro.core import runtime as jrt
from repro_torch.core import (functional, host_task_farm, load_balance as lb,
                              partition as part, vmap_solve_problem)
from repro_torch.core.comm import Comm
from repro_torch.core.runtime import (MeshExecutor, SerialExecutor,
                                      ThreadFarmExecutor, VmapExecutor,
                                      _FarmState, make_executor, run_stages,
                                      straggler_deadline)


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
    """No task and one task; and ``run``, the paper's contract, on the
    host form and the stacked form."""
    farm = ThreadFarmExecutor(num_workers=4)
    results, stats = farm.map_callables([])
    assert results == [] and stats["num_workers"] == 0
    assert stats["stragglers"] == []
    assert farm.map_callables([lambda: 7])[0] == [7]
    assert farm.run(lambda: [((i,), {"k": 3}) for i in range(5)],
                    lambda i, k=1: i * k, list) == [0, 3, 6, 9, 12]
    got = farm.run(lambda: {"a": torch.arange(4.0)}, lambda t: t["a"] * 2,
                   lambda o: o)
    assert torch.equal(got, torch.arange(4.0) * 2)
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


# ---------------------------------------------------------------------------
# The four executors against the JAX package's, on the quickstart parabola
# ---------------------------------------------------------------------------

M, N, L = 16, 24, 10.0
# the same float32 inputs for both packages, from numpy
_X = np.linspace(0, L, N, dtype=np.float32)
_AA, _BB = (v.ravel() for v in np.meshgrid(
    np.linspace(-1, 1, M, dtype=np.float32),
    np.linspace(-1, 1, M, dtype=np.float32), indexing="ij"))


def _port_problem():
    x = torch.from_numpy(_X)
    return ((lambda: {"a": torch.from_numpy(_AA), "b": torch.from_numpy(_BB)}),
            (lambda t: t["a"] * x ** 2 + t["b"] * x + 5.0),
            (lambda out: out.numpy()))


def _jax_problem():
    x = jnp.asarray(_X)
    return ((lambda: {"a": jnp.asarray(_AA), "b": jnp.asarray(_BB)}),
            (lambda t: t["a"] * x ** 2 + t["b"] * x + 5.0),
            (lambda out: np.asarray(out)))


def _port_executors():
    return {"serial": SerialExecutor(), "vmap": VmapExecutor(),
            "mesh": MeshExecutor(), "thread": ThreadFarmExecutor(4)}


def test_all_executors_match_reference_executors():
    """Four executors, one answer, the reference's: each port executor
    against the same JAX executor on the same inputs.  Float32, and XLA
    may contract the polynomial into fused multiply-adds: one rounding of
    terms up to 100 (an ulp there is 7.6e-6) where the value cancels to
    near zero, hence atol 2e-5 beside the reference's rtol 1e-5."""
    mesh = jax.make_mesh((1,), ("data",))
    jexec = {"serial": jrt.SerialExecutor(), "vmap": jrt.VmapExecutor(),
             "mesh": jrt.MeshExecutor(mesh),
             "thread": jrt.ThreadFarmExecutor(num_workers=4)}
    want = {k: ex.run(*_jax_problem()) for k, ex in jexec.items()}
    for name, ex in _port_executors().items():
        got = ex.run(*_port_problem())
        assert got.shape == (M * M, N)
        np.testing.assert_allclose(got, want[name], rtol=1e-5, atol=2e-5,
                                   err_msg=name)
        np.testing.assert_allclose(got, want["serial"], rtol=1e-5,
                                   atol=2e-5, err_msg=name)


def test_host_form_matches_reference():
    """The paper's host form through the serial executor and the farm, and
    the wrappers, against the reference's on the same numpy inputs."""
    x = _X.astype(np.float64)
    vals = np.linspace(-1, 1, M)

    def initialize():
        return [((x,), {"a": a, "b": b, "c": 5.0}) for a in vals
                for b in vals]

    def func(x, a=0.0, b=0.0, c=1.0):
        return a * x ** 2 + b * x + c

    def finalize(out):
        return [i for i, o in enumerate(out) if np.min(o) < 0]

    want = jrt.SerialExecutor().run(initialize, func, finalize)
    assert want
    assert functional.solve_problem(initialize, func, finalize) == want
    assert ThreadFarmExecutor(num_workers=4, deadline_factor=3.0).run(
        initialize, func, finalize) == want


def test_mesh_executor_passes_valid_mask():
    """Two-argument finalize gets padded outputs + the valid-task mask; at
    world 1 nothing pads, as on the reference's one-device mesh."""
    seen = {}

    def finalize(out, mask):
        seen["out"], seen["mask"] = out, mask
        return out[mask].sum()

    got = MeshExecutor().run(lambda: {"a": torch.arange(3.0)},
                             lambda t: 2.0 * t["a"], finalize)
    assert int(seen["mask"].sum()) == 3 and seen["out"].shape[0] == 3
    assert float(got) == pytest.approx(6.0)
    got = functional.parallel_solve_problem(
        lambda: {"a": torch.arange(3.0)}, lambda t: 2.0 * t["a"],
        lambda o: o)
    assert torch.equal(got, torch.tensor([0.0, 2.0, 4.0]))


def test_finalize_arity_defaulted_params_stay_one_arg():
    """A defaulted second parameter (or *args) must NOT receive the mask."""
    def init():
        return {"a": torch.arange(4.0)}

    got = VmapExecutor().run(init, lambda t: t["a"] * 2, torch.mean)
    assert float(got) == pytest.approx(3.0)
    seen = {}

    def fin_defaulted(out, verbose=False):
        seen["verbose"] = verbose
        return out

    SerialExecutor().run(init, lambda t: t["a"], fin_defaulted)
    assert seen["verbose"] is False

    def fin_varargs(*outs):
        return outs

    assert len(SerialExecutor().run(init, lambda t: t["a"], fin_varargs)) == 1


def test_executors_accept_generator_host_tasks():
    def initialize():
        return (((i,), {}) for i in range(4))

    assert SerialExecutor().run(initialize, lambda i: i * 3, list) == [
        0, 3, 6, 9]
    assert ThreadFarmExecutor(num_workers=2).run(
        initialize, lambda i: i * 3, list) == [0, 3, 6, 9]


def test_stacked_executors_refuse_host_tasks():
    for ex in (VmapExecutor(), MeshExecutor()):
        with pytest.raises(TypeError, match="stacked"):
            ex.run(lambda: [((1,), {})], lambda i: i, list)


def test_vmap_refuses_hidden_generator_state():
    """``randomness="error"``: a task may not draw from torch's generator
    inside the vmap; it takes an explicit key."""
    with pytest.raises(RuntimeError):
        VmapExecutor().run(lambda: {"a": torch.zeros(3)},
                           lambda t: t["a"] + torch.rand(()), lambda o: o)


def test_vmap_executor_accepts_tuple_pytree_tasks():
    def initialize():
        return (torch.arange(4.0), torch.arange(4.0) * 10)

    for got in (vmap_solve_problem(initialize, lambda t: t[0] + t[1],
                                   lambda o: o),
                SerialExecutor().run(initialize, lambda t: t[0] + t[1],
                                     lambda o: o)):
        assert torch.equal(got, torch.tensor([0.0, 11.0, 22.0, 33.0]))


def test_no_copy_finalize_when_unpadded():
    seen = {}

    def finalize(out):
        seen["out"] = out
        return out

    got = VmapExecutor().run(lambda: {"a": torch.arange(4.0)},
                             lambda t: t["a"] * 2, finalize)
    assert got is seen["out"]


def test_make_executor_specs():
    assert isinstance(make_executor("serial"), SerialExecutor)
    assert isinstance(make_executor("vmap"), VmapExecutor)
    assert isinstance(make_executor("thread", num_workers=2),
                      ThreadFarmExecutor)
    m = make_executor("mesh", comm=Comm())
    assert isinstance(m, MeshExecutor) and m.comm.size() == 1
    ex = SerialExecutor()
    assert make_executor(ex) is ex
    with pytest.raises(ValueError, match="unknown executor"):
        make_executor("bogus")


def test_make_executor_rejects_options_with_instance():
    with pytest.raises(ValueError, match="configure the instance"):
        make_executor(ThreadFarmExecutor(), num_workers=8)
    with pytest.raises(ValueError, match="configure the instance"):
        make_executor(SerialExecutor(), comm=Comm())


def test_run_stages_serial_and_farm():
    order = []

    def stage(i, busy):
        def run():
            order.append(i)
            return busy
        return run

    assert run_stages(SerialExecutor(), [stage(0, 0), stage(1, 1)]) is True
    assert order == [0, 1]
    assert run_stages(ThreadFarmExecutor(2), [stage(2, 0), stage(3, 0)]) \
        is False
    with pytest.raises(TypeError):
        run_stages(VmapExecutor(), [stage(4, 1)])


# ---------------------------------------------------------------------------
# The farm: the reference's scheduling checks, with its timing margins
# ---------------------------------------------------------------------------

def test_farm_overlaps_gil_releasing_tasks():
    farm = ThreadFarmExecutor(num_workers=8)
    t0 = time.perf_counter()
    results, stats = farm.map_callables(
        [lambda i=i: (time.sleep(0.05), i)[1] for i in range(8)])
    assert results == list(range(8))
    assert time.perf_counter() - t0 < 0.25  # serial would be >= 0.4s
    assert stats["num_workers"] == 8


def test_farm_timings_indexed_by_task():
    delays = [0.0, 0.06, 0.0, 0.03]
    _, stats = ThreadFarmExecutor(num_workers=4).map_callables(
        [lambda i=i: time.sleep(delays[i]) for i in range(4)])
    t = stats["timings"]
    assert t[1] > 0.05 and t[3] > 0.02 and t[0] < 0.02 and t[2] < 0.02


def test_farm_switches_steal_and_rebalance():
    """``steal=False`` leaves every task on its seeded worker; with
    ``rebalance`` on and stealing off, queued work moves by measured
    speed (the reference's checks of both switches)."""
    _, stats = ThreadFarmExecutor(num_workers=2, steal=False,
                                  rebalance=False).map_callables(
        [lambda i=i: (time.sleep(0.01 if i < 4 else 0.0), i)[1]
         for i in range(8)])
    assert stats["steals"] == 0 and stats["worker_tasks"] == [4, 4]
    farm = ThreadFarmExecutor(num_workers=2, steal=False, rebalance=True)
    results, stats = farm.map_callables(
        [lambda i=i: (time.sleep(0.01 if i < 10 else 0.0), i)[1]
         for i in range(20)])
    assert results == list(range(20))
    assert stats["rebalances"] >= 1 and stats["steals"] == 0


def test_farm_straggler_redispatch_first_completion_wins():
    calls = []
    lock = threading.Lock()

    def flaky():
        with lock:
            calls.append(time.perf_counter())
            first = len(calls) == 1
        if first:
            time.sleep(0.3)               # first attempt straggles
            return "late"
        return "fast"                     # backup attempt returns instantly

    farm = ThreadFarmExecutor(num_workers=4, deadline_factor=2.0,
                              min_straggler_s=0.02)
    results, stats = farm.map_callables([lambda: "ok"] * 6 + [flaky])
    assert results[:6] == ["ok"] * 6
    assert results[6] == "fast"           # backup finished first and won
    assert stats["stragglers"] == [6]
    assert len(calls) == 2                # re-issued exactly once


def test_farm_single_worker_straggler_inline_redo():
    calls = {"n": 0}

    def slow():
        calls["n"] += 1
        time.sleep(0.05 if calls["n"] == 1 else 0.0)
        return 42

    farm = ThreadFarmExecutor(num_workers=1, deadline_factor=3.0)
    results, stats = farm.map_callables([lambda: 1] * 6 + [slow])
    assert results == [1] * 6 + [42]
    assert stats["stragglers"] == [6]
    assert calls["n"] == 2


def test_farm_single_worker_failed_redo_keeps_original_result():
    calls = {"n": 0}

    def slow_then_broken():
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.05)
            return 42
        raise RuntimeError("redo exploded")

    farm = ThreadFarmExecutor(num_workers=1, deadline_factor=3.0)
    results, stats = farm.map_callables([lambda: 1] * 6 + [slow_then_broken])
    assert results[6] == 42                # original result preserved
    assert stats["stragglers"] == [6]
    assert calls["n"] == 2


def test_farm_failing_backup_does_not_discard_running_original():
    calls = {"n": 0}
    lock = threading.Lock()

    def slow_original_broken_backup():
        with lock:
            calls["n"] += 1
            first = calls["n"] == 1
        if first:
            time.sleep(0.3)                # slow but healthy
            return "late"
        raise RuntimeError("backup hit non-idempotent state")

    farm = ThreadFarmExecutor(num_workers=4, deadline_factor=2.0,
                              min_straggler_s=0.02)
    results, stats = farm.map_callables([lambda: "ok"] * 5
                                        + [slow_original_broken_backup])
    assert results[5] == "late"
    assert stats["stragglers"] == [5]
    assert calls["n"] == 2


def test_farm_backup_completion_unblocks_hung_original():
    release = threading.Event()
    calls = []
    lock = threading.Lock()

    def hung_once():
        with lock:
            calls.append(1)
            first = len(calls) == 1
        if first:
            release.wait(10.0)            # simulates deadlocked I/O
            return "late"
        return "fast"

    farm = ThreadFarmExecutor(num_workers=4, deadline_factor=2.0,
                              min_straggler_s=0.02)
    t0 = time.perf_counter()
    results, stats = farm.map_callables([lambda: "ok"] * 5 + [hung_once])
    wall = time.perf_counter() - t0
    release.set()                         # free the stuck worker thread
    assert results[5] == "fast"
    assert stats["stragglers"] == [5]
    assert wall < 5.0                     # returned long before the 10s hang


def test_farm_nested_call_with_deadline_redoes_serially():
    """A nested call runs serially and keeps the serial post-hoc redo (one
    worker: the outer task runs first, with no timings to breach)."""
    farm = ThreadFarmExecutor(num_workers=1, deadline_factor=3.0)
    calls = {"n": 0}

    def slow_once():
        calls["n"] += 1
        time.sleep(0.05 if calls["n"] == 1 else 0.0)
        return 9

    def outer():
        inner, stats = farm.map_callables([lambda: 10] * 4 + [slow_once])
        assert stats["num_workers"] == 1 and stats["stragglers"] == [4]
        return sum(inner)

    results, _ = farm.map_callables([outer, lambda: 1])
    assert results == [49, 1] and calls["n"] == 2


def test_nested_host_task_farm_same_config():
    def outer():
        r, _ = host_task_farm([lambda: 5, lambda: 6], deadline_factor=3.0)
        return sum(r)

    results, _ = host_task_farm([outer] * 3, deadline_factor=3.0)
    assert results == [11, 11, 11]


def test_host_task_farm_concurrent_same_config_independent():
    done_b = []

    def run_a():
        host_task_farm([lambda: time.sleep(0.1)] * 4, num_workers=2)

    def run_b():
        host_task_farm([lambda: 0] * 4, num_workers=2)
        done_b.append(time.perf_counter())

    t0 = time.perf_counter()
    a = threading.Thread(target=run_a)
    a.start()
    time.sleep(0.02)
    b = threading.Thread(target=run_b)
    b.start()
    b.join(10)
    assert done_b and done_b[0] - t0 < 0.15
    a.join(10)
    assert not a.is_alive()


def test_farm_base_exception_does_not_deadlock():
    farm = ThreadFarmExecutor(num_workers=2)
    with pytest.raises(SystemExit):
        farm.map_callables([lambda: 1, lambda: sys.exit(1), lambda: 2])
    assert farm.map_callables([lambda: 3])[0] == [3]


def test_farm_worker_crash_frees_idle_workers():
    farm = ThreadFarmExecutor(num_workers=4)

    def broken_rebalance(st):
        raise RuntimeError("internal farm bug")

    farm._maybe_rebalance = broken_rebalance
    with pytest.raises(RuntimeError, match="internal farm bug"):
        farm.map_callables([lambda: 1] * 8)
    del farm._maybe_rebalance              # restore the real method
    assert farm.map_callables([lambda: 2] * 8)[0] == [2] * 8


def test_straggler_deadline_rule():
    for timings, factor, floor in (([1.0, 1.0, 1.0], 3.0, 0.0),
                                   ([1e-6] * 5, 3.0, 0.01),
                                   ([1.0, 2.0], 2.0, 0.0),
                                   ([], 3.0, 0.5)):
        assert straggler_deadline(timings, factor, floor) == \
            jrt.straggler_deadline(timings, factor, floor)
    assert straggler_deadline([1.0, 2.0], 2.0) == 4.0


def test_partition_helpers_match_reference():
    rng = np.random.default_rng(9)
    for _ in range(5):
        n, procs = int(rng.integers(0, 60)), int(rng.integers(1, 9))
        items = list(range(n))
        for r in range(procs):
            assert part.get_subproblem_input_args(items, r, procs) == \
                jpart.get_subproblem_input_args(items, r, procs)
        assert part.pad_to_multiple(n, procs) == jpart.pad_to_multiple(
            n, procs)
    tree = {"a": rng.normal(size=(5, 2)).astype(np.float32)}
    got, mask = part.pad_leading({"a": torch.from_numpy(tree["a"])}, 8)
    want, jmask = jpart.pad_leading(tree, 8)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert torch.equal(part.shard_tasks(got, 1, 4)["a"], got["a"][2:4])
    with pytest.raises(ValueError):
        part.shard_tasks(got, 0, 3)
    bal = lb.balanced_counts(torch.tensor(14), 4)
    assert bal.dtype == torch.int32
    np.testing.assert_array_equal(bal.numpy(), np.asarray(
        jlb.balanced_counts(jnp.asarray(14), 4)))
