"""The port's transport (``repro_torch.core.comm``) and the SPMD layer on
it, over gloo at worlds 2 and 4 (each world spawned once for this file,
its store in the test's temporary directory), against numpy models of
the collectives; the Schwarz-parallel Boussinesq against the port's
serial run (the reference's own 1e-5 gate); and ``SerialComm`` and the
one-rank ``Comm`` against the JAX package's."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_ranks as R
from repro.core import comm as jcomm
from repro.core import runtime as jrt
from repro_torch.apps import boussinesq as bq
from repro_torch.core import comm as C

WORLDS = (2, 4)


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request, tmp_path_factory):
    """(n, per-rank results) of one spawn of ``n`` gloo ranks."""
    n = request.param
    store = tmp_path_factory.mktemp(f"store{n}")
    return n, C.run_ranks(R.all_checks, world=n, store_dir=store,
                          device="cpu", timeout=300)


def _inputs(n):
    return [R.rank_input(r, n) for r in range(n)]


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_topology_and_gathers(world):
    n, res = world
    xs = np.stack([i["x"] for i in _inputs(n)])
    for r, out in enumerate(res):
        c = out["collectives"]
        assert (c["rank"], c["size"]) == (r, n)
        np.testing.assert_array_equal(_np(c["gather0"]), xs)
        np.testing.assert_array_equal(_np(c["gather1"]),
                                      np.stack(list(xs), axis=1))
        np.testing.assert_array_equal(_np(c["gather0_tiled"]),
                                      np.concatenate(list(xs), axis=0))
        np.testing.assert_array_equal(_np(c["gather_last_tiled"]),
                                      np.concatenate(list(xs), axis=-1))
        np.testing.assert_array_equal(_np(c["collect"]["x"]),
                                      np.concatenate([x[:2] for x in xs]))


def test_reductions_and_broadcast(world):
    """Sums within float32 rounding of any order (1e-6); max, min and the
    broadcast exact."""
    n, res = world
    xs = np.stack([i["x"] for i in _inputs(n)])
    for out in res:
        c = out["collectives"]
        np.testing.assert_allclose(_np(c["sum"]), xs.sum(0), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(_np(c["max"]), xs.max(0))
        np.testing.assert_array_equal(_np(c["min"]), xs.min(0))
        np.testing.assert_array_equal(_np(c["broadcast"]), xs[n - 1])


def test_all_to_all(world):
    """Tiled: rank r gets chunk r of every rank along the split axis, in
    rank order along the concat axis.  Untiled: the split axis (of the
    world's size) goes, and the chunks stack on a new concat axis — the
    semantics of ``jax.lax.all_to_all``."""
    n, res = world
    xs = [i["x"] for i in _inputs(n)]
    sq = [i["sq"] for i in _inputs(n)]
    for r, out in enumerate(res):
        c = out["collectives"]
        chunks = [np.split(x, n, axis=1)[r] for x in xs]
        np.testing.assert_array_equal(_np(c["a2a_tiled"]),
                                      np.concatenate(chunks, axis=0))
        np.testing.assert_array_equal(_np(c["a2a_tiled_same"]),
                                      np.concatenate(chunks, axis=1))
        np.testing.assert_array_equal(_np(c["a2a_untiled"]),
                                      np.stack([s[r] for s in sq], axis=2))


def test_shift_and_permute(world):
    """ppermute semantics: a rank named by no pair receives zeros."""
    n, res = world
    xs = [i["x"] for i in _inputs(n)]
    for r, out in enumerate(res):
        c = out["collectives"]
        np.testing.assert_array_equal(_np(c["shift1"]), xs[(r - 1) % n])
        np.testing.assert_array_equal(_np(c["shift_back"]), xs[(r + 1) % n])
        want = (xs[n - 1] if r == 0 else xs[0] if r == n - 1
                else np.zeros_like(xs[0]))
        np.testing.assert_array_equal(_np(c["permute_partial"]), want)


def test_halo_exchange(world):
    """Ghost slabs from the ring neighbours; zeros at the non-periodic
    ends."""
    n, res = world
    fs = [i["field"] for i in _inputs(n)]
    z = np.zeros((2, 5), np.float32)
    for r, out in enumerate(res):
        c = out["collectives"]
        left, right = map(_np, c["halo_False"])
        np.testing.assert_array_equal(left, fs[r - 1][-2:] if r else z)
        np.testing.assert_array_equal(right,
                                      fs[r + 1][:2] if r < n - 1 else z)
        left, right = map(_np, c["halo_True"])
        np.testing.assert_array_equal(left, fs[(r - 1) % n][-2:])
        np.testing.assert_array_equal(right, fs[(r + 1) % n][:2])
        left, right = map(_np, c["halo_axis1"])
        np.testing.assert_array_equal(left, fs[(r - 1) % n][:, -1:])
        np.testing.assert_array_equal(right, fs[(r + 1) % n][:, :1])


def _live(data, count):
    return _np(data)[:int(count), 0]


@pytest.mark.parametrize("case", ["count", "skew"])
def test_redistribute_work_keeps_order_and_balances(world, case):
    """Counts ±1 of each other and conserved; the live items in global
    rank-major order; dead slots zero."""
    n, res = world
    counts = ([i["count"] for i in _inputs(n)] if case == "count"
              else list(_inputs(n)[0]["skew"]))
    want = np.concatenate([100.0 * r + np.arange(c)
                           for r, c in enumerate(counts)])
    total = sum(counts)
    want_counts = [total // n + (r < total % n) for r in range(n)]
    got = [out["collectives"][f"redistribute_{case}"] for out in res]
    assert [int(c) for _, c in got] == want_counts
    assert all(c.dtype == torch.int32 for _, c in got)
    np.testing.assert_array_equal(
        np.concatenate([_live(d, c) for d, c in got]), want)
    for d, c in got:
        assert not _np(d)[int(c):].any()


@pytest.mark.parametrize("case", ["count", "skew"])
def test_dynamic_load_balancing_threshold(world, case):
    """Rebalances exactly when max > 1.1 * max(min, 1) (the reference's
    float32 test), and then as redistribute_work does; every rank takes
    the same branch and reports the same counts."""
    n, res = world
    counts = ([i["count"] for i in _inputs(n)] if case == "count"
              else list(_inputs(n)[0]["skew"]))
    need = bool(np.float32(max(counts)) > np.float32(1.1)
                * np.float32(max(min(counts), 1)))
    outs = [out["collectives"][f"dlb_{case}"] for out in res]
    assert [o[3] for o in outs] == [need] * n
    new = [int(o[1]) for o in outs]
    for o in outs:
        np.testing.assert_array_equal(_np(o[2]), new)
    if need:
        red = [out["collectives"][f"redistribute_{case}"] for out in res]
        assert new == [int(c) for _, c in red]
    else:
        assert new == counts
    want = np.concatenate([100.0 * r + np.arange(c)
                           for r, c in enumerate(counts)])
    np.testing.assert_array_equal(
        np.concatenate([_live(o[0], o[1]) for o in outs]), want)


def test_mesh_executor_pads_masks_and_gathers(world):
    """Every rank gets the whole answer in task order, the reference's
    (its MeshExecutor on the one-device mesh, the same inputs; float32
    terms up to 100 where XLA may fuse multiply-adds: rtol 1e-5, atol
    2e-5): 225 tasks padded to a multiple of the world, the mask marking
    the real ones."""
    n, res = world
    x, a, b = (jnp.asarray(v) for v in R.parabola_inputs())
    want = np.asarray(jrt.MeshExecutor(jax.make_mesh((1,), ("data",))).run(
        lambda: {"a": a, "b": b}, lambda t: t["a"] * x ** 2 + t["b"] * x
        + 5.0, lambda o: o))
    for out in res:
        m = out["mesh"]
        np.testing.assert_allclose(_np(m["trimmed"]), want, rtol=1e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(_np(m["masked"]), want, rtol=1e-5,
                                   atol=2e-5)
        padded = -(-len(want) // n) * n
        assert m["padded"].shape[0] == padded
        assert _np(m["mask"]).tolist() == [True] * len(want) + [False] * (
            padded - len(want))


def test_schwarz_boussinesq_matches_serial(world):
    """The reference's gate (tests/test_distributed.py): the Schwarz solve
    over row blocks within 1e-5 of the single-domain solve; the mass the
    same on every rank and conserved."""
    n, res = world
    p = bq.BoussinesqParams(**R.BQ)
    eta_s, phi_s, hist_s = bq.run_serial(p, R.BQ_STEPS, device="cpu")
    for out in res:
        s = out["science"]
        assert float((s["eta"] - eta_s).abs().max()) < 1e-5
        assert float((s["phi"] - phi_s).abs().max()) < 1e-5
        assert all(1 <= it <= p.schwarz_max_iter for it in s["iters"])
        np.testing.assert_array_equal(_np(s["mass"]),
                                      _np(res[0]["science"]["mass"]))
        np.testing.assert_allclose(_np(s["mass"]), _np(hist_s["mass"]),
                                   atol=1e-4)


def test_parallel_dmc_load_balances(world):
    """The SPMD DMC: global counts are the sum of the ranks' live counts,
    the same on every rank; the balancer fires and leaves the ranks within
    the reference's skew bound."""
    n, res = world
    d0 = res[0]["science"]["dmc"]
    for out in res:
        d = out["science"]["dmc"]
        np.testing.assert_array_equal(_np(d["counts"]), _np(d0["counts"]))
        np.testing.assert_array_equal(_np(d["e_trial"]), _np(d0["e_trial"]))
    lc = _np(d0["local_counts"])
    assert lc.shape == (60, n)
    np.testing.assert_array_equal(lc.sum(1), _np(d0["counts"]))
    assert d0["rebalances"] > 0
    assert lc[-1].max() - lc[-1].min() <= max(3, 0.2 * lc[-1].mean())
    assert np.isfinite(_np(d0["e_trial"])).all()


def test_failed_rank_raises_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        C.run_ranks(R.failing, world=2, store_dir=tmp_path, device="cpu",
                    timeout=120)


def test_hung_rank_times_out(tmp_path):
    """A rank that skips a collective leaves the others waiting: the join
    times out and stops them."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        C.run_ranks(R.hanging_forever, world=2, store_dir=tmp_path,
                    device="cpu", timeout=8)
    assert time.monotonic() - t0 < 60


def test_run_ranks_world_one_runs_here_and_cleans_up(tmp_path):
    got = C.run_ranks(R.collectives, world=1, store_dir=tmp_path,
                      device="cpu")
    assert got[0]["size"] == 1 and not torch.distributed.is_initialized()
    assert list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# Against the JAX package: SerialComm, and Comm at world 1
# ---------------------------------------------------------------------------

def _x():
    return np.random.default_rng(5).normal(size=(2, 3, 4)).astype(np.float32)


def test_serial_comm_matches_reference():
    x = _x()
    j, t = jcomm.SerialComm(), C.SerialComm()
    tx = torch.from_numpy(x)
    assert t.rank() == int(j.rank()) and t.size() == j.size() == 1
    for axis in (0, 1, -1):
        for tiled in (False, True):
            np.testing.assert_array_equal(
                t.all_gather(tx, axis=axis, tiled=tiled).numpy(),
                np.asarray(j.all_gather(jnp.asarray(x), axis=axis,
                                        tiled=tiled)))
    for name in ("all_reduce_sum", "all_reduce_max", "all_reduce_min"):
        np.testing.assert_array_equal(getattr(t, name)(tx).numpy(),
                                      np.asarray(getattr(j, name)(x)))
    np.testing.assert_array_equal(
        t.all_to_all(tx, split_axis=1, concat_axis=0).numpy(),
        np.asarray(j.all_to_all(x, split_axis=1, concat_axis=0)))
    np.testing.assert_array_equal(t.shift(tx, 2).numpy(),
                                  np.asarray(j.shift(x, 2)))
    np.testing.assert_array_equal(t.permute(tx, [(0, 1)]).numpy(),
                                  np.asarray(j.permute(x, [(0, 1)])))
    np.testing.assert_array_equal(t.broadcast_from(tx).numpy(),
                                  np.asarray(j.broadcast_from(x)))
    assert isinstance(C.make_comm(None), C.SerialComm)


def test_one_rank_comm_matches_reference_on_one_device():
    """With no process group a Comm is one rank alone, as the reference's
    Comm over a one-device mesh: the gathers insert or keep the axis, the
    permutes leave zeros where no pair sends."""
    x = _x()
    mesh = jax.make_mesh((1,), ("data",))

    def body(x):
        c = jcomm.Comm("data")
        return (c.all_gather(x, axis=1), c.all_gather(x, tiled=True),
                c.all_reduce_sum(x), c.shift(x),
                c.permute(x, [(0, 0)]), c.permute(x, []),
                c.all_to_all(x, split_axis=1, concat_axis=0),
                c.broadcast_from(x))

    want = jax.jit(jcomm.shard_map(body, mesh=mesh, in_specs=P(),
                                   out_specs=P(), check_vma=False))(x)
    c = C.Comm()
    assert (c.rank(), c.size()) == (0, 1)
    tx = torch.from_numpy(x)
    got = (c.all_gather(tx, axis=1), c.all_gather(tx, tiled=True),
           c.all_reduce_sum(tx), c.shift(tx), c.permute(tx, [(0, 0)]),
           c.permute(tx, []), c.all_to_all(tx, split_axis=1, concat_axis=0),
           c.broadcast_from(tx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
