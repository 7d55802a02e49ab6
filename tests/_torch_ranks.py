"""SPMD bodies that the port's multi-rank tests run on every rank of a gloo
group (``repro_torch.core.comm.run_ranks``).  Spawned ranks import this
module afresh, so it imports torch and the port only, never JAX.

Each rank's inputs come from ``numpy.random.default_rng((SEED, rank))``
(:func:`rank_input`), so the parent test can rebuild every rank's inputs
and hold the collected results against a numpy model."""
import time

import numpy as np
import torch

from repro_torch.apps import boussinesq as bq
from repro_torch.apps import dmc
from repro_torch.core.collect import collect_subproblem_output_args
from repro_torch.core.load_balance import (dynamic_load_balancing,
                                           redistribute_work)
from repro_torch.core.runtime import MeshExecutor
from repro_torch.core.schwarz import halo_exchange

SEED = 20
CAP = 16
BQ = dict(nx=48, ny=48, dt=0.02, eps=0.3, alpha=0.05)
BQ_STEPS = 40                   # tests/test_distributed.py's gate
PARABOLA_M = 15                 # 225 tasks: padded at worlds 2 and 4


def rank_input(rank: int, n: int) -> dict:
    """Rank ``rank``'s inputs in a world of ``n``."""
    rng = np.random.default_rng((SEED, rank))
    return {"x": rng.normal(size=(3, 2 * n, 4)).astype(np.float32),
            "sq": rng.normal(size=(n, 2, 3)).astype(np.float32),
            "field": rng.normal(size=(6, 5)).astype(np.float32),
            "count": int(rng.integers(0, CAP + 1)),
            "skew": (9, 5) + (0,) * (n - 2)}


def parabola_inputs(m: int = PARABOLA_M):
    """The quickstart parabola's float32 inputs (16 points on [0, 10]; the
    (a, b) grid), from numpy, so the JAX package can take the same."""
    vals = np.linspace(-1, 1, m, dtype=np.float32)
    aa, bb = np.meshgrid(vals, vals, indexing="ij")
    return np.linspace(0, 10.0, 16, dtype=np.float32), aa.ravel(), bb.ravel()


def parabola():
    """The parabola as stacked tasks: (initialize, func)."""
    x, a, b = (torch.from_numpy(v) for v in parabola_inputs())
    return ((lambda: {"a": a, "b": b}),
            (lambda t: t["a"] * x ** 2 + t["b"] * x + 5.0))


def collectives(comm) -> dict:
    """Every Comm collective, halo_exchange, redistribute_work,
    dynamic_load_balancing and collect on this rank's inputs."""
    n, r = comm.size(), comm.rank()
    inp = rank_input(r, n)
    x = torch.from_numpy(inp["x"])
    out = {
        "rank": r, "size": n,
        "gather0": comm.all_gather(x),
        "gather1": comm.all_gather(x, axis=1),
        "gather0_tiled": comm.all_gather(x, tiled=True),
        "gather_last_tiled": comm.all_gather(x, axis=-1, tiled=True),
        "sum": comm.all_reduce_sum(x), "max": comm.all_reduce_max(x),
        "min": comm.all_reduce_min(x),
        "a2a_tiled": comm.all_to_all(x, split_axis=1, concat_axis=0),
        "a2a_tiled_same": comm.all_to_all(x, split_axis=1, concat_axis=1),
        "a2a_untiled": comm.all_to_all(torch.from_numpy(inp["sq"]),
                                       split_axis=0, concat_axis=2,
                                       tiled=False),
        "shift1": comm.shift(x), "shift_back": comm.shift(x, -1),
        "permute_partial": comm.permute(x, [(0, n - 1), (n - 1, 0)]),
        "broadcast": comm.broadcast_from(x, root=n - 1),
        "collect": collect_subproblem_output_args({"x": x[:2]}, comm),
    }
    field = torch.from_numpy(inp["field"])
    for periodic in (False, True):
        out[f"halo_{periodic}"] = halo_exchange(field, comm, 2,
                                                periodic=periodic)
    out["halo_axis1"] = halo_exchange(field, comm, 1, axis=1, periodic=True)
    for case in ("count", "skew"):
        c = inp[case] if case == "count" else inp["skew"][r]
        data = torch.where((torch.arange(CAP) < c)[:, None],
                           100.0 * r + torch.arange(CAP, dtype=torch.float32
                                                    )[:, None], 0.0)
        count = torch.tensor(c, dtype=torch.int32)
        out[f"redistribute_{case}"] = redistribute_work(data, count, comm)
        out[f"dlb_{case}"] = dynamic_load_balancing(data, count, comm)
    return out


def mesh_parabola(comm) -> dict:
    """MeshExecutor over ``comm`` on the parabola: a one-argument finalizer
    (trimmed outputs) and a two-argument one (padded outputs, mask)."""
    init, func = parabola()
    seen = {}

    def fin_mask(out, mask):
        seen["padded"], seen["mask"] = out, mask
        return out[mask]

    return {"trimmed": MeshExecutor(comm).run(init, func, lambda o: o),
            "masked": MeshExecutor(comm).run(init, func, fin_mask), **seen}


def science(comm) -> dict:
    """The Schwarz Boussinesq run and a short load-balanced DMC run."""
    p = bq.BoussinesqParams(**BQ)
    eta, phi, hist = bq.run_rank(comm, p, BQ_STEPS, device="cpu")
    walkers = dmc.run_rank(comm, n_walkers=64 * comm.size(), timesteps=60,
                           tau=0.02, seed=1, device="cpu")
    return {"eta": eta, "phi": phi, "iters": hist["iters"],
            "mass": hist["mass"], "dmc": walkers}


def all_checks(comm) -> dict:
    """What the multi-rank tests read, from one spawn of the world."""
    return {"collectives": collectives(comm), "mesh": mesh_parabola(comm),
            "science": science(comm)}


def failing(comm):
    """A rank that fails while the others wait in a collective."""
    if comm.rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    return comm.all_reduce_sum(torch.ones(1))


def hanging_forever(comm):
    """Rank 0 never reaches the collective the others call: they wait."""
    if comm.rank() == 0:
        time.sleep(600)
    return comm.all_reduce_sum(torch.ones(1))
