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


def moe_inputs(arch: str = "qwen3-moe-235b-a22b", tokens: int = 37):
    """A SMOKE MoE block's float32 inputs from numpy: (x (T, d), the
    block's params {router, gate, up, down} with all E experts).  Column 0
    of x is 1 and the router's row 0 pins experts E-1 and E-2 at logit
    -100, so they never route: an expert placement may evict them.  The
    MoE bodies import the model stack where they run, so the ranks of the
    other bodies start without it."""
    from repro_torch.configs import smoke_config
    cfg = smoke_config(arch)
    E, d, eff = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    rng = np.random.default_rng((SEED, tokens))
    x = rng.normal(size=(tokens, d)).astype(np.float32)
    x[:, 0] = 1.0
    wr = (0.2 * rng.normal(size=(d, E))).astype(np.float32)
    wr[:, E - 2:] = 0.0
    wr[0, E - 2:] = -100.0
    w = {"router": wr}
    for name, shape in (("gate", (E, d, eff)), ("up", (E, d, eff)),
                        ("down", (E, eff, d))):
        w[name] = (0.1 * rng.normal(size=shape)).astype(np.float32)
    return cfg, x, w


def moe_plan(cfg, x, w, ep: int):
    """The placement plan of ``ep`` ranks for the serial block's own
    per-expert counts on these inputs."""
    from repro_torch.core.comm import SerialComm
    from repro_torch.models import moe as M
    from repro_torch.serve import placement as PL
    params = {k: torch.from_numpy(v) for k, v in w.items()}
    _, _, stats = M.moe_apply_expert_parallel(params, torch.from_numpy(x),
                                              cfg, SerialComm())
    return PL.plan_placement(stats["tokens"].numpy(), ep)


def placed_block(w, plan):
    """The block's params permuted into ``plan``'s physical slots (router
    untouched) and its (3, E) dispatch map; the identity layout for None."""
    from repro_torch.serve import placement as PL
    params = {k: torch.from_numpy(v) for k, v in w.items()}
    if plan is None:
        return params, None
    stacked = PL.apply_placement(
        {"blocks": {"moe": {k: v[None] for k, v in params.items()}}}, plan)
    return ({k: v[0] for k, v in stacked["blocks"]["moe"].items()},
            torch.from_numpy(plan.dispatch_arrays()))


def moe_expert_parallel(comm) -> dict:
    """``moe_apply_expert_parallel`` with this rank's E/ep experts, unplaced
    and under the plan of the world's size: y, aux and the telemetry."""
    from repro_torch.models import moe as M
    n, r = comm.size(), comm.rank()
    cfg, x, w = moe_inputs()
    out = {}
    for label, plan in (("unplaced", None),
                        ("placed", moe_plan(cfg, x, w, n))):
        params, placement = placed_block(w, plan)
        e_loc = cfg.n_experts // n
        local = {k: (v if k == "router" else v[r * e_loc:(r + 1) * e_loc])
                 for k, v in params.items()}
        y, aux, stats = M.moe_apply_expert_parallel(
            local, torch.from_numpy(x)[None], cfg, comm, placement=placement)
        out[label] = {"y": y[0], "aux": aux, **stats}
    return out


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
