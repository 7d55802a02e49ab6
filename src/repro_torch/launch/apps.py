"""The paper's examples on the port: the §2 parabola through the four
executors and the three §4 applications.

    PYTHONPATH=src python -m repro_torch.launch.apps quickstart
    PYTHONPATH=src python -m repro_torch.launch.apps mcmc [--executor vmap]
    PYTHONPATH=src python -m repro_torch.launch.apps dmc [--executor serial]
    PYTHONPATH=src python -m repro_torch.launch.apps boussinesq

Counterpart of ``examples/quickstart.py``, ``mcmc_voting.py``,
``dmc_walkers.py`` and ``boussinesq_waves.py``, at their sizes by
default.  Runs on the card unless ``--device cpu``.  ``quickstart``
asserts that the four executors agree; ``mcmc`` prints the recovery of
the true ideal points and the R-hat; ``dmc`` runs the serial driver
(``--executor serial``), independent replicas on the thread farm
(``thread``) or the load-balanced SPMD driver over ``--world`` ranks
(``mesh``); ``boussinesq`` runs the serial solve, and with ``--executor
mesh`` also the Schwarz solve over ``--world`` ranks, and asserts that
the two agree.  The SPMD drivers' process group meets in ``--store-dir``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.apps import boussinesq as bq
from repro_torch.apps import dmc, mcmc
from repro_torch.core import (MeshExecutor, SerialExecutor,
                              ThreadFarmExecutor, VmapExecutor, solve_problem)
from repro_torch.models.module import resolve_device
from repro_torch.serve import prng

M, N, L = 32, 50, 10.0          # examples/quickstart.py's parabola


class Parabola:
    """The paper's §2 user class in its host form: one (a, b) pair a task."""

    def __init__(self, m: int = M):
        self.m = m

    def initialize(self):
        x = np.linspace(0, L, N)
        vals = np.linspace(-1, 1, self.m)
        self.input_args = [((x,), {"a": a, "b": b, "c": 5.0})
                           for a in vals for b in vals]
        return self.input_args

    def func(self, x, a=0.0, b=0.0, c=1.0):
        return a * x ** 2 + b * x + c

    def finalize(self, output):
        return [(args[1]["a"], args[1]["b"])
                for args, out in zip(self.input_args, output)
                if np.min(out) < 0]


def parabola_stacked(device, m: int = M):
    """The same problem as stacked-tensor tasks: (initialize, func)."""
    x = torch.linspace(0, L, N, device=device)
    vals = torch.linspace(-1, 1, m, device=device)
    aa, bb = torch.meshgrid(vals, vals, indexing="ij")
    return ((lambda: {"a": aa.ravel(), "b": bb.ravel()}),
            (lambda task: task["a"] * x ** 2 + task["b"] * x + 5.0))


def quickstart(device, comm=None, *, workers: int = 8,
               deadline_factor: float = 3.0) -> dict:
    """The parabola through the paper's serial host loop and the four
    executors (the mesh one over ``comm``).  Returns each executor's
    outputs, the count of combinations that go negative (the host loop's
    too) and the farm's stats; raises if a count differs, or if an
    executor's outputs leave the serial executor's by more than float32
    rounding of terms up to 100 (1e-5)."""
    p = Parabola()
    counts = {"host": len(solve_problem(p.initialize, p.func, p.finalize))}
    farm = ThreadFarmExecutor(num_workers=workers,
                              deadline_factor=deadline_factor)
    init, func = parabola_stacked(device)
    outs = {}
    for name, ex in (("serial", SerialExecutor()), ("vmap", VmapExecutor()),
                     ("mesh", MeshExecutor(comm)), ("thread", farm)):
        outs[name] = ex.run(init, func, lambda out: out)
        counts[name] = int((outs[name].min(dim=-1).values < 0).sum())
    # the farm's own statistics: the same tasks as zero-arg callables
    tasks = init()
    _, stats = farm.map_callables(
        [lambda i=i: func({k: v[i] for k, v in tasks.items()})
         for i in range(M * M)])
    farm.shutdown()
    gap = max(float((o - outs["serial"]).abs().max()) for o in outs.values())
    if len(set(counts.values())) != 1 or not gap <= 1e-5:
        raise AssertionError(f"the executors disagree: counts {counts}, "
                             f"largest gap to serial {gap}")
    return {"counts": counts, "outputs": outs, "gap": gap,
            "farm": {k: stats[k] for k in ("steals", "rebalances",
                                           "stragglers", "num_workers")}}


def parse_args(argv=None):
    """The launcher's command line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("app", choices=("quickstart", "mcmc", "dmc",
                                    "boussinesq"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--executor", default=None,
                    help="mcmc: serial|vmap|mesh|thread (vmap); dmc: "
                    "serial|thread|mesh (serial); boussinesq: serial|mesh "
                    "(serial)")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--world", type=int, default=1,
                    help="ranks of the SPMD drivers (dmc, boussinesq mesh)")
    ap.add_argument("--store-dir", default="build/ranks",
                    help="where the SPMD drivers' process group meets")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--n-leg", type=int, default=80)
    ap.add_argument("--n-votes", type=int, default=200)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--burn", type=int, default=100)
    ap.add_argument("--walkers", type=int, default=400)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--tau", type=float, default=0.02)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=64)
    return ap.parse_args(argv)


def run_mcmc(args, dev):
    seed = 7 if args.seed is None else args.seed
    y, truth = mcmc.make_synthetic_votes(prng.PRNGKey(seed), args.n_leg,
                                         args.n_votes, device=dev)
    problem = mcmc.IdealPointProblem(y, n_chains=args.chains,
                                     n_iter=args.iters, burn=args.burn)
    res = mcmc.solve(problem, args.executor or "vmap")
    corr = np.corrcoef(res["x_mean"].cpu().numpy(),
                       truth["x"].cpu().numpy())[0, 1]
    rhat = res["rhat"].cpu().numpy()
    print(f"[apps] mcmc: {args.n_leg} members, {args.n_votes} votes, "
          f"{args.chains} chains x {args.iters} iterations on {dev}: "
          f"|corr(estimated, true)| {abs(corr):.3f}, R-hat median "
          f"{np.median(rhat):.3f} max {rhat.max():.3f}")


def run_dmc(args, dev):
    seed = 0 if args.seed is None else args.seed
    ex = args.executor or "serial"
    if ex == "serial":
        out = dmc.run_serial(args.walkers, args.steps or 500, tau=args.tau,
                             seed=seed, device=dev)
        extra = f"final population {int(out['counts'][-1])}"
    elif ex == "thread":
        out = dmc.run_replicas(args.replicas, "thread", args.walkers,
                               args.steps or 300, tau=args.tau, seed=seed,
                               device=dev, num_workers=args.replicas)
        extra = (f"{args.replicas} replicas, spread "
                 f"{float(out['e0_std']):.4f}")
    elif ex == "mesh":
        out = dmc.run_parallel(128 * args.world, args.steps or 400,
                               world=args.world, store_dir=args.store_dir,
                               tau=args.tau, seed=seed, device=dev)
        lc = out["local_counts"][-1].numpy()
        extra = (f"{args.world} rank(s), load balancer fired "
                 f"{out['rebalances']} times, final counts {lc}")
    else:
        raise SystemExit(f"dmc takes --executor serial|thread|mesh, not {ex}")
    print(f"[apps] dmc ({ex}) on {dev}: E0 estimate "
          f"{float(out['e0_estimate']):.4f} (exact 1.5); {extra}")


def run_boussinesq(args, dev):
    p = bq.BoussinesqParams(nx=args.nx, ny=args.ny, dt=0.02, eps=0.3,
                            alpha=0.05)
    steps = args.steps or 60
    eta_s, _, hist_s = bq.run_serial(p, steps, device=dev)
    drift = abs(float(hist_s["mass"][-1] - hist_s["mass"][0]))
    print(f"[apps] boussinesq serial {p.nx}x{p.ny}, {steps} steps on {dev}: "
          f"mass drift {drift:.2e}, mean Jacobi iterations a step "
          f"{np.mean(hist_s['iters']):.1f}")
    if (args.executor or "serial") == "mesh":
        eta_p, _, hist_p = bq.run_parallel(p, steps, world=args.world,
                                           store_dir=args.store_dir,
                                           device=dev)
        err = float((eta_s.cpu() - eta_p).abs().max())
        print(f"[apps] boussinesq Schwarz over {args.world} rank(s): max "
              f"|eta_serial - eta_schwarz| {err:.2e}, mean Schwarz "
              f"iterations a step {np.mean(hist_p['iters']):.1f}")
        if not err < 1e-4:
            raise AssertionError(f"serial and Schwarz differ by {err}")


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if args.app == "quickstart":
        out = quickstart(dev, workers=args.workers)
        c = out["counts"]
        print(f"[apps] quickstart on {dev}: {c['host']} of {M * M} (a, b) "
              f"combinations go negative; serial, vmap, mesh and thread "
              f"agree ({c}); farm {out['farm']}")
    else:
        {"mcmc": run_mcmc, "dmc": run_dmc,
         "boussinesq": run_boussinesq}[args.app](args, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
