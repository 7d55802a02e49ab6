"""Diffusion Monte Carlo (paper §4.2 / Appendix B) — the dynamic-population
application with load balancing.

Counterpart of ``repro.apps.dmc``.  Physics: N non-interacting bosons in a
3D harmonic trap, H = -(1/2)∇² + (1/2) r² (ħ=m=ω=1).  Ground state energy
E0 = 3/2 per particle — the assertion target of the tests.

Walkers diffuse with step N(0, sqrt(tau)) (D = 1/2) and branch with

    G_B = exp(-((V(R) + V(R'))/2 - E_T) tau),   marker = floor(G_B + u)

The population lives in a fixed-capacity tensor with a live ``count``;
delete/clone (the paper's ``delete``/``append``) are one prefix-sum
*compaction* (``torch.searchsorted`` over the markers' running sum).  E_T
population control is the paper's ``finalize_timestep``.  Every draw comes
from an explicit threefry key (:mod:`repro_torch.serve.prng`) along the
reference's key path.

Three drivers:
* :func:`run_serial` — the paper's ``time_integration`` with a Walkers class.
* :func:`run_replicas` — independent serial runs on a host executor.
* :func:`run_parallel` — the SPMD step (:func:`make_parallel_step`) on the
  ranks of a process group: each rank owns a sub-population and
  :func:`repro_torch.core.load_balance.dynamic_load_balancing` re-balances
  the ranks like the paper's ``redistribute_work`` moved walkers between
  MPI ranks.
"""
from __future__ import annotations

import torch

from repro_torch.core.comm import run_ranks
from repro_torch.core.load_balance import dynamic_load_balancing
from repro_torch.core.runtime import Executor, make_executor
from repro_torch.core.time_integration import time_integration
from repro_torch.models.module import resolve_device
from repro_torch.serve import prng

_F32 = torch.float32


def potential(pos):
    """V(r) = r^2 / 2 per walker.  pos: (cap, 3)."""
    return 0.5 * torch.sum(pos * pos, dim=-1)


# ---------------------------------------------------------------------------
# Pure-tensor population step (shared by serial class and SPMD step)
# ---------------------------------------------------------------------------

def walker_step(key, pos, count, e_trial, *, tau: float, max_clone: int = 2):
    """One DMC step on a fixed-capacity population.

    pos: (cap, 3); count: live prefix length (int32 tensor); e_trial:
    current E_T (float32 tensor); ``key``: a host or tensor key.
    Returns (new_pos, new_count, obs) with obs = dict of estimators.
    """
    cap = pos.shape[0]
    dev = pos.device
    k_move, k_branch = prng.split(key)
    alive = torch.arange(cap, device=dev) < count

    # -- diffusion ----------------------------------------------------------
    xi = prng.normal(k_move, pos.shape, device=dev) * torch.sqrt(
        torch.full((), tau, dtype=_F32, device=dev))
    new_pos = pos + xi
    v_old = potential(pos)
    v_new = potential(new_pos)

    # -- branching ----------------------------------------------------------
    gb = torch.exp(-((v_old + v_new) / 2.0 - e_trial) * tau)
    u = prng.uniform(k_branch, (cap,), device=dev)
    marker = torch.floor(gb + u).to(torch.int32)
    marker = torch.clamp(marker, 0, max_clone)
    marker = torch.where(alive, marker, 0)

    # -- compaction (delete + clone in one gather) ---------------------------
    # new slot s takes the walker r(s) with offsets[r] <= s < offsets[r+1]
    offsets = torch.cat([marker.new_zeros(1),
                         torch.cumsum(marker, 0, dtype=torch.int32)])
    new_count = torch.clamp(offsets[-1], max=cap)
    s = torch.arange(cap, dtype=torch.int32, device=dev)
    r = (torch.searchsorted(offsets, s, right=True) - 1).clamp(0, cap - 1)
    valid = s < new_count
    out_pos = torch.where(valid[:, None], new_pos[r], 0.0)

    # -- observables ---------------------------------------------------------
    w = torch.where(alive, 1.0, 0.0)
    pot_mean = torch.sum(v_new * w) / torch.clamp(count, min=1)
    obs = {"pot": pot_mean, "count_before": count, "count_after": new_count}
    return out_pos, new_count.to(torch.int32), obs


def adjust_e_trial(e_trial, old_count, new_count, target, *, tau: float,
                   kappa: float = 0.1):
    """Population control (paper's ``finalize_timestep``): growth estimator
    plus a weak pull towards the target population.  Counts are ints or
    int tensors; the arithmetic is float32 on ``e_trial``'s device."""
    dev = e_trial.device
    new = torch.clamp(torch.as_tensor(new_count, device=dev), min=1).to(_F32)
    old = torch.clamp(torch.as_tensor(old_count, device=dev), min=1)
    growth = -torch.log(new / old) / tau
    pull = kappa * torch.log(target / new)
    return e_trial + tau * growth + pull


# ---------------------------------------------------------------------------
# Paper-faithful serial driver (class Walkers + time_integration)
# ---------------------------------------------------------------------------

class Walkers:
    """The paper's Walkers contract: __len__, move, get_marker, append/delete
    (fused into the compaction), sample_observables, finalize_timestep.
    The key stays on the host; the walkers live on ``device``."""

    def __init__(self, n: int, capacity: int, *, tau: float = 0.01, seed=0,
                 device=None):
        dev = resolve_device(device)
        self.capacity = capacity
        self.tau = tau
        self.target = n
        self.key, k0 = prng.split(prng.PRNGKey(seed))
        pos = prng.normal(k0, (capacity, 3), device=dev)
        self.pos = torch.where((torch.arange(capacity, device=dev)
                                < n)[:, None], pos, 0.0)
        self.count = torch.tensor(n, dtype=torch.int32, device=dev)
        self.e_trial = torch.tensor(1.5, dtype=_F32, device=dev)
        self._last_obs = None

    def __len__(self):
        return int(self.count)

    def move(self):
        self.key, k = prng.split(self.key)
        self.pos, self.count, self._last_obs = walker_step(
            k, self.pos, self.count, self.e_trial, tau=self.tau)

    def sample_observables(self):
        return {"e_trial": self.e_trial, **self._last_obs}

    def finalize_timestep(self, old_size, new_size):
        self.e_trial = adjust_e_trial(self.e_trial, old_size, new_size,
                                      self.target, tau=self.tau)


def run_serial(n_walkers: int = 500, timesteps: int = 400, *,
               capacity: int | None = None, tau: float = 0.01, seed: int = 0,
               device=None):
    """Paper §3.2 serial loop, verbatim structure (two host reads of the
    count a step: ``len(walkers)`` before and after the move)."""
    capacity = capacity or 4 * n_walkers

    def initialize():
        return Walkers(n_walkers, capacity, tau=tau, seed=seed,
                       device=device), timesteps

    def do_timestep(walkers):
        walkers.move()
        return walkers.sample_observables()

    def finalize(output):
        e = torch.stack([o["e_trial"] for o in output])
        counts = torch.stack([o["count_after"] for o in output])
        return {"e_trial": e, "counts": counts,
                "e0_estimate": e[len(e) // 2:].mean()}

    return time_integration(initialize, do_timestep, finalize)


def run_replicas(n_replicas: int = 4, executor: Executor | str = "thread",
                 n_walkers: int = 300, timesteps: int = 300, *,
                 tau: float = 0.02, seed: int = 0, device=None,
                 **executor_kwargs):
    """Independent-replica DMC through the function-centric runtime.

    Each replica is one full serial DMC run with its own seed — a
    heavyweight *host* task, the paper's original task-farm scope, so the
    executor must be a host tier (``serial`` or ``thread``); the thread
    farm overlaps replicas because device launches release the GIL.
    ``finalize`` averages the per-replica energies and reports their spread
    (the standard independent-population error bar).
    """
    executor = make_executor(executor, **executor_kwargs)
    dev = resolve_device(device)

    def initialize():
        return [((), {"n_walkers": n_walkers, "timesteps": timesteps,
                      "tau": tau, "seed": seed + i, "device": dev})
                for i in range(n_replicas)]

    def finalize(outputs):
        e0s = torch.stack([o["e0_estimate"] for o in outputs])
        return {"e0_estimate": e0s.mean(), "e0_std": e0s.std(correction=0),
                "replicas": outputs}

    return executor.run(initialize, run_serial, finalize)


# ---------------------------------------------------------------------------
# SPMD step with dynamic load balancing
# ---------------------------------------------------------------------------

def make_parallel_step(comm, *, tau: float = 0.01, target: int,
                       threshold_factor: float = 1.1):
    """Returns ``step(carry) -> (carry, obs)`` for one rank of ``comm``.

    carry = (key, pos, count, e_trial); each rank owns its slice and holds
    the same tensor key.  After the local move/branch, counts are
    rebalanced across the ranks when skew exceeds ``threshold_factor`` —
    the paper's dynamic_load_balancing.
    """
    def step(carry):
        key, pos, count, e_trial = carry
        key, k = prng.split(key)
        k = prng.fold_in(k, comm.rank())
        pos, count, obs = walker_step(k, pos, count, e_trial, tau=tau)

        pos, count, counts_all, rebalanced = dynamic_load_balancing(
            pos, count, comm, threshold_factor=threshold_factor)

        old_total = comm.all_reduce_sum(obs["count_before"])
        new_total = counts_all.sum(dtype=torch.int32)
        e_trial = adjust_e_trial(e_trial, old_total, new_total, target,
                                 tau=tau)
        pot_global = comm.all_reduce_sum(
            obs["pot"] * obs["count_before"]) / torch.clamp(old_total, min=1)
        obs = {"e_trial": e_trial, "count_after": new_total,
               "pot": pot_global, "rebalanced": rebalanced,
               "local_count": count}
        return (key, pos, count, e_trial), obs

    return step


def run_rank(comm, n_walkers: int = 512, timesteps: int = 200, *,
             capacity_factor: int = 4, tau: float = 0.01, seed: int = 0,
             device=None):
    """One rank of the SPMD DMC: its share of the population, load-balanced
    every step.  Returns the global observables (the same on every rank)
    and every rank's live count at each step, (T, world)."""
    dev = resolve_device(device)
    n = comm.size()
    cap_local = capacity_factor * n_walkers // n
    n_local = n_walkers // n
    step = make_parallel_step(comm, tau=tau, target=n_walkers)
    key = prng.PRNGKey(seed, device=dev)
    pos = prng.normal(prng.fold_in(key, comm.rank()), (cap_local, 3),
                      device=dev)
    pos = torch.where((torch.arange(cap_local, device=dev)
                       < n_local)[:, None], pos, 0.0)
    carry = (key, pos, torch.tensor(n_local, dtype=torch.int32, device=dev),
             torch.tensor(1.5, dtype=_F32, device=dev))
    hist = []
    for _ in range(timesteps):
        carry, obs = step(carry)
        hist.append(obs)
    e = torch.stack([o["e_trial"] for o in hist])
    local = torch.stack([o["local_count"] for o in hist])
    return {"e_trial": e,
            "counts": torch.stack([o["count_after"] for o in hist]),
            "local_counts": comm.all_gather(local, axis=1),
            "rebalances": sum(o["rebalanced"] for o in hist),
            "e0_estimate": e[e.shape[0] // 2:].mean()}


def run_parallel(n_walkers: int = 512, timesteps: int = 200, *,
                 world: int = 1, store_dir, capacity_factor: int = 4,
                 tau: float = 0.01, seed: int = 0, device=None,
                 timeout: float = 600.0):
    """Full SPMD DMC over ``world`` ranks of a new process group
    (:func:`repro_torch.core.comm.run_ranks`, its store in ``store_dir``;
    NCCL on ``cuda``, gloo on ``cpu``); returns rank 0's result."""
    dev = resolve_device(device)
    return run_ranks(run_rank, (n_walkers, timesteps),
                     world=world, store_dir=store_dir, device=dev,
                     timeout=timeout,
                     kwargs=dict(capacity_factor=capacity_factor, tau=tau,
                                 seed=seed, device=dev))[0]
