"""Ideal-point MCMC (paper §4.1 / Appendix A) — the task-farm application.

Counterpart of ``repro.apps.mcmc``.  The Clinton–Jackman–Rivers
hierarchical probit model:

    P(y_ij = 1) = Phi(beta_j x_i - alpha_j)

estimated by Gibbs sampling with truncated-normal data augmentation:

  (i)   y*_ij | params  ~ N(beta_j x_i - alpha_j, 1) truncated by the vote
  (ii)  (beta_j, alpha_j) | x, y*  ~ 2x2 Bayesian regression per vote
  (iii) x_i | beta, alpha, y*      ~ 1D Bayesian regression per legislator

Each chain is one task handed to any
:class:`repro_torch.core.runtime.Executor` — serial, vmap, mesh, or thread
farm.  A chain draws from an explicit threefry key
(:mod:`repro_torch.serve.prng`), split and folded along the reference's
key path, so its uniform bits are the reference's and a stack of chain
keys goes through ``torch.func.vmap``.  The normals differ from XLA's by
ulps of ``erfinv``.

Class :class:`IdealPointProblem` mirrors the paper's ``PIPE`` class: the
constructor holds the data, and ``initialize`` / ``func`` / ``finalize`` have
exactly the generic signatures the executors demand.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.runtime import (Executor, SerialExecutor, VmapExecutor,
                                      make_executor)
from repro_torch.models.module import resolve_device
from repro_torch.serve import prng


def make_synthetic_votes(key, n_leg: int, n_votes: int, *, device=None):
    """Roll-call data from known ideal points (ground truth returned), on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    k1, k2, k3, k4 = prng.split(key, 4)
    x = prng.normal(k1, (n_leg,), device=dev)
    beta = prng.normal(k2, (n_votes,), device=dev) * 1.5
    alpha = prng.normal(k3, (n_votes,), device=dev) * 0.5
    p = torch.special.ndtr(beta[None, :] * x[:, None] - alpha[None, :])
    y = (prng.uniform(k4, p.shape, device=dev) < p).to(torch.float32)
    return y, {"x": x, "beta": beta, "alpha": alpha}


def _trunc_normal(key, mu, positive):
    """Sample N(mu,1) truncated to >0 (positive=True) or <0, via inverse CDF."""
    u = prng.uniform(key, mu.shape, minval=1e-6, maxval=1 - 1e-6,
                     device=mu.device)
    lo = torch.special.ndtr(-mu)                  # P(z < -mu) i.e. y* < 0
    u_pos = lo + u * (1 - lo)                     # map into (lo, 1)
    u_neg = u * lo                                # map into (0, lo)
    uu = torch.where(positive, u_pos, u_neg)
    return mu + torch.special.ndtri(torch.clamp(uu, 1e-7, 1 - 1e-7))


def gibbs_step(carry, key, y_pos, tau2: float = 25.0):
    """One Gibbs sweep (i)-(iii) from ``carry = (x, beta, alpha)``; returns
    the new carry.  ``key`` is a tensor key."""
    x, beta, alpha = carry
    n, m = y_pos.shape
    k1, k2, k3 = prng.split(key, 3)
    mu = beta[None, :] * x[:, None] - alpha[None, :]
    ystar = _trunc_normal(k1, mu, y_pos)                          # (n, m)

    # (beta_j, alpha_j): design X = [x, -1] (n x 2), ridge prior tau2
    X = torch.stack([x, -torch.ones_like(x)], dim=1)              # (n, 2)
    XtX = X.T @ X + torch.eye(2, device=x.device) / tau2          # (2, 2)
    Xty = X.T @ ystar                                             # (2, m)
    chol = torch.linalg.cholesky_ex(XtX).L       # unchecked, as jnp's
    # cho_solve as two triangular solves, as jax.scipy computes it
    mean = torch.linalg.solve_triangular(
        chol.T, torch.linalg.solve_triangular(chol, Xty, upper=False),
        upper=True)                                               # (2, m)
    eps = prng.normal(k2, (2, m), device=x.device)
    draw = mean + torch.linalg.solve_triangular(chol.T, eps, upper=True)
    beta, alpha = draw[0], draw[1]

    # x_i: regression of (y*_i + alpha) on beta
    prec = beta @ beta + 1.0 / tau2
    mean_x = (ystar + alpha[None, :]) @ beta / prec
    x = mean_x + prng.normal(k3, (n,), device=x.device) / torch.sqrt(prec)
    # identification: anchor location/scale (population std, as jnp's)
    x = (x - x.mean()) / torch.clamp(x.std(correction=0), min=1e-6)
    return x, beta, alpha


def run_chain(key, y, *, n_iter: int = 200, burn: int = 100, thin: int = 2,
              tau2: float = 25.0):
    """One Gibbs chain from a tensor key.  y: (n, m) in {0,1}.  Returns the
    posterior-mean summary and the kept draws of x.  The reference's scan
    is a loop over the keys of ``split(kscan, n_iter)``."""
    n, m = y.shape
    pos = y > 0.5
    k0, kscan = prng.split(key)
    x0 = prng.normal(k0, (n,), device=y.device) * 0.1
    carry = (x0, y.new_zeros(m), y.new_zeros(m))
    draws = []
    for k in prng.split(kscan, n_iter):
        carry = gibbs_step(carry, k, pos, tau2)
        draws.append(carry[0])
    kept = torch.stack(draws)[burn::thin]                         # (K, n)
    return {"x_mean": kept.mean(0), "x_draws": kept}


@dataclasses.dataclass
class IdealPointProblem:
    """The paper's ``PIPE`` class (initialize/func/finalize).  The chains
    run on ``y``'s device."""
    y: torch.Tensor
    n_chains: int = 4
    n_iter: int = 200
    burn: int = 100
    seed: int = 0

    def initialize(self):
        keys = prng.split(prng.PRNGKey(self.seed, device=self.y.device),
                          self.n_chains)
        # stacked task tree (leading axis = tasks), vmap/rank-ready
        return {"key": keys}

    def func(self, task):
        return run_chain(task["key"], self.y, n_iter=self.n_iter,
                         burn=self.burn)

    def finalize(self, output):
        """Combine chains: posterior mean + split-R-hat convergence check."""
        draws = output["x_draws"]                 # (chains, K, n)
        x_mean = draws.mean(dim=(0, 1))
        # align chain signs (reflection invariance) before R-hat
        ref = draws[0].mean(0)
        sign = torch.sign(torch.einsum("ckn,n->c", draws, ref))
        draws = draws * sign[:, None, None]
        W = draws.var(dim=1, correction=0).mean(0)          # within-chain
        B = draws.mean(dim=1).var(dim=0, correction=0)      # between-chain
        K = draws.shape[1]
        rhat = torch.sqrt((W * (K - 1) / K + B) / torch.clamp(W, min=1e-12))
        self.result = {"x_mean": x_mean, "rhat": rhat}
        return self.result


def solve(problem: IdealPointProblem, executor: Executor | str = "vmap",
          **executor_kwargs):
    """Run the problem on any executor (spec string or instance)."""
    executor = make_executor(executor, **executor_kwargs)
    return executor.run(problem.initialize, problem.func, problem.finalize)


def solve_serial(problem: IdealPointProblem):
    """Paper's serial ``solve_problem`` driving the same three functions."""
    return solve(problem, SerialExecutor())


def solve_vmap(problem: IdealPointProblem):
    """Single-device data-parallel chains (``torch.func.vmap``)."""
    return solve(problem, VmapExecutor())
