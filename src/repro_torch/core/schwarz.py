"""Additive Schwarz iterations — the paper's §3.3.

Counterpart of ``repro.core.schwarz``.  The paper's
``additive_Schwarz_iterations(subdomain_solve, communicate, set_BC,
max_iter, threshold, solution, convergence_test)`` signature is kept
intact; the pieces map as:

* ``subdomain_solve`` — user function: local solve on this rank's
  subdomain (wraps "the existing serial code").
* ``communicate`` — generic: halo exchange over
  :meth:`~repro_torch.core.comm.Comm.permute` (:func:`halo_exchange`).
* ``convergence_test`` — generic: local relative change + a max
  all-reduce (paper's ``all_reduce(..., MAX)``).
* the ``while not_converged`` loop is the paper's host-driven loop (the
  reference compiles it into one ``while_loop``): one convergence
  all-reduce and one host read an iteration.  Every rank reads the same
  all-reduced value, so every rank leaves the loop at the same iteration.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch


def halo_exchange(field: torch.Tensor, comm, halo: int, *, axis: int = 0,
                  periodic: bool = False):
    """Exchange ``halo``-wide boundary slabs with ring neighbours.

    ``field``: local interior block, decomposed along ``axis`` over the
    ranks of ``comm``.  Returns ``(left_ghost, right_ghost)`` — the
    neighbouring ranks' adjacent slabs (zeros at non-periodic ends, which
    the caller's ``set_bc`` overwrites with physical boundary values).
    """
    n = comm.size()
    my_left = field.narrow(axis, 0, halo)      # -> left neighbour's right ghost
    my_right = field.narrow(axis, field.shape[axis] - halo, halo)

    if periodic:
        fwd = [(i, (i + 1) % n) for i in range(n)]
        bwd = [((i + 1) % n, i) for i in range(n)]
    else:
        fwd = [(i, i + 1) for i in range(n - 1)]
        bwd = [(i + 1, i) for i in range(n - 1)]

    left_ghost = comm.permute(my_right, fwd)   # from rank-1: its last rows
    right_ghost = comm.permute(my_left, bwd)   # from rank+1: its first rows
    return left_ghost, right_ghost


def simple_convergence_test(solution, solution_prev, comm,
                            threshold: float = 1e-3) -> torch.Tensor:
    """Paper-faithful: max_s ||u_s,k - u_s,k-1||^2 / ||u_s,k||^2 < threshold
    (a bool tensor, the same on every rank)."""
    diff = (solution - solution_prev).flatten()
    num = torch.dot(diff, diff)
    den = torch.clamp(torch.dot(solution.flatten(), solution.flatten()),
                      min=1e-30)
    return comm.all_reduce_max(num / den) < threshold


def additive_schwarz_iterations(
    subdomain_solve: Callable,
    communicate: Callable,
    set_bc: Callable,
    max_iter: int,
    threshold: float,
    solution,
    comm,
    convergence_test: Optional[Callable] = None,
):
    """Run additive Schwarz to convergence: the paper's host-driven loop.

    ``subdomain_solve(solution) -> solution`` performs the local solve given
    ghost values already present; ``communicate(solution) -> solution``
    refreshes ghosts from neighbours; ``set_bc`` applies physical BCs.

    Returns (solution, iterations_used, converged_flag), the last two
    Python values.
    """
    if convergence_test is None:
        convergence_test = functools.partial(simple_convergence_test,
                                             threshold=threshold)
    sol, it, converged = solution, 0, False
    while not converged and it < max_iter:
        prev = sol
        sol = communicate(sol)
        sol = set_bc(sol)
        sol = subdomain_solve(sol)
        converged = bool(convergence_test(sol, prev, comm))
        it += 1
    return sol, it, converged
