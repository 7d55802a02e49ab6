"""Boussinesq water waves via additive Schwarz (paper §4.3 / Appendix C).

Counterpart of ``repro.apps.boussinesq``.  Model (constant depth H=1, so
the ∇H terms of (C.1) vanish):

    continuity (explicit):  (eta^l - eta^{l-1})/dt + ∇·((1 + a·eta)∇phi) = 0
    bernoulli  (implicit):  (phi^l - phi^{l-1})/dt + (a/2)|∇phi|² + eta^l
                            - (e/3) ∇² (phi^l - phi^{l-1})/dt = 0

Each time step therefore needs one *implicit Helmholtz solve*
``(I - c ∇²) dphi = rhs`` with ``c = e/3`` — the paper's KONTIT/BERIT
role, and where additive Schwarz enters: the **same serial Jacobi
kernel** (:func:`jacobi_sweeps`, written once with no knowledge of
parallelism) is reused per subdomain, while the generic
:func:`repro_torch.core.schwarz.additive_schwarz_iterations` supplies the
outer iteration, halo ``communicate``, and the paper's convergence test.

Domain decomposition: 1-D row blocks over the ranks of a process group;
every local field carries one ghost row on each side.  Physical BCs are
no-flux (mirror); the x-direction is handled inside the stencil with edge
(replicate) padding.  Both solves run the paper's host-driven loop: one
host read of the convergence test an iteration.

Validation: the Schwarz-parallel solution must match the single-domain
serial solve (same kernel, global Jacobi) to stencil tolerance, and mass
(sum of eta) must be conserved under no-flux BCs.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.comm import run_ranks
from repro_torch.core.runtime import (Executor, MeshExecutor, SerialExecutor,
                                      make_executor)
from repro_torch.core.schwarz import (additive_schwarz_iterations,
                                      halo_exchange)
from repro_torch.models.module import resolve_device


@dataclasses.dataclass(frozen=True)
class BoussinesqParams:
    nx: int = 128
    ny: int = 128
    dx: float = 0.1
    dt: float = 0.02
    alpha: float = 0.0          # nonlinearity
    eps: float = 0.3            # dispersion
    jacobi_sweeps: int = 6      # per Schwarz iteration
    schwarz_max_iter: int = 200
    schwarz_threshold: float = 1e-10

    @property
    def c(self) -> float:
        return self.eps / 3.0


# ---------------------------------------------------------------------------
# "Legacy serial kernel": pure stencils on a ghost-padded block.
# Knows nothing about ranks or communication (the paper's F77 role).
# ---------------------------------------------------------------------------

def _pad_x(f):
    """Mirror-pad the x (last) axis: no-flux east/west walls (the
    reference's edge padding)."""
    return torch.cat([f[:, :1], f, f[:, -1:]], dim=1)


def laplacian(f, dx):
    """5-point Laplacian of the interior of a y-ghost-padded block.

    f: (ny_loc + 2, nx) -> (ny_loc, nx)."""
    fx = _pad_x(f)
    return (f[:-2, :] + f[2:, :] + fx[1:-1, :-2] + fx[1:-1, 2:]
            - 4.0 * f[1:-1, :]) / (dx * dx)


def grad_sq(f, dx):
    """|∇f|² of the interior (central differences)."""
    fx = _pad_x(f)
    gy = (f[2:, :] - f[:-2, :]) / (2 * dx)
    gx = (fx[1:-1, 2:] - fx[1:-1, :-2]) / (2 * dx)
    return gx * gx + gy * gy


def div_k_grad(k, f, dx):
    """∇·(k ∇f) of the interior, k on cell centres (ghost-padded like f)."""
    kx, fx = _pad_x(k), _pad_x(f)
    ke = 0.5 * (kx[1:-1, 1:-1] + kx[1:-1, 2:])
    kw = 0.5 * (kx[1:-1, 1:-1] + kx[1:-1, :-2])
    kn = 0.5 * (k[1:-1, :] + k[2:, :])
    ks = 0.5 * (k[1:-1, :] + k[:-2, :])
    return (ke * (fx[1:-1, 2:] - fx[1:-1, 1:-1])
            - kw * (fx[1:-1, 1:-1] - fx[1:-1, :-2])
            + kn * (f[2:, :] - f[1:-1, :])
            - ks * (f[1:-1, :] - f[:-2, :])) / (dx * dx)


def _set_interior(f, interior):
    return torch.cat([f[:1], interior, f[-1:]])


def jacobi_sweeps(dphi, rhs, c, dx, n_sweeps: int):
    """n Jacobi sweeps for (I - c∇²) dphi = rhs on a ghost-padded block.

    Ghost rows are held fixed (they are the Schwarz artificial BCs)."""
    diag = 1.0 + 4.0 * c / (dx * dx)
    for _ in range(n_sweeps):
        fx = _pad_x(dphi)
        nb = (dphi[:-2, :] + dphi[2:, :]
              + fx[1:-1, :-2] + fx[1:-1, 2:]) / (dx * dx)
        dphi = _set_interior(dphi, (rhs + c * nb) / diag)
    return dphi


# ---------------------------------------------------------------------------
# BCs and the per-time-step update (shared serial/parallel)
# ---------------------------------------------------------------------------

def apply_physical_bc(f, comm):
    """Mirror into the ghost rows at the *global* north/south walls.

    On interior subdomain edges the ghosts come from neighbours; rank 0's
    south ghost and rank n-1's north ghost are physical walls."""
    first = comm is None or comm.rank() == 0
    last = comm is None or comm.rank() == comm.size() - 1
    return torch.cat([f[1:2] if first else f[:1], f[1:-1],
                      f[-2:-1] if last else f[-1:]])


def _communicate(f, comm):
    """Refresh ghost rows from neighbours (then physical BCs overwrite the
    outer walls)."""
    if comm is None:
        return f
    left, right = halo_exchange(f[1:-1], comm, halo=1, axis=0)
    return torch.cat([left[-1:], f[1:-1], right[:1]])


def timestep(eta, phi, p: BoussinesqParams, comm):
    """One Boussinesq step on ghost-padded local blocks (serial: comm=None
    and the 'local block' is the global domain).

    Returns (eta, phi, schwarz_iters), the iteration count a Python int."""
    def refresh(f):
        return apply_physical_bc(_communicate(f, comm), comm)

    # -- continuity: explicit eta update ------------------------------------
    phi = refresh(phi)
    eta = refresh(eta)
    depth = 1.0 + p.alpha * eta
    eta_new_int = eta[1:-1, :] - p.dt * div_k_grad(depth, phi, p.dx)
    eta = refresh(_set_interior(eta, eta_new_int))

    # -- bernoulli: implicit Helmholtz solve for dphi -------------------------
    rhs = -p.dt * (eta[1:-1, :] + 0.5 * p.alpha * grad_sq(phi, p.dx))
    dphi = torch.zeros_like(phi)

    if comm is None:
        # serial: plain Jacobi to convergence with the SAME kernel; the
        # reference's while_loop, its condition read on the host
        prev, iters = dphi, 0
        while iters < p.schwarz_max_iter:
            if iters >= 2:
                diff = torch.sum((dphi - prev) ** 2)
                den = torch.clamp(torch.sum(dphi ** 2), min=1e-30)
                if not bool(diff / den > p.schwarz_threshold):
                    break
            prev = dphi
            dphi = apply_physical_bc(dphi, None)
            dphi = jacobi_sweeps(dphi, rhs, p.c, p.dx, p.jacobi_sweeps)
            iters += 1
    else:
        dphi, iters, _ = additive_schwarz_iterations(
            subdomain_solve=lambda d: jacobi_sweeps(d, rhs, p.c, p.dx,
                                                    p.jacobi_sweeps),
            communicate=lambda d: _communicate(d, comm),
            set_bc=lambda d: apply_physical_bc(d, comm),
            max_iter=p.schwarz_max_iter,
            threshold=p.schwarz_threshold,
            solution=dphi, comm=comm)

    return eta, phi + dphi, iters


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def initial_condition(p: BoussinesqParams, *, k_mode: int = 1, device=None):
    """Standing wave: eta = A cos(k x), phi = 0 (global, no ghosts)."""
    dev = resolve_device(device)
    x = (torch.arange(p.nx, device=dev) + 0.5) * p.dx
    Lx = p.nx * p.dx
    eta = 0.05 * torch.cos(k_mode * math.pi * x / Lx)
    return eta.repeat(p.ny, 1), torch.zeros((p.ny, p.nx), device=dev)


def _with_ghosts(f):
    return torch.nn.functional.pad(f, (0, 0, 1, 1))


def _stack_hist(hist: list) -> dict:
    return {k: (torch.stack([h[k] for h in hist]) if isinstance(
        hist[0][k], torch.Tensor) else [h[k] for h in hist])
        for k in hist[0]}


def run_serial(p: BoussinesqParams, steps: int, *, k_mode: int = 1,
               device=None):
    """The single-domain solve.  Returns (eta, phi, hist): ``hist`` holds
    each step's mass and probe (tensors) and Jacobi iterations (ints)."""
    eta, phi = initial_condition(p, k_mode=k_mode, device=device)
    eta, phi = _with_ghosts(eta), _with_ghosts(phi)
    hist = []
    for _ in range(steps):
        eta, phi, iters = timestep(eta, phi, p, None)
        hist.append({"mass": eta[1:-1].sum(),
                     "probe": eta[1 + p.ny // 4, p.nx // 4],
                     "iters": iters})
    return eta[1:-1], phi[1:-1], _stack_hist(hist)


def run_rank(comm, p: BoussinesqParams, steps: int, *, k_mode: int = 1,
             device=None):
    """One rank of the row-decomposed Schwarz run: rank r owns rows
    ``r * ny/n`` to ``(r+1) * ny/n``.  Returns the global (eta, phi),
    gathered on every rank, and each step's global mass and Schwarz
    iterations."""
    n, r = comm.size(), comm.rank()
    if p.ny % n:
        raise ValueError(f"ny {p.ny} does not split into {n} row blocks")
    rows = p.ny // n
    eta0, phi0 = initial_condition(p, k_mode=k_mode, device=device)
    eta = _with_ghosts(eta0[r * rows:(r + 1) * rows])
    phi = _with_ghosts(phi0[r * rows:(r + 1) * rows])
    hist = []
    for _ in range(steps):
        eta, phi, iters = timestep(eta, phi, p, comm)
        hist.append({"mass": comm.all_reduce_sum(eta[1:-1].sum()),
                     "iters": iters})
    return (comm.all_gather(eta[1:-1], tiled=True),
            comm.all_gather(phi[1:-1], tiled=True), _stack_hist(hist))


def run(p: BoussinesqParams, steps: int, *, k_mode: int = 1,
        executor: Executor | str = "serial", device=None,
        **executor_kwargs):
    """Executor-selecting driver: a :class:`MeshExecutor` runs the
    row-decomposed Schwarz solve over its ranks; a :class:`SerialExecutor`
    runs the single-domain serial solve (same kernel either way — Schwarz
    is domain decomposition, so only a mesh changes the layout).  Other
    executors are rejected rather than silently degraded.
    """
    executor = make_executor(executor, **executor_kwargs)
    if isinstance(executor, MeshExecutor):
        return run_rank(executor.comm, p, steps, k_mode=k_mode,
                        device=device)
    if not isinstance(executor, SerialExecutor):
        raise TypeError(
            f"boussinesq.run supports 'serial' or 'mesh' executors, not "
            f"{type(executor).__name__}: the Schwarz solve is domain "
            f"decomposition, so only a mesh changes the layout")
    return run_serial(p, steps, k_mode=k_mode, device=device)


def run_parallel(p: BoussinesqParams, steps: int, *, world: int = 1,
                 store_dir, k_mode: int = 1, device=None,
                 timeout: float = 600.0):
    """Row-decomposed Schwarz run over ``world`` ranks of a new process
    group (:func:`repro_torch.core.comm.run_ranks`, its store in
    ``store_dir``; NCCL on ``cuda``, gloo on ``cpu``); returns rank 0's
    result."""
    dev = resolve_device(device)
    return run_ranks(run_rank, (p, steps), world=world, store_dir=store_dir,
                     device=dev, timeout=timeout,
                     kwargs=dict(k_mode=k_mode, device=dev))[0]
