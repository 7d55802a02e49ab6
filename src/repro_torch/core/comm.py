"""Pluggable communication object — the paper's ``send``/``recv``/
``all_gather`` *function arguments*, over ``torch.distributed``.

Counterpart of ``repro.core.comm``.  The paper passes its MPI primitives
INTO its generic functions so the transport is swappable; the reference
binds named-axis collectives into a :class:`Comm` value inside one SPMD
program.  Here the ranks are processes of one ``torch.distributed``
process group (NCCL on a card, gloo on the CPU), and a :class:`Comm`
bundles the group's collectives behind the same methods.  A
:class:`SerialComm` implements the same interface for a single process
with the reference's identities, so user code is transport-agnostic.

The reference's ``shard_map`` wrapper has no counterpart: an SPMD body
here is a module-level function ``fn(comm, *args)`` that
:func:`run_ranks` runs on every rank of a fresh process group.

Every rank must call the same collectives in the same order; a rank that
skips one leaves the others waiting, so :func:`run_ranks` joins its ranks
under a timeout.

A serving mesh (:func:`make_mesh`, the counterpart of ``jax.make_mesh``)
lays the ranks of the world out on named axes and gives each axis a
:class:`Comm` over the ranks that share every other coordinate.  Code that
takes a transport tells the serial one from a mesh axis by one test,
``comm.axis is None``: a :class:`SerialComm` has no axis, a :class:`Comm`
always names one.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import pathlib
import time
import traceback
import uuid
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils import _pytree as pytree


class Comm:
    """The collectives of a process group (``group=None``: the default
    group).  With no process group initialized, a Comm is the one rank of
    a world of one: its collectives keep their meaning (an untiled
    ``all_gather`` inserts the axis, ``permute`` leaves zeros where no pair
    sends), computed in place, as the reference's ``Comm`` over a
    one-device mesh computes them.  ``axis`` names the mesh axis the group
    spans (``"world"`` for the default group); it is never None, which is
    how a mesh transport is told from :class:`SerialComm`."""

    def __init__(self, group=None, *, axis="world"):
        if axis is None:
            raise ValueError("a Comm spans a named axis; SerialComm is the "
                             "transport without one")
        self.group = group
        self.axis = axis
        self._alone = not dist.is_initialized()
        if self._alone and group is not None:
            raise ValueError("a process group was given, but torch."
                             "distributed is not initialized")

    # -- topology ----------------------------------------------------------
    def rank(self) -> int:
        """Paper's ``my_rank``."""
        return 0 if self._alone else dist.get_rank(self.group)

    def size(self) -> int:
        """Paper's ``num_procs``."""
        return 1 if self._alone else dist.get_world_size(self.group)

    def _global(self, rank: int) -> int:
        """A group rank as the global rank that point-to-point calls take."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    # -- collectives --------------------------------------------------------
    def all_gather(self, x: torch.Tensor, *, axis: int = 0,
                   tiled: bool = False) -> torch.Tensor:
        """Every rank's ``x`` in rank order: concatenated along ``axis``
        (tiled) or stacked on a new ``axis``."""
        if self._alone:
            parts = [x]
        else:
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.size())]
            dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=axis) if tiled else torch.stack(parts,
                                                                    dim=axis)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        y = x.clone()
        if not self._alone:
            dist.all_reduce(y, op=op, group=self.group)
        return y

    def all_reduce_sum(self, x):
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def all_reduce_max(self, x):
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def all_reduce_min(self, x):
        return self._all_reduce(x, dist.ReduceOp.MIN)

    def all_to_all(self, x: torch.Tensor, *, split_axis: int,
                   concat_axis: int, tiled: bool = True) -> torch.Tensor:
        """Rank r keeps chunk r of ``split_axis`` and receives every other
        rank's chunk r, in rank order along ``concat_axis`` (tiled: the
        chunks concatenated; untiled: ``split_axis`` has the world's size,
        each chunk loses it and they stack on a new ``concat_axis``)."""
        n = self.size()
        if not tiled and x.shape[split_axis] != n:
            raise ValueError(f"untiled all_to_all needs axis {split_axis} of "
                             f"size {n}, got {tuple(x.shape)}")
        chunks = [c.contiguous() for c in x.chunk(n, dim=split_axis)]
        if self._alone:
            parts = chunks
        else:
            parts = [torch.empty_like(c) for c in chunks]
            dist.all_to_all(parts, chunks, group=self.group)
        if tiled:
            return torch.cat(parts, dim=concat_axis)
        return torch.stack([p.squeeze(split_axis) for p in parts],
                           dim=concat_axis)

    def shift(self, x, offset: int = 1):
        """Ring point-to-point: every rank sends to ``rank+offset`` (mod n)."""
        n = self.size()
        return self.permute(x, [(i, (i + offset) % n) for i in range(n)])

    def permute(self, x: torch.Tensor, perm: Sequence[tuple[int, int]]):
        """Send ``x`` along each ``(source, destination)`` pair, as
        ``jax.lax.ppermute``: a rank receives the ``x`` of the rank that
        names it, or zeros where none does.  Runs on
        ``dist.batch_isend_irecv``."""
        me = self.rank()
        out = torch.zeros_like(x)
        ops = []
        x = x.contiguous()
        for src, dst in perm:
            if src == me and dst == me:
                out = x.clone()
            elif src == me:
                ops.append(dist.P2POp(dist.isend, x, self._global(dst),
                                      self.group))
            elif dst == me:
                ops.append(dist.P2POp(dist.irecv, out, self._global(src),
                                      self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def broadcast_from(self, x: torch.Tensor, root: int = 0):
        """Paper's ``pypar.broadcast``: value from ``root`` to all ranks."""
        y = x.clone()
        if not self._alone:
            dist.broadcast(y, src=self._global(root), group=self.group)
        return y


class SerialComm:
    """Single-process Comm with identical interface (paper's serial path),
    with the reference's identities.  Its ``axis`` is None: the serial
    transport spans no mesh axis."""

    group = None
    axis = None

    def rank(self) -> int:
        return 0

    def size(self) -> int:
        return 1

    def all_gather(self, x, *, axis: int = 0, tiled: bool = False):
        return x if tiled else x.unsqueeze(axis)

    def all_reduce_sum(self, x):
        return x

    def all_reduce_max(self, x):
        return x

    def all_reduce_min(self, x):
        return x

    def all_to_all(self, x, *, split_axis: int, concat_axis: int,
                   tiled: bool = True):
        return x

    def shift(self, x, offset: int = 1):
        return x

    def permute(self, x, perm):
        return x

    def broadcast_from(self, x, root: int = 0):
        return x


def make_comm(group=None) -> Comm | SerialComm:
    """Factory: ``group=None`` gives the serial transport, a process group
    (``torch.distributed.group.WORLD`` for the default one) a
    :class:`Comm` over it."""
    return SerialComm() if group is None else Comm(group)


# ---------------------------------------------------------------------------
# A serving mesh: the world's ranks on named axes, one Comm an axis
# ---------------------------------------------------------------------------

class Mesh:
    """The ranks of the initialized world laid out row-major on named axes,
    as ``jax.make_mesh`` lays out devices: on ``("expert", "model")`` of
    shape (ep, tp), rank ``e * tp + m`` sits at (e, m).

    ``axis_names`` and ``shape`` (a dict: ``mesh.shape["model"]``) read as
    the reference's mesh does; ``coords`` is this rank's coordinate on each
    axis; :meth:`comm` is the :class:`Comm` of one axis, over the ranks
    that share every other coordinate with this one; ``world`` is a
    :class:`Comm` over every rank of the mesh, in rank order (which is the
    row-major order of the axes)."""

    def __init__(self, shape, axis_names):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} must pair up, names distinct")
        if not dist.is_initialized():
            raise RuntimeError("make_mesh runs inside an initialized world "
                               "(run_ranks); with no group there is no mesh")
        world, me = dist.get_world_size(), dist.get_rank()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} needs "
                             f"{math.prod(shape)} ranks, the world has "
                             f"{world}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.coords = dict(zip(axis_names,
                               (int(c) for c in np.unravel_index(me, shape))))
        self.world = Comm(axis=axis_names)
        self._comms = {}
        # every rank creates every group, in the same order: new_group is a
        # collective of the whole world even for the ranks outside it
        for i, name in enumerate(axis_names):
            others = [range(n) if j != i else (0,)
                      for j, n in enumerate(shape)]
            for base in itertools.product(*others):
                ranks = []
                for c in range(shape[i]):
                    at = list(base)
                    at[i] = c
                    ranks.append(int(np.ravel_multi_index(at, shape)))
                group = dist.new_group(ranks)
                if me in ranks:
                    self._comms[name] = Comm(group, axis=name)

    def comm(self, name: str) -> Comm:
        """The :class:`Comm` of axis ``name`` through this rank."""
        return self._comms[name]

    def index(self, axes, rank: int | None = None) -> tuple[int, int]:
        """(the shard index of this rank, or of world rank ``rank``, and the
        shard count) when a tensor axis is split over the mesh axes
        ``axes`` (one name, or a tuple, major first): the reference's
        ``PartitionSpec`` entry semantics."""
        if isinstance(axes, str):
            axes = (axes,)
        coords = self.coords if rank is None else dict(zip(
            self.axis_names, (int(c) for c in np.unravel_index(
                rank, tuple(self.shape.values())))))
        idx, n = 0, 1
        for a in axes:
            idx = idx * self.shape[a] + coords[a]
            n *= self.shape[a]
        return idx, n


def make_mesh(shape, axis_names) -> Mesh:
    """The serving mesh of the initialized world (:class:`Mesh`): the
    counterpart of ``jax.make_mesh(shape, axis_names)``.  Every rank must
    call it, in the same order as every other group it makes."""
    return Mesh(shape, axis_names)


# ---------------------------------------------------------------------------
# Running an SPMD body on the ranks of a fresh process group
# ---------------------------------------------------------------------------

def _backend(device: torch.device) -> str:
    """NCCL on a card, gloo on the CPU: a gloo group on the card would be
    a quiet substitute for NCCL, so the device picks."""
    return "nccl" if device.type == "cuda" else "gloo"


def _init(rank: int, world: int, store: str, device: torch.device,
          timeout: float) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(_backend(device), init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))


def _on_host(tree):
    return pytree.tree_map(
        lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, tree)


def _rank_main(rank: int, world: int, fn: Callable, args: tuple,
               kwargs: dict, store: str, device: torch.device,
               timeout: float, out: str) -> None:
    """One spawned rank: join the group, run ``fn``, save its result (or
    its traceback) for the parent, leave the group."""
    try:
        _init(rank, world, store, device, timeout)
        try:
            result = _on_host(fn(Comm(), *args, **kwargs))
        finally:
            dist.destroy_process_group()
        torch.save(result, f"{out}.{rank}.pt")
    except BaseException:
        pathlib.Path(f"{out}.{rank}.err").write_text(traceback.format_exc())
        raise


def run_ranks(fn: Callable, args: tuple = (), *, world: int, store_dir,
              device, timeout: float = 300.0,
              kwargs: dict | None = None) -> list:
    """Run ``fn(comm, *args, **kwargs)`` on ``world`` ranks of one new process group
    and return each rank's result, in rank order (tensors on the host).

    ``fn`` must be importable at module level (ranks start from a fresh
    import).  The group meets through a ``file://`` store in ``store_dir``
    (a relative one is taken from the working directory: a ``file://`` URL
    needs an absolute path), so no port is taken; its backend follows ``device`` (NCCL on ``cuda``,
    one card a rank; gloo on ``cpu``).  At ``world`` 1 the rank is this
    process: the group is made, used and destroyed here, and no group is
    left behind.  Otherwise each rank is a process spawned with
    ``torch.multiprocessing``; the ranks are joined with ``timeout``
    seconds in all, and a rank that fails or hangs stops the others and
    raises here."""
    device = torch.device(device)
    kwargs = kwargs or {}
    if device.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} NCCL ranks need {world} CUDA cards, "
                           f"{torch.cuda.device_count()} are visible")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    store_dir = pathlib.Path(store_dir).resolve()
    store_dir.mkdir(parents=True, exist_ok=True)
    tag = os.path.join(str(store_dir), f"ranks-{uuid.uuid4().hex}")
    store = f"{tag}.store"
    try:
        if world == 1:
            _init(0, 1, store, device, timeout)
            try:
                return [_on_host(fn(Comm(), *args, **kwargs))]
            finally:
                dist.destroy_process_group()
        return _spawn(fn, args, kwargs, world, store, device, timeout, tag)
    finally:
        for p in pathlib.Path(store_dir).glob(os.path.basename(tag) + ".*"):
            p.unlink(missing_ok=True)


_FAILURE_GRACE = 5.0      # seconds the other ranks get to exit after a failure


def _failure(procs, ranks: list, tag: str) -> RuntimeError:
    msgs = []
    for r in ranks:
        err = pathlib.Path(f"{tag}.{r}.err")
        msgs.append(err.read_text() if err.exists()
                    else f"rank {r}: exit code {procs[r].exitcode}")
    return RuntimeError(f"rank(s) {ranks} failed:\n" + "\n".join(msgs))


def _spawn(fn, args, kwargs, world, store, device, timeout, tag) -> list:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, fn, args, kwargs, store, device,
                               timeout, tag))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while not all(p.exitcode == 0 for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                # a rank that fails takes down the ranks waiting on it in a
                # collective, and either may exit first: give the others a
                # moment, so the first failure's traceback is in the report
                grace = time.monotonic() + _FAILURE_GRACE
                while time.monotonic() < grace and any(
                        p.exitcode is None for p in procs):
                    time.sleep(0.02)
                raise _failure(procs, [r for r, p in enumerate(procs)
                                       if p.exitcode not in (None, 0)], tag)
            if time.monotonic() > deadline:
                hung = [r for r, p in enumerate(procs) if p.is_alive()]
                raise TimeoutError(f"rank(s) {hung} of {world} still running "
                                   f"after {timeout} s")
            time.sleep(0.02)
        return [torch.load(f"{tag}.{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
