"""Collectives with gradients, and the training forward's view of a mesh.

The reference trains on a mesh inside one jitted SPMD program: GSPMD reads
the logical shardings and inserts the collectives (an all-gather of a
layer's ZeRO-3 shards before it is used, a reduce-scatter of its gradient,
the K/V gather of sequence parallelism).  Here every rank runs the eager
forward and backward on its own shards, and the collectives are explicit
autograd Functions over :class:`repro_torch.core.comm.Comm` groups:

* :func:`gather_many` — an all-gather of tensors' shards over the mesh
  axes that split them (tiled along each split dim; tensors split over the
  same axes in one collective an axis), optionally after a cast to the
  compute dtype; its backward is the reduce-scatter of the gradients, a
  sum, in float32, returned in the shards' dtype.  Casting then gathering
  equals gathering then casting, element for element.
* :func:`all_reduce_sum` — a sum over mesh axes whose backward is the
  identity (the loss: every rank's gradient is its own tokens' share, and
  the ranks' gradients sum to the single-device gradient).

Every rank must issue the same collectives in the same order.  The forward
is the same program on every rank, and autograd replays it in reverse on
one thread (the caller's for CPU tensors, the device's thread on a card),
the recompute of ``torch.utils.checkpoint`` included, so no collective runs
in a hook of another thread.

:class:`TrainMesh` binds a mesh, its rules and a model's parameter specs:
what ``models/transformer.py``'s training forward gathers and where, the
gradients' finishing all-reduce over the axes a leaf is replicated on, and
the global gradient norm that counts each replicated leaf once.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.mesh.axes import AxisRules, logical_to_mesh
from repro_torch.models.module import tree_map

_F32 = torch.float32


def _axes(entry) -> tuple:
    """A mesh-spec entry (None, a name, or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _steps(spec: tuple, mesh) -> list:
    """The ``(axis, dim)`` steps that gather a tensor split by the mesh spec
    ``spec``, minor mesh axes first (an entry's tuple is major first, as in
    :meth:`repro_torch.core.comm.Mesh.index` and the mesh's own order), so
    that tensors split over the same axes gather in the same order."""
    steps = [(ax, dim) for dim, entry in enumerate(spec)
             for ax in _axes(entry)]
    return sorted(steps, key=lambda s: -mesh.axis_names.index(s[0]))


def _gather_flat(xs: list, dims: list, comm, dtype=None) -> list:
    """Every rank's shard of each ``xs[i]`` concatenated along ``dims[i]``
    (cast to ``dtype`` first when given), in one all-gather of the shards
    packed end to end, each in its own layout: one pass to pack (none for
    one contiguous shard), the collective, one pass to lay each whole
    tensor out contiguously (none for one tensor split on dim 0)."""
    n = comm.size()
    dt = dtype or xs[0].dtype
    sizes = [x.numel() for x in xs]
    total = sum(sizes)
    if len(xs) == 1 and xs[0].dtype == dt and xs[0].is_contiguous():
        flat = xs[0].view(-1)
    else:
        flat = torch.empty(total, dtype=dt, device=xs[0].device)
        off = 0
        for x, m in zip(xs, sizes):
            flat[off:off + m].view(x.shape).copy_(x)
            off += m
    buf = torch.empty(n * total, dtype=dt, device=flat.device)
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(buf, flat, group=comm.group)
    buf = buf.view(n, total)
    out, off = [], 0
    for x, d, m in zip(xs, dims, sizes):
        shape = list(x.shape)
        shape[d] *= n
        piece = buf[:, off:off + m].view((n,) + tuple(x.shape))
        out.append(piece.movedim(0, d).reshape(shape))
        off += m
    return out


def _scatter_flat(gs: list, dims: list, comm) -> list:
    """The sum over ``comm``'s ranks of each ``gs[i]``, cut along
    ``dims[i]`` into their blocks: this rank's blocks, float32, in one
    reduce-scatter of the blocks packed rank by rank (one pass to pack,
    the cast to float32 folded in; none for one float32 tensor split on
    dim 0); each result a contiguous view of the output."""
    n = comm.size()
    shapes = []
    for g, d in zip(gs, dims):
        shape = list(g.shape)
        shape[d] //= n
        shapes.append(shape)
    sizes = [math.prod(sh) for sh in shapes]
    total = sum(sizes)
    g0 = gs[0]
    if (len(gs) == 1 and dims[0] == 0 and g0.dtype == _F32
            and g0.is_contiguous()):
        inp = g0.view(-1)
    else:
        inp = torch.empty(n, total, dtype=_F32, device=g0.device)
        off = 0
        for g, d, sh, m in zip(gs, dims, shapes, sizes):
            inp[:, off:off + m].view([n] + sh).copy_(
                g.unflatten(d, (n, sh[d])).movedim(d, 0))
            off += m
        inp = inp.view(-1)
    out = torch.empty(total, dtype=_F32, device=g0.device)
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, inp, group=comm.group)
    res, off = [], 0
    for sh, m in zip(shapes, sizes):
        res.append(out[off:off + m].view(sh))
        off += m
    return res


class _Gather(torch.autograd.Function):
    """All-gather of tensors split alike (the same comms, in order; each
    tensor along its own dims), one collective a comm; the backward
    reduce-scatters in float32, one collective a comm in reverse."""

    @staticmethod
    def forward(ctx, dtype, comms, dims, *xs):
        ctx.comms, ctx.dims = comms, dims
        ctx.dtypes = [x.dtype for x in xs]
        ys = list(xs)
        for j, comm in enumerate(comms):
            ys = _gather_flat(ys, [d[j] for d in dims], comm,
                              dtype if j == 0 else None)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *gs):
        for j in reversed(range(len(ctx.comms))):
            gs = _scatter_flat(gs, [d[j] for d in ctx.dims], ctx.comms[j])
        return (None, None, None,
                *[g.to(dt) for g, dt in zip(gs, ctx.dtypes)])


class _AllReduceSum(torch.autograd.Function):
    """A sum over each comm in turn; the backward passes the gradient on."""

    @staticmethod
    def forward(ctx, x, comms):
        y = x.clone()
        for comm in comms:
            dist.all_reduce(y, group=comm.group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_many(xs: list, specs: list, mesh, dtype=None) -> list:
    """The whole tensors from this rank's shards ``xs`` under their mesh
    ``specs``, each cast to ``dtype`` first when given (a tensor no axis
    splits is only cast).  Tensors split over the same axes move together:
    one all-gather an axis for the lot.  Differentiable: a shard's gradient
    is the reduce-scatter (a sum in float32) of the whole tensor's, in the
    shard's dtype.  Every rank must call it with the same specs."""
    out = [None] * len(xs)
    groups: dict = {}
    for i, (x, spec) in enumerate(zip(xs, specs)):
        steps = _steps(spec, mesh)
        if not steps:
            out[i] = x if dtype is None else x.to(dtype)
            continue
        key = (tuple(a for a, _ in steps), x.dtype)
        groups.setdefault(key, []).append((i, tuple(d for _, d in steps)))
    for (axes, _), members in sorted(groups.items(), key=lambda kv: (
            kv[0][0], str(kv[0][1]))):
        ys = _Gather.apply(dtype, tuple(mesh.comm(a) for a in axes),
                           tuple(d for _, d in members),
                           *[xs[i] for i, _ in members])
        for (i, _), y in zip(members, ys):
            out[i] = y
    return out


def gather(x: torch.Tensor, spec: tuple, mesh, dtype=None) -> torch.Tensor:
    """:func:`gather_many` of one tensor."""
    return gather_many([x], [spec], mesh, dtype)[0]


def all_reduce_sum(x: torch.Tensor, comms) -> torch.Tensor:
    """The sum of ``x`` over the ranks of every comm in ``comms`` (a new
    tensor); the backward is the identity."""
    return _AllReduceSum.apply(x, tuple(comms))


@torch.no_grad()
def all_reduce_many(ts: list, comm) -> None:
    """Sum every tensor of ``ts`` (one dtype) over ``comm`` in place, in one
    collective over their concatenation."""
    if not ts:
        return
    flat = torch.cat([t.reshape(-1) for t in ts])
    dist.all_reduce(flat, group=comm.group)
    off = 0
    for t in ts:
        t.copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()


class TrainMesh:
    """The training forward's mesh: ``mesh`` (a
    :class:`repro_torch.core.comm.Mesh`), its ``rules``, and the SPMD
    program's ``axes`` (every mesh axis; the pod data-parallel step leaves
    out ``"pod"``, over which it reduces gradients itself).

    * ``specs``: the mesh spec of every parameter of ``defs`` (the model's
      declaration tree), the state's layout;
    * the batch is split over ``rules["batch"]`` (rows) and
      ``rules["seq"]`` (positions): a rank holds rows of its data block and
      the positions ``seq_offset() .. + S / seq_count``;
    * :meth:`gather_params` gathers a layer's shards (in the compute dtype;
      the norms' scales stay as they are, as the reference reads them),
      :meth:`attention_kv` the K/V of every position before this rank's
      last one;
    * :meth:`finish_grads` sums each gradient leaf over the axes its leaf
      is replicated on, :meth:`owned` says which rank counts a leaf in the
      global norm."""

    def __init__(self, mesh, rules: AxisRules, defs, *, axes=None):
        self.mesh, self.rules = mesh, rules
        self.axes = tuple(mesh.axis_names if axes is None else axes)
        self.specs = tree_map(
            lambda p: logical_to_mesh(p.logical_axes(), rules), defs)
        self.seq_axes = _axes(rules.get("seq"))
        self.comms = tuple(mesh.comm(a) for a in self.axes)

    # -- the batch's layout -------------------------------------------------
    def seq_block(self) -> tuple[int, int]:
        """(this rank's block of the sequence, the number of blocks)."""
        return self.mesh.index(self.seq_axes)

    # -- collectives of the forward -----------------------------------------
    def gather(self, x, spec, dtype=None):
        """:func:`gather` on this mesh."""
        return gather(x, spec, self.mesh, dtype)

    def gather_params(self, tree, specs, dtype):
        """A layer's weights whole, each in ``dtype`` (``scale`` leaves, the
        norms', as they are): one all-gather an axis for the layer's
        weights split alike (:func:`gather_many`)."""
        paths, xs, sps = [], [], []

        def walk(t, sp, path):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, sp[k], path + (k,))
                elif k != "scale":
                    paths.append(path + (k,))
                    xs.append(v)
                    sps.append(sp[k])
        walk(tree, specs, ())
        whole = dict(zip(paths, gather_many(xs, sps, self.mesh, dtype)))

        def build(t, path):
            return {k: (build(v, path + (k,)) if isinstance(v, dict)
                        else v if k == "scale" else whole[path + (k,)])
                    for k, v in t.items()}
        return build(tree, ())

    def attention_kv(self, k, v):
        """This rank's K/V (B, S / n, Hkv, D) -> the keys and values of
        every position up to its last one, and its queries' offset: the
        sequence blocks gathered in one collective an axis (the backward
        sums their gradients over the ranks), then cut to the prefix
        ``(i + 1) * S / n``."""
        i, n = self.seq_block()
        s = k.shape[1]
        spec = (None, self.rules.get("seq"), None, None)
        k, v = gather_many([k, v], [spec, spec], self.mesh)
        end = (i + 1) * s
        return k[:, :end], v[:, :end], i * s

    def all_reduce_sum(self, x):
        """The sum over the program's axes; identity backward."""
        return all_reduce_sum(x, self.comms)

    # -- gradients -----------------------------------------------------------
    def _replicated(self, spec) -> tuple:
        split = {a for e in spec for a in _axes(e)}
        return tuple(a for a in self.axes if a not in split)

    def with_specs(self, tree) -> list:
        """``(leaf, mesh spec)`` of every leaf of ``tree`` (a tree of the
        params' keys, in any key order), in ``tree``'s order."""
        out = []

        def walk(t, sp):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, sp[k])
            else:
                out.append((t, sp))
        walk(tree, self.specs)
        return out

    @torch.no_grad()
    def finish_grads(self, grads):
        """Sum each gradient leaf (a shard already summed over the axes that
        split it, by the gathers' backward) over the program's axes its leaf
        is replicated on, in place: one all-reduce an axis (and dtype) over
        every leaf replicated on it, in tree order."""
        pairs = self.with_specs(grads)
        for a in self.axes:
            rep = [g for g, spec in pairs if a in self._replicated(spec)]
            for dt in sorted({g.dtype for g in rep}, key=str):
                all_reduce_many([g for g in rep if g.dtype == dt],
                                self.mesh.comm(a))
        return grads

    def owned(self, tree) -> list:
        """``(leaf, counted)`` in ``tree``'s order: whether this rank counts
        the leaf in a global sum over the tree, so that a leaf replicated
        on some axes is counted by the ranks at coordinate 0 of those axes
        only."""
        return [(t, all(self.mesh.coords[a] == 0
                        for a in self._replicated(sp)))
                for t, sp in self.with_specs(tree)]
