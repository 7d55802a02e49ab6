"""Cross-pod data parallelism with int8 error-feedback gradient exchange:
the paper's thin communication layer applied to the slow tier of a
multi-pod mesh.  Counterpart of ``repro.train.pod_dp``.

The mesh is ``("pod", "data", "model")``.  Within a pod the step is the
mesh train step's (:mod:`repro_torch.train.step`): ZeRO-3 shards over
``"data"`` and ``"model"``, sequence parallelism over ``"model"``, the
gradients reduce-scattered and summed within the pod.  Across pods the
mean gradient goes over the ``"pod"`` axis's ranks, compressed
(:func:`repro_torch.optim.compress.compressed_psum`): int8 codes and one
float32 scale a tensor, the quantization residual kept on the rank as
error feedback.  The reference quantizes each **whole** tensor with one
scale; here each rank holds a shard, so the shards' ``max |g|`` is
reduced over the pod's ``"data"`` and ``"model"`` ranks first and the
codes are the reference's.  The reference's pods are separate compiled
programs joined by a host loop; here every rank of every pod runs the
same eager step and the pod axis is one more ``torch.distributed`` group.

``wire_bytes`` and ``fp32_bytes`` count as the reference counts: per pod
and whole tensor, the int8 payload plus 4 bytes of scale against 4 bytes
an element.  ``compress=False`` takes the plain mean (float64 sum of the
pods' float32 gradients, rounded to float32 once), and moves no count.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.comm import Comm
from repro_torch.mesh.axes import AxisRules, logical_to_mesh, strip_axis
from repro_torch.mesh.grad_comm import all_reduce_many
from repro_torch.models.module import shard_leaf, tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compress import compressed_psum, init_compression_state
from repro_torch.train.state import create_train_state, state_shardings
from repro_torch.train.step import make_grads_fn, train_mesh


class PodMesh:
    """One pod's ``("data", "model")`` sub-mesh of a ``("pod", "data",
    "model")`` mesh: its axes and shape, and, on a rank of the pod, its
    coordinates, each axis's :class:`repro_torch.core.comm.Comm` (the
    parent mesh's) and ``world`` (a Comm over the pod's ranks)."""

    def __init__(self, mesh, pod: int, world: Comm | None):
        self.parent, self.pod = mesh, pod
        self.axis_names = tuple(a for a in mesh.axis_names if a != "pod")
        self.shape = {a: mesh.shape[a] for a in self.axis_names}
        self.member = mesh.coords["pod"] == pod
        self.coords = ({a: mesh.coords[a] for a in self.axis_names}
                       if self.member else None)
        self.world = world

    def comm(self, name: str):
        if not self.member:
            raise ValueError(f"this rank is not in pod {self.pod}")
        return self.parent.comm(name)

    def index(self, axes, rank=None):
        return self.parent.index(axes, rank)


def split_pod_meshes(mesh) -> list:
    """(2, 16, 16) ``("pod", "data", "model")`` -> the pods' (16, 16)
    sub-meshes (:class:`PodMesh`), in pod order.  Every rank calls it (the
    pods' groups are made by the whole world)."""
    import torch.distributed as dist
    if "pod" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'pod' axis")
    shape = tuple(mesh.shape.values())
    pod_dim = mesh.axis_names.index("pod")
    out = []
    for p in range(mesh.shape["pod"]):
        ranks = [r for r in range(math.prod(shape))
                 if _coord(r, shape, pod_dim) == p]
        group = dist.new_group(ranks)
        member = mesh.coords["pod"] == p
        out.append(PodMesh(mesh, p, Comm(group, axis=tuple(
            a for a in mesh.axis_names if a != "pod")) if member else None))
    return out


def _coord(rank: int, shape: tuple, dim: int) -> int:
    """World rank ``rank``'s coordinate on axis ``dim`` (row-major)."""
    return rank // math.prod(shape[dim + 1:]) % shape[dim]


@dataclasses.dataclass
class PodDPStep:
    """The pod data-parallel train step on every rank of ``mesh``:
    ``step(state, batch) -> (state, out)``, the state updated in place."""
    model: object
    opt_cfg: AdamWConfig
    mesh: object
    rules: AxisRules
    compress: bool = True

    def __post_init__(self):
        self.n_pods = self.mesh.shape["pod"]
        self.sub_rules = strip_axis(self.rules, "pod")
        axes = tuple(a for a in self.mesh.axis_names if a != "pod")
        self.tm = train_mesh(self.model, self.mesh, self.sub_rules, axes=axes)
        self.grads_of = make_grads_fn(self.model, self.tm)
        self.shardings = state_shardings(self.model, self.mesh,
                                         self.sub_rules)
        self._batch_spec = logical_to_mesh(("batch", "seq"), self.rules)
        self._sizes = [math.prod(p.shape)
                       for p in tree_leaves(self.model.param_defs())]
        self._pod_comm = self.mesh.comm("pod")
        self._scale_comms = tuple(self.mesh.comm(a) for a in axes)

    def init_state(self, seed, *, device=None, param_dtype=torch.float32,
                   params=None) -> dict:
        """The same params on every pod (drawn from ``seed``, or ``params``
        given), sharded at birth within the pod, zero moments, and this
        rank's zero error-feedback residuals (float32)."""
        st = create_train_state(self.model, seed, self.opt_cfg, self.mesh,
                                self.sub_rules, device=device,
                                param_dtype=param_dtype, params=params)
        st["err"] = init_compression_state(st["params"])["err"]
        return st

    def __call__(self, state, batch):
        """``batch``: the whole batch on the host, (B, S) a leaf; its rows
        split over the pods and each pod's ``"data"`` ranks, its positions
        over ``"model"`` (the rank cuts its block).  Returns ``(state,
        {"loss", "lr", "grad_norm", "wire_bytes", "fp32_bytes"})``, the
        loss the pods' mean."""
        dev = tree_leaves(state["params"])[0].device
        local = {k: shard_leaf(v, self._batch_spec, self.mesh).to(dev)
                 for k, v in batch.items()}
        loss, _, grads = self.grads_of(state["params"], local)
        self.tm.finish_grads(grads)                 # summed within the pod
        n = self.n_pods
        wire = fp32 = 0
        if self.compress:
            mean, state["err"] = compressed_psum(
                grads, state["err"], self._pod_comm,
                scale_comms=self._scale_comms)
            wire = n * sum(size + 4 for size in self._sizes)
            fp32 = n * sum(size * 4 for size in self._sizes)
        else:
            acc = tree_map(lambda g: g.to(torch.float64), grads)
            all_reduce_many(tree_leaves(acc), self._pod_comm)
            mean = tree_map(lambda a: (a / n).to(torch.float32), acc)
        del grads
        _, _, stats = adamw_update(state["params"], mean, state["opt"],
                                   self.opt_cfg, self.tm)
        losses = self._pod_comm.all_gather(loss.reshape(()).to(torch.float32))
        out = {"loss": float(losses.double().mean()),
               **{k: float(v) for k, v in stats.items()},
               "wire_bytes": wire, "fp32_bytes": fp32}
        return state, out


def make_pod_dp_step(model, opt_cfg: AdamWConfig, mesh, rules: AxisRules, *,
                     compress: bool = True) -> PodDPStep:
    """The pod data-parallel step of ``model`` on a ``("pod", "data",
    "model")`` ``mesh`` with its ``rules``
    (:func:`repro_torch.mesh.rules_for_mesh`)."""
    return PodDPStep(model, opt_cfg, mesh, rules, compress)
