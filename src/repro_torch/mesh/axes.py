"""Logical-axis sharding rules (MaxText-style): one generic mapping from
*logical* tensor axes to mesh axes in place of per-tensor hand sharding.
Counterpart of ``repro.mesh.axes``, rule for rule.

Baseline scheme:

* batch          -> ("data",) / ("pod", "data")     pure DP
* seq            -> "model"                          sequence parallelism:
                    a rank's queries are its block of positions; K/V are
                    gathered over "model" (cheap under GQA, and no head
                    count needs to divide the axis)
* kv_seq         -> "model"                          decode caches along
                    the sequence
* mlp/vocab/experts/inner/rwkv_v -> "model"          the weights' storage
                    split over "model"
* embed_w        -> "data"                           ZeRO-3 storage of every
                    weight's d_model dim, gathered a layer at a time
* everything else unsharded.

A mesh here is :class:`repro_torch.core.comm.Mesh` (the ranks of a
``torch.distributed`` world on named axes), and a mesh spec is the tuple
:func:`repro_torch.models.module.mesh_spec` returns and
:func:`repro_torch.models.module.shard_leaf` takes: one entry a tensor
axis, a mesh axis name, a tuple of them (major first) or None.  The
reference's ``logical_to_sharding`` (a ``NamedSharding``) is
:class:`Sharding`.  Its ``constrain`` has no counterpart: an eager rank
holds concrete shards, and the training forward
(:class:`repro_torch.mesh.grad_comm.TrainMesh`) moves them with explicit
collectives where GSPMD would insert them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class AxisRules:
    rules: Mapping[str, Any]  # logical name -> mesh axis (str | tuple | None)
    mesh: Any = None          # the Mesh these rules target (None = serial)

    def get(self, name):
        if name is None:
            return None
        if name not in self.rules:
            raise KeyError(f"unknown logical axis {name!r}")
        return self.rules[name]

    def replace(self, **updates) -> "AxisRules":
        d = dict(self.rules)
        d.update(updates)
        return AxisRules(d, self.mesh)

    def with_mesh(self, mesh) -> "AxisRules":
        return AxisRules(self.rules, mesh)


_BASE = {
    # activations
    "batch": ("data",),
    "seq": "model",          # sequence parallelism
    "kv_seq": "model",       # decode KV caches along sequence
    "embed": None,
    "q_heads": None,         # exact head counts kept; heads not split
    "kv_heads": None,
    "head_dim": None,
    "expert_cap": None,
    "frames": None,
    # weights
    "embed_w": "data",       # ZeRO-3 storage axis of weight d_model dims
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_embed": "data",  # expert-weight d_model dim (train mode)
    "expert_mlp": None,      # expert-weight ff dim: "data" for the
                             # weight-stationary expert-TP decode mode
    "layers": None,
    "state": None,
    "conv_k": None,
    "inner": "model",        # mamba d_inner channels / heads
    "ssm_heads": "model",    # mamba head axis (d_inner/head_dim)
    "rwkv_v": "model",       # rwkv per-head value channels
}

LOGICAL_RULES_1POD = AxisRules(dict(_BASE))
LOGICAL_RULES_2POD = AxisRules({**_BASE, "batch": ("pod", "data")})


def rules_for_mesh(mesh, overrides: Mapping[str, Any] | None = None
                   ) -> AxisRules:
    """The rules of ``mesh`` (two-pod rules when it has a ``"pod"`` axis),
    with ``overrides``, bound to the mesh."""
    rules = LOGICAL_RULES_2POD if "pod" in mesh.axis_names \
        else LOGICAL_RULES_1POD
    if overrides:
        rules = rules.replace(**overrides)
    return rules.with_mesh(mesh)


def serial_rules() -> AxisRules:
    """Single-device rules (smoke tests): everything replicated."""
    return AxisRules({k: None for k in _BASE})


def logical_to_mesh(spec, rules: AxisRules) -> tuple:
    """A logical spec (one name or None an axis) -> the mesh spec tuple."""
    return tuple(rules.get(ax) for ax in spec)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout on a mesh: the reference's ``NamedSharding``.
    ``spec`` is a mesh spec (:func:`logical_to_mesh`); a rank holds
    :func:`repro_torch.models.module.shard_leaf` of the whole tensor."""
    mesh: Any
    spec: tuple


def logical_to_sharding(spec, mesh, rules: AxisRules) -> Sharding:
    """:class:`Sharding` of a logical spec on ``mesh``."""
    return Sharding(mesh, logical_to_mesh(spec, rules))


def strip_axis(rules: AxisRules, axis: str) -> AxisRules:
    """Rules with every reference to ``axis`` removed (code that runs on a
    sub-mesh without it, e.g. the pod data-parallel step)."""
    out = {}
    for k, v in rules.rules.items():
        if v == axis:
            v = None
        elif isinstance(v, (tuple, list)):
            v = tuple(a for a in v if a != axis) or None
        out[k] = v
    return AxisRules(out, rules.mesh)
