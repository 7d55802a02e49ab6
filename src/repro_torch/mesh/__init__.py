"""Training over a mesh of ``torch.distributed`` ranks: the logical-axis
rules (:mod:`repro_torch.mesh.axes`), ring attention and the GPipe
pipeline (plain PyTorch, as the reference's are plain ``jnp``), and the
collectives with gradients that the training forward runs
(:mod:`repro_torch.mesh.grad_comm`).  Counterpart of ``repro.mesh``."""
from repro_torch.mesh.axes import (LOGICAL_RULES_1POD, LOGICAL_RULES_2POD,
                                   AxisRules, logical_to_mesh,
                                   logical_to_sharding, rules_for_mesh)
from repro_torch.mesh.pipeline import bubble_fraction, pipeline_apply
from repro_torch.mesh.ring import ring_attention

__all__ = ["AxisRules", "LOGICAL_RULES_1POD", "LOGICAL_RULES_2POD",
           "bubble_fraction", "logical_to_mesh", "logical_to_sharding",
           "pipeline_apply", "ring_attention", "rules_for_mesh"]
