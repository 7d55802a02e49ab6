"""Result collection — the paper's ``collect_subproblem_output_args``.

Counterpart of ``repro.core.collect``.  In MPI the master rank loops over
``recv``; in SPMD the same effect is an ``all_gather`` (every rank ends up
with the global result; any rank can then play the paper's "master"
role).  A host-side paper-faithful variant is kept for heterogeneous
(non-tensor) outputs produced by the host-level task farm.
"""
from __future__ import annotations

from torch.utils import _pytree as pytree


def collect_subproblem_output_args(my_output, comm, *, tiled: bool = True):
    """SPMD collection: gather each leaf's leading (local-task) axis.

    ``comm`` is a :class:`repro_torch.core.comm.Comm` (or SerialComm).
    Returns the globally-ordered stacked outputs (rank-major order, matching
    the paper's rank-ordered recv loop).
    """
    return pytree.tree_map(lambda x: comm.all_gather(x, tiled=tiled),
                           my_output)


def collect_host_outputs(per_rank_outputs: list[list]) -> list:
    """Paper-faithful host-side collection: concatenate rank-ordered lists."""
    out: list = []
    for chunk in per_rank_outputs:
        out.extend(chunk)
    return out


def unpad_leading(tree, n_valid: int):
    """Drop padding rows added by
    :func:`repro_torch.core.partition.pad_leading`."""
    return pytree.tree_map(lambda x: x[:n_valid], tree)
