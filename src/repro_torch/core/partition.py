"""Work partitioning: the paper's ``simple_partitioning`` ±1 rule and its
SPMD form.

Counterpart of ``repro.core.partition``: ``length`` items over
``num_procs`` parts gives ``length // num_procs`` each, with the first
``length % num_procs`` parts getting one extra.  The mesh executor pads a
stacked task tree to a multiple of the world size instead
(:func:`pad_leading`, with a valid-task mask) and hands rank ``r`` its
equal share of the rows (:func:`shard_tasks`): torch has no sharding
object, so a rank holds only its own rows.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree


def simple_partitioning(length: int, num_procs: int) -> np.ndarray:
    """Paper-faithful: balanced part sizes (numpy int array of len num_procs)."""
    sublengths = np.full(num_procs, length // num_procs, dtype=np.int64)
    sublengths[: length % num_procs] += 1
    return sublengths


def partition_offsets(length: int, num_procs: int) -> np.ndarray:
    """Start offset of each part (len num_procs + 1)."""
    sizes = simple_partitioning(length, num_procs)
    return np.concatenate([[0], np.cumsum(sizes)])


def get_subproblem_input_args(input_args: list, my_rank: int,
                              num_procs: int) -> list:
    """Paper-faithful host-side task-list split (works on any Python list)."""
    offs = partition_offsets(len(input_args), num_procs)
    return input_args[offs[my_rank]: offs[my_rank + 1]]


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m


def pad_leading(tree, target: int, fill=0):
    """Pad every leaf's leading axis to ``target`` rows; returns (tree, valid
    mask), the mask a bool tensor on the first leaf's device."""
    first = pytree.tree_leaves(tree)[0]
    n = first.shape[0]
    pad = target - n
    if pad < 0:
        raise ValueError(f"cannot pad {n} down to {target}")

    def _pad(x):
        rows = torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, rows])

    mask = torch.arange(target, device=first.device) < n
    return pytree.tree_map(_pad, tree), mask


def shard_tasks(tree, rank: int, size: int):
    """Rank ``rank``'s rows of a stacked task tree whose leading axis is a
    multiple of ``size``: the ``rank``-th of ``size`` equal parts."""
    n = pytree.tree_leaves(tree)[0].shape[0]
    if n % size:
        raise ValueError(f"{n} tasks do not split into {size} equal parts; "
                         "pad them first (pad_leading)")
    per = n // size
    return pytree.tree_map(lambda x: x[rank * per:(rank + 1) * per], tree)
