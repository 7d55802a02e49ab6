"""Work partitioning: the paper's ``simple_partitioning`` ±1 rule.

Counterpart of the host half of ``repro.core.partition``: ``length`` items
over ``num_procs`` parts gives ``length // num_procs`` each, with the first
``length % num_procs`` parts getting one extra.  The mesh helpers (padding,
sharding) come with the runtime's mesh executor.
"""
from __future__ import annotations

import numpy as np


def simple_partitioning(length: int, num_procs: int) -> np.ndarray:
    """Paper-faithful: balanced part sizes (numpy int array of len num_procs)."""
    sublengths = np.full(num_procs, length // num_procs, dtype=np.int64)
    sublengths[: length % num_procs] += 1
    return sublengths


def partition_offsets(length: int, num_procs: int) -> np.ndarray:
    """Start offset of each part (len num_procs + 1)."""
    sizes = simple_partitioning(length, num_procs)
    return np.concatenate([[0], np.cumsum(sizes)])
