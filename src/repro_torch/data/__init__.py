"""Deterministic synthetic training data (the reference's
``repro.data``)."""
from repro_torch.data.pipeline import (SyntheticTask, host_shard_batch,
                                       make_batch_fn, make_data_iter)

__all__ = ["SyntheticTask", "host_shard_batch", "make_batch_fn",
           "make_data_iter"]
