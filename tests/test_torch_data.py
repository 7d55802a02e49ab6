"""The port's synthetic training data against the reference's, bit for
bit: ``prng.randint`` against ``jax.random.randint`` (int32: spans below
and above 2**16, a negative minval, an empty range, host and tensor
keys), and ``SyntheticTask`` batches (SMOKE and full vocabularies, several
seeds and steps); ``make_data_iter`` (a rank's block on a mesh too) and
``host_shard_batch``."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data import SyntheticTask as JTask
from repro.data import host_shard_batch as jhost_shard_batch
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import (SyntheticTask, host_shard_batch,
                              make_data_iter)
from repro_torch.mesh.axes import rules_for_mesh
from repro_torch.models.api import build_model
from repro_torch.serve import prng


class _At:
    """One rank's place on a ``("data", "model")`` mesh: what cutting its
    block of a batch reads (``Mesh.index``)."""
    axis_names = ("data", "model")

    def __init__(self, coords, shape):
        self.coords, self.shape = coords, shape

    def index(self, axes):
        idx, n = 0, 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            idx, n = idx * self.shape[a] + self.coords[a], n * self.shape[a]
        return idx, n


@pytest.mark.parametrize("seed,shape,lo,hi", [
    (0, (7,), 0, 151936), (3, (4, 5), 0, 512), (5, (3,), -4, 9),
    (1, (6,), 5, 5), (2, (100,), 0, 64), (9, (50,), 0, 70000),
    (4, (2, 33), 0, 262144), (6, (8,), -2**31, 2**31 - 1)])
def test_randint_bit_for_bit(seed, shape, lo, hi):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    want = np.asarray(jax.random.randint(key, shape, lo, hi))
    host = prng.randint(prng.fold_in(prng.PRNGKey(seed), 2), shape, lo, hi)
    dev = prng.randint(prng.fold_in(prng.PRNGKey(seed, device="cpu"), 2),
                       shape, lo, hi)
    assert host.dtype == dev.dtype == torch.int32
    np.testing.assert_array_equal(host.numpy(), want)
    np.testing.assert_array_equal(dev.numpy(), want)


def test_randint_refuses_out_of_int32():
    with pytest.raises(OverflowError):
        prng.randint(prng.PRNGKey(0), (2,), 0, 2**31)


@pytest.mark.parametrize("arch,smoke,B,S,seed", [
    ("qwen3-1.7b", True, 4, 32, 0), ("qwen3-1.7b", False, 2, 300, 1),
    ("gemma3-4b", False, 1, 64, 7), ("qwen2-7b", True, 3, 9, 3)])
def test_synthetic_batches_bit_for_bit(arch, smoke, B, S, seed):
    jcfg = jax_smoke_config(arch) if smoke else jax_get_config(arch)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    jtask = JTask(jcfg, batch=B, seq_len=S, seed=seed)
    task = SyntheticTask(cfg, batch=B, seq_len=S, seed=seed)
    for step in (0, 1, 17):
        want, got = jtask.batch_at(step), task.batch_at(step)
        assert sorted(got) == sorted(want) == ["labels", "tokens"]
        for k in want:
            assert got[k].dtype == torch.int32 and got[k].shape == (B, S)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_data_iter_and_host_shard():
    cfg = smoke_config("qwen3-1.7b")
    task = SyntheticTask(cfg, batch=4, seq_len=8)
    it = make_data_iter(task, device="cpu", start_step=3)
    for step in (3, 4):
        b = next(it)
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      task.batch_at(step)["tokens"].numpy())
    batch = task.batch_at(0)
    for rank in range(2):
        got = host_shard_batch(batch, rank, 2)
        want = jhost_shard_batch({k: v.numpy() for k, v in batch.items()},
                                 rank, 2)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    with pytest.raises(NotImplementedError, match="A13b"):
        SyntheticTask(smoke_config("whisper-tiny"), 1, 8).batch_at(0)
    # on a mesh a rank's batch is its block: rows over "data", positions
    # over "model" (here rank (1, 1) of a (2, 2) mesh)
    rank = _At({"data": 1, "model": 1}, {"data": 2, "model": 2})
    rules = rules_for_mesh(rank)
    specs = build_model(cfg).train_batch_specs(
        type("S", (), {"global_batch": 4, "seq_len": 8})())
    got = next(make_data_iter(task, rank, rules, specs, device="cpu",
                              start_step=3))
    for k, v in task.batch_at(3).items():
        np.testing.assert_array_equal(got[k].numpy(), v[2:, 4:].numpy())
