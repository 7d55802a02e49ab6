"""Deterministic synthetic data: the reference's ``repro.data.pipeline``,
bit for bit in its tokens and labels.

Batch ``i`` is a pure function of ``(seed, i)``: restoring a checkpoint at
step ``i`` reproduces the stream with no loader state to save.  Tokens
follow a noisy affine bigram chain (``next = (31 * prev + 7) mod V`` with
probability 0.9, uniform otherwise), so a model trained on it shows a
falling loss.  The draws are the reference's ``jax.random`` calls through
:mod:`repro_torch.serve.prng` (threefry, the same bits), so both packages
give the same batches.

The reference makes a batch inside ``jit`` and, with a mesh, sharded at
birth; here a batch is made on the host (the chain is a sequential scan of
a few thousand steps over a handful of rows) and moved to the step's
device in one copy.  With a mesh each rank cuts its own block of every
leaf on the host (the batch specs' ``("batch", "seq")`` through the
mesh's rules: rows over ``"data"``, or ``("pod", "data")`` on two pods,
and positions over ``"model"``) and moves only that: the whole batch never
reaches a device.

The modality frontends are stubs, as in the reference: a VLM batch carries
precomputed image-patch embeddings in front of its text, an audio batch
precomputed frame embeddings, each ``sin(cls * 0.1 + i * 0.01 + j *
0.05)`` of a class id drawn a row (at row ``i``, channel ``j``), so they
are informative features, not noise.  The float32 sum is the reference's,
in its order; ``torch.sin`` and ``jnp.sin`` differ by at most one float32
ulp on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.mesh.axes import AxisRules, logical_to_mesh
from repro_torch.models.module import shard_leaf, torch_dtype
from repro_torch.serve import prng


@dataclasses.dataclass(frozen=True)
class SyntheticTask:
    """A deterministic synthetic "dataset" for one (arch, shape) cell."""
    cfg: ModelConfig
    batch: int
    seq_len: int
    seed: int = 0
    noise: float = 0.1

    def _chain(self, key, B: int, S: int, vocab: int) -> torch.Tensor:
        """The noisy affine bigram chain: (B, S) int32."""
        k0, k1, k2 = prng.split(key, 3)
        prev = prng.randint(k0, (B,), 0, vocab).long()
        flip = prng.uniform(k1, (B, S)) < torch.tensor(self.noise,
                                                       dtype=torch.float32)
        rand = prng.randint(k2, (B, S), 0, vocab).long()
        toks = torch.empty(B, S, dtype=torch.int64)
        for t in range(S):
            prev = torch.where(flip[:, t], rand[:, t], (31 * prev + 7) % vocab)
            toks[:, t] = prev
        return toks.to(torch.int32)

    def _features(self, key, n: int) -> torch.Tensor:
        """(B, n, d) embeddings of a class id a row drawn from
        ``fold_in(key, 1)``, in the config's compute dtype."""
        cfg = self.cfg
        cls = prng.randint(prng.fold_in(key, 1), (self.batch, 1, 1), 0, 64)
        x = (cls.to(torch.float32) * 0.1
             + torch.arange(n)[None, :, None] * 0.01
             + torch.arange(cfg.d_model)[None, None, :] * 0.05)
        return torch.sin(x).to(torch_dtype(cfg.dtype))

    def batch_at(self, step: int) -> dict:
        """Pure function (seed, step) -> the batch on the host: int32
        ``{"tokens", "labels"}`` (B, S); a VLM's tokens are its S - I
        text positions after ``"image_embeds"`` (B, I, d), and its labels'
        first I are -1 (not scored); an audio batch adds ``"frames"`` (B,
        F, d)."""
        cfg = self.cfg
        key = prng.fold_in(prng.PRNGKey(self.seed), step)
        B = self.batch
        if cfg.family == "vlm":
            I = cfg.n_image_tokens
            if self.seq_len <= I:
                raise ValueError(
                    f"{cfg.name}: seq_len={self.seq_len} counts the {I} "
                    "image rows and must exceed them (--seq)")
            toks = self._chain(key, B, self.seq_len - I + 1, cfg.vocab)
            labels = torch.cat([torch.full((B, I), -1, dtype=torch.int32),
                                toks[:, 1:]], dim=1)
            return {"tokens": toks[:, :-1],
                    "image_embeds": self._features(key, I),
                    "labels": labels}
        toks = self._chain(key, B, self.seq_len + 1, cfg.vocab)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.family == "audio":
            batch["frames"] = self._features(key, cfg.n_audio_frames)
        return batch


def make_batch_fn(task: SyntheticTask, mesh=None,
                  rules: AxisRules | None = None, batch_specs=None, *,
                  device=None):
    """``step -> batch`` on ``device`` (the host's tensors if None).  With a
    ``mesh``, its ``rules`` and the model's ``batch_specs``
    (``train_batch_specs``), this rank's block of each leaf."""
    specs = None
    if mesh is not None:
        if rules is None or batch_specs is None:
            raise ValueError("a sharded batch needs the mesh's rules and the "
                             "model's train_batch_specs")
        specs = {k: logical_to_mesh(sp.spec, rules)
                 for k, sp in batch_specs.items()}

    def fn(step: int) -> dict:
        batch = task.batch_at(step)
        if specs is not None:
            batch = {k: shard_leaf(v, specs[k], mesh)
                     for k, v in batch.items()}
        if device is None:
            return batch
        return {k: v.to(device, non_blocking=True) for k, v in batch.items()}
    return fn


def make_data_iter(task: SyntheticTask, mesh=None, rules=None,
                   batch_specs=None, *, device=None,
                   start_step: int = 0) -> Iterator[dict]:
    """Batches ``start_step, start_step + 1, ...`` of ``task`` (this rank's
    blocks on a mesh: :func:`make_batch_fn`)."""
    fn = make_batch_fn(task, mesh, rules, batch_specs, device=device)
    step = start_step
    while True:
        yield fn(step)
        step += 1


def host_shard_batch(batch: dict, my_rank: int, num_procs: int) -> dict:
    """This rank's slice of the batch axis (the paper's
    ``get_subproblem_input_args``): rows ``[r * B/n, (r + 1) * B/n)``."""
    def split(x):
        per = x.shape[0] // num_procs
        return x[my_rank * per:(my_rank + 1) * per]
    return {k: split(v) for k, v in batch.items()}
