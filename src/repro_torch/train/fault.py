"""Fault tolerance of training: NaN rollback, corrupted-checkpoint
fallback and the host-level straggler re-dispatch (the reference's
``repro.train.fault``).

* **Numerical blow-up**: :class:`NanGuard` watches the loss; on NaN/inf it
  restores the latest *valid* checkpoint and skips ahead of the offending
  batch (the data pipeline is a pure function of the step, so skipping is
  an index bump).
* **Corrupted or partial checkpoint**: :func:`restore_latest_valid` walks
  the checkpoints newest first until one passes its CRCs.
* **Stragglers**: :func:`redispatch_stragglers` runs host-level tasks on
  the runtime's thread farm, which re-issues a task running past
  ``deadline_factor`` x the median to an idle worker (first completion
  wins); the trainer flags steps past the same deadline rule.
* **A change of node count** (preemption, repair, scale-up): a checkpoint
  is saved whole whatever mesh wrote it, and restores onto any other
  (``restore_checkpoint(..., shardings=)``); :func:`reshard_state` places
  a whole state onto a mesh's shardings.
  Resume is exact because the data pipeline is a pure function of the step.

On a mesh the loss the guard reads is the global one (every rank's), so
every rank rolls back together.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

from repro_torch.core.functional import host_task_farm
from repro_torch.models.module import shard_leaf
from repro_torch.train import checkpoint as ckpt


def redispatch_stragglers(tasks: Sequence[Callable[[], Any]], *,
                          deadline_factor: float = 3.0,
                          num_workers: int | None = None):
    """Run host-level tasks on the thread farm with backup re-dispatch of
    stragglers; ``(results, stats)``, ``stats["stragglers"]`` the
    re-issued indices."""
    return host_task_farm(tasks, num_workers=num_workers,
                          deadline_factor=deadline_factor)


def loss_is_bad(loss) -> bool:
    """NaN or infinite (a tensor is read on the host)."""
    x = float(loss)
    return math.isnan(x) or math.isinf(x)


def restore_latest_valid(ckpt_dir: str, state_like, shardings=None, *,
                         max_back: int = 5):
    """The newest of the last ``max_back`` committed checkpoints that
    restores; raises ``ValueError`` if none does."""
    steps = ckpt.checkpoint_steps(ckpt_dir)[::-1][:max_back]
    last_err: Exception | None = None
    for s in steps:
        try:
            return ckpt.restore_checkpoint(ckpt_dir, state_like, step=s,
                                           shardings=shardings)
        except (ValueError, OSError) as e:          # corrupted -> try older
            last_err = e
    raise ValueError(f"no valid checkpoint among steps {steps}: {last_err}")


def reshard_state(state, shardings):
    """Elastic scaling: place a whole ``state`` (the host's, one device's,
    or a checkpoint's restored without shardings) onto ``shardings`` (a
    layout from :func:`repro_torch.train.state.state_shardings`; None:
    whole), each leaf this rank's shard, a copy, requiring a gradient
    where the leaf does."""
    def place(t, sh):
        if isinstance(t, dict):
            return {k: place(v, None if sh is None else sh[k])
                    for k, v in t.items()}
        grad, t = t.requires_grad, t.detach()
        out = t if sh is None else shard_leaf(t, sh.spec, sh.mesh)
        out = out.clone() if out is t else out
        return out.requires_grad_(grad)
    return place(state, shardings)


@dataclasses.dataclass
class NanGuard:
    """Loss watchdog with rollback-and-skip; after ``max_rollbacks``
    consecutive rollbacks it raises (the failure is systematic)."""
    ckpt_dir: str
    shardings: Any = None
    max_rollbacks: int = 3
    skip_batches: int = 1
    _consecutive: int = 0

    def check(self, loss, state_like):
        """None if healthy, else ``(restored_state, restored_step,
        data_skip)`` after rolling back."""
        if not loss_is_bad(loss):
            self._consecutive = 0
            return None
        self._consecutive += 1
        if self._consecutive > self.max_rollbacks:
            raise FloatingPointError(
                f"loss NaN persisted through {self.max_rollbacks} rollbacks")
        state, step = restore_latest_valid(self.ckpt_dir, state_like,
                                           self.shardings)
        return state, step, self.skip_batches
