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
* **A change of node count** (:func:`reshard_state`) needs a mesh: it
  comes with ROADMAP A13b.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

from repro_torch.core.functional import host_task_farm
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
    """Elastic scaling onto a new mesh: comes with ROADMAP A13b."""
    raise NotImplementedError("resharding a train state onto a mesh comes "
                              "with ROADMAP A13b")


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
