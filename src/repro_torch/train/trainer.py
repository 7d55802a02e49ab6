"""Trainer: the paper's ``parallel_time_integration`` as the spine of a
training loop (the reference's ``repro.train.trainer``).

    initialize         -> build or restore the TrainState
    do_timestep        -> the train step (its kernels on the card)
    finalize_timestep  -> checkpoint cadence + NaN guard
    finalize           -> the history and the straggler steps

The loop itself is :func:`repro_torch.core.time_integration.
parallel_time_integration`: a training run and a DMC walker simulation
drive the same generic function with different user functions.

With ``mesh=`` / ``rules=`` every rank of the mesh runs the same loop on
its shards (the state sharded at birth, checkpoints gathered and written
by rank 0, restored by every rank onto its shards, the NaN guard reading
the global loss); only rank 0 logs, and each rank's straggler watchdog
reads its own step times.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional

from repro_torch.core.runtime import straggler_deadline
from repro_torch.core.time_integration import parallel_time_integration
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault import NanGuard
from repro_torch.train.state import create_train_state, state_shardings
from repro_torch.train.step import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    log_every: int = 10
    accum_steps: int = 1
    grad_sync: str = "gspmd"            # gspmd | compressed (pod_dp's)
    nan_guard: bool = True
    straggler_factor: float = 3.0       # host-level step-deadline watchdog
    resume: bool = True


class Trainer:
    """Fit ``model`` on ``data_iter``'s batches: ``seed`` draws the params
    on ``device`` (or ``params``, bridged weights, start it).  On a
    ``mesh`` (with its ``rules``) ``data_iter`` yields this rank's blocks
    (:func:`repro_torch.data.make_data_iter` with the mesh)."""

    def __init__(self, model, opt_cfg: AdamWConfig, tcfg: TrainerConfig,
                 data_iter: Iterator[dict], *, mesh=None, rules=None,
                 seed=0, device=None, params: Optional[dict] = None,
                 log: Callable[[str], None] = print):
        self.model, self.opt_cfg, self.tcfg = model, opt_cfg, tcfg
        self.data_iter = data_iter
        self.mesh, self.rules = mesh, rules
        self.seed, self.device, self.params = seed, device, params
        self.rank = 0 if mesh is None else mesh.world.rank()
        self.log = log if self.rank == 0 else (lambda s: None)
        self.step_fn = make_train_step(model, opt_cfg, mesh, rules,
                                       accum_steps=tcfg.accum_steps,
                                       grad_sync=tcfg.grad_sync)
        self.shardings = (state_shardings(model, mesh, rules)
                          if mesh is not None else None)
        self.start_step = 0
        self.metrics_history: list[dict] = []
        self.stragglers: list[int] = []
        self._guard = (NanGuard(tcfg.ckpt_dir, self.shardings)
                       if (tcfg.nan_guard and tcfg.ckpt_dir) else None)
        self._data_skip = 0

    # -- the three user functions handed to the generic loop ---------------

    def _initialize(self):
        state = create_train_state(self.model, self.seed, self.opt_cfg,
                                   self.mesh, self.rules, device=self.device,
                                   params=self.params)
        self.params = None                       # the state holds them now
        if (self.tcfg.resume and self.tcfg.ckpt_dir
                and ckpt_lib.latest_checkpoint(self.tcfg.ckpt_dir)
                is not None):
            state, step = ckpt_lib.restore_checkpoint(
                self.tcfg.ckpt_dir, state, shardings=self.shardings)
            self.start_step = step
            self.log(f"[trainer] resumed from step {step}")
        return state, self.tcfg.steps - self.start_step

    def _do_timestep(self, state):
        batch = next(self.data_iter)
        if self._data_skip:                       # NaN rollback batch skip
            for _ in range(self._data_skip):
                batch = next(self.data_iter)
            self._data_skip = 0
        return self.step_fn(state, batch)

    def _finalize_timestep(self, state, step, obs):
        gstep = self.start_step + step + 1
        if self._guard is not None:
            rolled = self._guard.check(obs["loss"], state)
            if rolled is not None:
                state, rstep, skip = rolled
                self._data_skip = skip
                self.log(f"[trainer] NaN at step {gstep}; rolled back to "
                         f"{rstep}, skipping {skip} batch(es)")
                return state
        if self.tcfg.ckpt_dir and gstep % self.tcfg.ckpt_every == 0:
            ckpt_lib.save_checkpoint(self.tcfg.ckpt_dir, gstep, state,
                                     keep=self.tcfg.ckpt_keep,
                                     shardings=self.shardings)
        return state

    def _on_step_end(self, step, obs, stats):
        gstep = self.start_step + step + 1
        self.metrics_history.append(
            {"step": gstep, **{k: float(v) for k, v in obs.items()},
             "step_time": stats["step_time"]})
        times = [m["step_time"] for m in self.metrics_history]
        if len(times) >= 5:
            # the thread farm's re-dispatch deadline rule
            deadline = straggler_deadline(times, self.tcfg.straggler_factor)
            if stats["step_time"] > deadline:
                self.stragglers.append(gstep)
                self.log(f"[trainer] straggler step {gstep}: "
                         f"{stats['step_time']:.3f}s vs deadline "
                         f"{deadline:.3f}s")
        if gstep % self.tcfg.log_every == 0:
            self.log(f"[trainer] step {gstep} loss {float(obs['loss']):.4f} "
                     f"lr {float(obs.get('lr', 0)):.2e} "
                     f"({stats['step_time']:.3f}s)")

    def _finalize(self, outputs):
        return {"history": self.metrics_history,
                "stragglers": self.stragglers}

    # -- public --------------------------------------------------------------

    def fit(self):
        """Run the steps; ``{"history", "stragglers"}``.  The final state is
        ``self.final_state``, checkpointed when there is a ``ckpt_dir``."""
        result, stats = parallel_time_integration(
            self._initialize, self._do_timestep, self._finalize,
            finalize_timestep=self._finalize_timestep,
            on_step_end=self._on_step_end)
        self.final_state = stats["state"]
        if self.tcfg.ckpt_dir:
            gstep = self.start_step + len(self.metrics_history)
            ckpt_lib.save_checkpoint(self.tcfg.ckpt_dir, gstep,
                                     self.final_state,
                                     keep=self.tcfg.ckpt_keep,
                                     shardings=self.shardings)
        return result
