"""Training of the port: the train state, the train and eval steps,
checkpoints in the reference's layout, fault tolerance and the trainer
over the paper's time-integration loop, on one device or over a mesh of
``torch.distributed`` ranks (ZeRO-3 state, sequence parallelism), and the
pod data-parallel step with int8 gradient exchange
(:mod:`repro_torch.train.pod_dp`)."""
from repro_torch.train.checkpoint import (checkpoint_steps,
                                          latest_checkpoint,
                                          restore_checkpoint,
                                          save_checkpoint)
from repro_torch.train.fault import NanGuard, reshard_state
from repro_torch.train.state import (TrainState, create_train_state,
                                     state_shardings)
from repro_torch.train.step import make_eval_step, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

__all__ = ["NanGuard", "TrainState", "Trainer", "TrainerConfig",
           "checkpoint_steps", "create_train_state", "latest_checkpoint",
           "make_eval_step", "make_train_step", "reshard_state",
           "restore_checkpoint", "save_checkpoint", "state_shardings"]
