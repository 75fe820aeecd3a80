"""Training of the port (port of :mod:`repro.train`): the coreset-selected
train step and numpy checkpoints in the reference's file format."""

from repro_torch.train.trainer import TrainState, make_eval_step, make_train_step, train_state_init
from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint

__all__ = [
    "TrainState",
    "train_state_init",
    "make_train_step",
    "make_eval_step",
    "save_checkpoint",
    "load_checkpoint",
]
