"""Training of the port's LM: optimizers, the train step, checkpoints,
gradient compression and the fault-tolerance runtime (``repro.train``'s
exports)."""

from repro_torch.train.optimizer import (
    AdamW,
    Adafactor,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
    make_schedule,
    wsd_schedule,
)
from repro_torch.train.loop import TrainState, init_train_state, make_eval_step, make_train_step
from repro_torch.train import checkpoint, compression, fault_tolerance

__all__ = [
    "AdamW", "Adafactor", "clip_by_global_norm", "cosine_schedule",
    "make_optimizer", "make_schedule", "wsd_schedule",
    "TrainState", "init_train_state", "make_eval_step", "make_train_step",
    "checkpoint", "compression", "fault_tolerance",
]
