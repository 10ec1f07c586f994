"""Training (counterpart of the JAX package's training/): the G + D step
and its checkpoints."""
from .checkpoint import latest_checkpoint, restore_checkpoint, save_checkpoint
from .trainer import (
    Adam,
    AdamState,
    Trainer,
    TrainState,
    batch_to_device,
    cosine_annealing_restart_lr,
    make_schedule,
    multistep_lr,
    multistep_restart_lr,
    step_generator,
)

__all__ = ["Adam", "AdamState", "TrainState", "Trainer", "batch_to_device",
           "cosine_annealing_restart_lr", "latest_checkpoint",
           "make_schedule", "multistep_lr", "multistep_restart_lr",
           "restore_checkpoint", "save_checkpoint", "step_generator"]
