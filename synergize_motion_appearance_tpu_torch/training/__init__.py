"""The training step (counterpart of the JAX package's training/)."""
from .trainer import (
    Adam,
    AdamState,
    Trainer,
    TrainState,
    cosine_annealing_restart_lr,
    make_schedule,
    multistep_lr,
    multistep_restart_lr,
)

__all__ = ["Adam", "AdamState", "TrainState", "Trainer",
           "cosine_annealing_restart_lr", "make_schedule", "multistep_lr",
           "multistep_restart_lr"]
