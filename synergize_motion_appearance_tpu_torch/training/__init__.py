"""Training (counterpart of the JAX package's training/): the G + D step,
its checkpoints, and one network's trained weights for inference."""
from .checkpoint import (
    export_params,
    latest_checkpoint,
    load_variables,
    restore_checkpoint,
    save_checkpoint,
)
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
           "cosine_annealing_restart_lr", "export_params",
           "latest_checkpoint", "load_variables", "make_schedule",
           "multistep_lr", "multistep_restart_lr", "restore_checkpoint",
           "save_checkpoint", "step_generator"]
