"""The reference's imperative model API over the port's ``Trainer`` (the
counterpart of the JAX package's model_api.py; the reference's
models/base_model.py:14-323 and models/appmotioncomp_model.py:108-756):
feed_data / optimize_parameters / test / get_current_visuals / save /
resume_training. Batches are NHWC float32 numpy, as the loaders give them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .utils.registry import MODEL_REGISTRY


@MODEL_REGISTRY.register()
class AppMotionCompModel:
    def __init__(self, opt: Dict[str, Any], device="cuda"):
        from .training import Trainer

        self.opt = opt
        self.is_train = opt.get("is_train", True)
        self.seed = int(opt.get("manual_seed", 0))
        self.trainer = Trainer(opt, device=device, seed=self.seed)
        self.device = self.trainer.device
        self.log_dict: Dict[str, float] = {}
        self.batch: Optional[Dict[str, torch.Tensor]] = None
        self.output: Optional[torch.Tensor] = None

    # ---------------- data ----------------

    def feed_data(self, data: Dict[str, np.ndarray]):
        """(appmotioncomp_model.py:110-113) Keeps the batch on the
        device."""
        from .training import batch_to_device

        self.batch = batch_to_device(data, self.device)

    # ---------------- training ----------------

    def optimize_parameters(self, current_iter: int):
        """One G + D step (appmotioncomp_model.py:294-434), its random
        draws from ``step_generator(manual_seed, current_iter)`` as in the
        training entry point."""
        from .training import step_generator

        logs = self.trainer.train_step(
            self.batch, generator=step_generator(self.seed, current_iter,
                                                 self.device))
        self.log_dict = {k: float(v) for k, v in logs.items()}

    def get_current_log(self) -> Dict[str, float]:
        return self.log_dict

    # ---------------- inference / eval ----------------

    def test(self, w: float = 1.0) -> torch.Tensor:
        """The evaluation forward with the EMA generator
        (appmotioncomp_model.py:437-456); (B, 3, H, W)."""
        self.output = self.trainer.ema_forward(
            self.batch["source"], self.batch["driving"], w=w)
        return self.output

    def get_current_visuals(self) -> Dict[str, np.ndarray]:
        """result, source and gt as NHWC float32 numpy."""
        def nhwc(t):
            return t.permute(0, 2, 3, 1).float().cpu().numpy()

        return {"result": nhwc(self.output),
                "source": nhwc(self.batch["source"]),
                "gt": nhwc(self.batch["driving"])}

    # ---------------- persistence ----------------

    def save(self, epoch: int, current_iter: int) -> str:
        """A checkpoint of the whole training state under
        ``path.training_states``; ``current_iter`` is the trainer's step."""
        from .training import save_checkpoint

        return save_checkpoint(self.opt["path"]["training_states"],
                               self.trainer, epoch)

    def resume_training(self, resume_path: str) -> int:
        """Load a checkpoint; returns its epoch."""
        from .training import restore_checkpoint

        return restore_checkpoint(resume_path, self.trainer)


def build_model(opt: Dict[str, Any], device="cuda"):
    """The model class named by ``opt['model_type']`` (models/__init__.py:
    19-30)."""
    return MODEL_REGISTRY.get(opt["model_type"])(opt, device=device)
