"""The reference's imperative model API (the counterpart of the JAX
package's model_api.py; the reference's models/base_model.py:14-323,
models/appmotioncomp_model.py:108-756 and models/sr_model.py:13-209):
feed_data / optimize_parameters / test / get_current_visuals / save /
resume_training over the port's ``Trainer`` (``AppMotionCompModel``), and
the single-network ``SRModel``. Batches are NHWC float32 numpy, as the
loaders give them.

Inside a ``torch.distributed`` process group ``AppMotionCompModel`` is
the JAX one over its ``("data",)`` mesh (JAX model_api.py:34-52): every
rank is fed the global batch and keeps its slice
(``parallel.shard_batch``, which raises when the batch does not split
evenly), ``optimize_parameters`` is the trainer's global-batch step (the
gradients and logs averaged over the ranks), ``test`` and
``get_current_visuals`` return the global batch on every rank, gathered
in rank order, and ``save`` writes from rank 0 alone
(``training.save_checkpoint``). Outside a group the global batch is the
one process's. ``SRModel`` stays single-process, as the JAX one builds no
mesh.
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
        """(appmotioncomp_model.py:110-113) Keeps this rank's slice of the
        global batch on the device (the whole batch outside a process
        group)."""
        from .parallel import shard_batch
        from .training import batch_to_device

        self.batch = batch_to_device(shard_batch(
            {k: np.asarray(data[k]) for k in ("source", "driving")}),
            self.device)

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
        (appmotioncomp_model.py:437-456) on the global batch; (B, 3, H,
        W), gathered on every rank."""
        from .parallel import gather_batch

        self.output = gather_batch(self.trainer.ema_forward(
            self.batch["source"], self.batch["driving"], w=w))
        return self.output

    def get_current_visuals(self) -> Dict[str, np.ndarray]:
        """result, source and gt of the global batch as NHWC float32
        numpy."""
        from .parallel import gather_batch

        def nhwc(t):
            return gather_batch(t).permute(0, 2, 3, 1).float().cpu().numpy()

        return {"result": self.output.permute(0, 2, 3, 1).float().cpu()
                .numpy(),
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


def _main_output(out):
    """A network's image output: the reconstruction of a tuple
    (``VQAutoEncoder``'s codebook loss and stats are dropped), ``out`` of
    a dict."""
    if isinstance(out, tuple):
        out = out[0]
    if isinstance(out, dict):
        out = out.get("out", out)
    return out


@MODEL_REGISTRY.register()
class SRModel:
    """Generic single-network restoration model (sr_model.py:13-209), as
    the JAX package's ``SRModel`` runs it, e.g. stage-1 training of a
    ``VQAutoEncoder`` codebook: one Adam step of ``train.pixel_opt`` on
    ``network_g``'s image output, the EMA of its weights, ``test`` with
    the EMA weights, and PSNR/SSIM/L1 validation. As in the JAX step, no
    other loss enters: neither a ``perceptual_opt`` nor the codebook loss
    of a ``VQAutoEncoder``. Adam is ``training.Adam`` (optax's, eps 1e-8
    added after the square root) with ``optim_g``'s lr (default 2e-4) and
    betas (default [0.9, 0.99]). The weights are made from ``manual_seed``
    on the CPU; ``load_network`` replaces them."""

    def __init__(self, opt: Dict[str, Any], device="cuda"):
        from .losses import build_loss
        from .models import build_network
        from .training import Adam

        self.opt = opt
        self.is_train = opt.get("is_train", True)
        self.device = torch.device(device)
        torch.manual_seed(int(opt.get("manual_seed", 0)))
        self.net_g = build_network(opt["network_g"]).to(self.device)
        self.cri_pix = None
        self.ema_decay = 0.0
        if self.is_train:
            t = opt["train"]
            optim_g = t.get("optim_g", {})
            self.lr = float(optim_g.get("lr", 2e-4))
            # the JAX SRModel's optax.adam takes no weight decay
            self.adam = Adam({"betas": optim_g.get("betas", [0.9, 0.99])})
            self.ema_decay = float(t.get("ema_decay", 0))
            if t.get("pixel_opt"):
                self.cri_pix = build_loss(t["pixel_opt"])
        self.log_dict: Dict[str, float] = {}
        self.batch: Optional[Dict[str, torch.Tensor]] = None
        self.output: Optional[torch.Tensor] = None
        self.load_network(self.net_g.state_dict())

    def load_network(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """``network_g``'s weights from ``state_dict`` (``strict=True``),
        e.g. one of ``weights.network_state_dict``; the EMA restarts from
        them and Adam from zero."""
        from .training import AdamState

        self.net_g.load_state_dict(state_dict, strict=True)
        params = dict(self.net_g.named_parameters())
        self.adam_state = AdamState.zeros(params)
        self.ema = ({k: p.detach().clone() for k, p in params.items()}
                    if self.ema_decay > 0 else None)

    def feed_data(self, data: Dict[str, np.ndarray]):
        """``lq`` and, if given, ``gt``: NHWC numpy -> NCHW float32 on the
        model's device."""
        self.batch = {k: torch.from_numpy(np.ascontiguousarray(
            data[k], np.float32)).to(self.device).permute(0, 3, 1, 2)
            .contiguous() for k in ("lq", "gt") if k in data}

    def optimize_parameters(self, current_iter: int):
        params = dict(self.net_g.named_parameters())
        out = _main_output(self.net_g(self.batch["lq"]))
        total = torch.zeros((), device=self.device)
        logs = {}
        if self.cri_pix is not None:
            logs["l_pix"] = self.cri_pix(out, self.batch["gt"])
            total = total + logs["l_pix"]
        logs["l_total"] = total
        grads = (torch.autograd.grad(total, list(params.values()),
                                     allow_unused=True)
                 if total.requires_grad else [None] * len(params))
        self.adam.step(self.adam_state, params, {
            k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)}, self.lr)
        if self.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                ema = list(self.ema.values())
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, torch._foreach_mul(
                    [params[k] for k in self.ema], 1 - d))
        self.log_dict = {k: float(v.detach()) for k, v in logs.items()}

    def get_current_log(self) -> Dict[str, float]:
        return self.log_dict

    def test(self) -> torch.Tensor:
        """``network_g`` on ``lq`` with the EMA weights when there are
        some; (B, 3, H, W)."""
        from torch.func import functional_call

        with torch.no_grad():
            if self.ema is not None:
                out = functional_call(self.net_g, self.ema,
                                      (self.batch["lq"],))
            else:
                out = self.net_g(self.batch["lq"])
        self.output = _main_output(out)
        return self.output

    def get_current_visuals(self) -> Dict[str, np.ndarray]:
        """result, lq and (if fed) gt as NHWC float32 numpy."""
        vis = {"result": self.output}
        vis.update(self.batch)
        return {k: t.permute(0, 2, 3, 1).float().cpu().numpy()
                for k, t in vis.items()}

    def nondist_validation(self, dataloader, current_iter, tb_logger=None,
                           save_img=False):
        """The mean over a loader of {lq, gt} batches of each metric of
        ``val.metrics`` on the first image of each batch
        (sr_model.py:128-185)."""
        from .metrics import calculate_metric
        from .utils.img_util import arr2img

        metric_opts = (self.opt.get("val") or {}).get("metrics") or {}
        results = {name: 0.0 for name in metric_opts}
        n = 0
        for data in dataloader:
            self.feed_data(data)
            self.test()
            vis = self.get_current_visuals()
            sr = arr2img(vis["result"][0])
            gt = arr2img(vis["gt"][0])
            for name, m_opt in metric_opts.items():
                results[name] += calculate_metric({"img1": sr, "img2": gt},
                                                  m_opt)
            n += 1
        return {k: v / max(n, 1) for k, v in results.items()}


def build_model(opt: Dict[str, Any], device="cuda"):
    """The model class named by ``opt['model_type']`` (models/__init__.py:
    19-30)."""
    return MODEL_REGISTRY.get(opt["model_type"])(opt, device=device)
