"""One G + D training step of the reenactment model, in PyTorch.

Counterpart of the JAX package's training/trainer.py (reference
models/appmotioncomp_model.py:108-434 and models/base_model.py): the motion
forward, the generator forward, the 10-term generator loss with the
adaptive GAN weight, the generator and motion updates, the EMA, and the
discriminator update, with the same gating as the JAX step:
- the discriminator trains from ``step > net_d_start_iter``, the
  generator from ``step >= net_g_start_iter``; a gated optimizer keeps its
  moments and its step count, and its network keeps its BatchNorm
  statistics;
- a step whose generator loss is not finite updates nothing.

State lives in PyTorch's way: the parameters and BatchNorm statistics are
those of the trainer's modules and are updated in place; ``TrainState``
holds the step, the EMA of the generator and the three Adam states.

Mixed precision as in the JAX step (``compute_dtype: bfloat16``): the
generator and the VGG pyramid run on bfloat16 casts of the float32 master
weights, cast inside the graph (so gradients land in float32); the motion
networks and the discriminator stay float32; losses are float32.

``remat`` (the JAX step's rematerialization, trainer.py:239-268, 479-513)
wraps what the JAX step wraps, the generator forward and the perceptual
loss, in ``torch.utils.checkpoint``: ``true`` recomputes their every
activation in the backward; ``selective`` saves the outputs of
convolutions (``aten.convolution``, ``samt::conv3x3``), matmuls and the
attention op, and of ``grid_sampler_2d`` (the JAX names ``conv_out``,
``dense_out`` and ``warp_corners``) and recomputes the rest. The motion
estimator is not wrapped, so no BatchNorm runs twice. Values do not
change, only memory does. The port's default is ``false``: every shipped
option file but the tiny one sets the key, and the JAX default (``true``)
was chosen for a v5e's 16 GB.

Data parallel, the counterpart of the JAX step over its data-sharded batch:
in a ``torch.distributed`` process group every rank runs this step on its
slice of the global batch, on the same weights. The networks are not
wrapped in ``DistributedDataParallel``, since the step takes its gradients
with ``torch.autograd.grad``; instead it averages over the ranks
(``parallel.all_reduce_mean``) the G + M gradients after the G phase, the
D gradients after the D phase, the adaptive weight's two probe gradients
before their norms, and the logs, whose global generator loss is the
nonfinite gate of every rank. BatchNorm takes the global batch's
statistics (``models.layers.BatchNorm2d``), and the equivariance loss's
TPS warp is drawn for the global batch and sliced, so the ranks together
compute the one-process step on the whole batch.
"""
from __future__ import annotations

import copy
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import weights
from ..losses import (EquivarianceLoss, GANLoss, KPDistanceLoss, L1Loss,
                      MultiScalePyramidPerceptualLoss)
from ..ops import (grid_sample, make_coordinate_grid, sample_random_tps,
                   tps_warp_frame_grid)
from ..parallel import (all_reduce_mean, broadcast_module, broadcast_tensors,
                        get_dist_info, in_process_group)


# ---------------------------------------------------------------------------
# learning-rate schedules of the global step, in float32 like the JAX ones
# ---------------------------------------------------------------------------

def multistep_lr(base_lr: float, milestones, gamma: float = 0.5):
    """MultiStepLR (models/lr_scheduler.py:6-33)."""
    milestones = sorted(milestones)

    def schedule(count: int) -> float:
        factor = np.float32(1.0)
        for m in milestones:
            factor = factor * np.float32(gamma if count >= m else 1.0)
        return float(np.float32(base_lr) * factor)

    return schedule


def multistep_restart_lr(base_lr: float, milestones, gamma: float = 0.1,
                         restarts=(0,), restart_weights=(1,)):
    """MultiStepRestartLR (models/lr_scheduler.py:6-33): at each restart
    the lr resets to base * weight; the milestones after the last restart
    multiply it by gamma."""
    milestones = sorted(milestones)
    restarts = list(restarts)
    restart_weights = list(restart_weights)
    if len(restarts) != len(restart_weights):
        raise ValueError("restarts and their weights do not match.")

    def schedule(count: int) -> float:
        w, last = np.float32(1.0), 0
        for r, rw in zip(restarts, restart_weights):
            if count >= r:
                w, last = np.float32(rw), r
        factor = np.float32(1.0)
        for m in milestones:
            if m > last and count >= m:
                factor = factor * np.float32(gamma)
        return float(np.float32(base_lr) * w * factor)

    return schedule


def cosine_annealing_restart_lr(base_lr: float, periods,
                                restart_weights=None, eta_min: float = 0.0):
    """CosineAnnealingRestartLR (models/lr_scheduler.py:57-96): cosine
    decay within each period, scaled by the period's restart weight; past
    the last period the lr stays at base_lr."""
    periods = list(periods)
    restart_weights = list(restart_weights or [1.0] * len(periods))
    if len(periods) != len(restart_weights):
        raise ValueError("periods and their restart weights do not match.")
    cum = np.cumsum([0] + periods)

    def schedule(count: int) -> float:
        for i, period in enumerate(periods):
            if cum[i] <= count < cum[i + 1]:
                t = np.float32((count - cum[i]) / period)
                return float(np.float32(eta_min) + np.float32(
                    restart_weights[i] * 0.5 * (base_lr - eta_min))
                    * (np.float32(1.0) + np.cos(np.float32(math.pi) * t)))
        return float(np.float32(base_lr))

    return schedule


def make_schedule(opt_cfg: Dict[str, Any], sched_cfg: Dict[str, Any],
                  warmup_iter: int = -1) -> Callable[[int], float]:
    """The lr of an optimizer as a function of the global step
    (base_model.py:144-165); ``warmup_iter > 0`` ramps it up linearly."""
    lr = float(opt_cfg.get("lr", 8e-5))
    kind = (sched_cfg or {}).get("type")
    if kind == "MultiStepLR":
        schedule = multistep_lr(lr, sched_cfg.get("milestones", []),
                                float(sched_cfg.get("gamma", 0.5)))
    elif kind == "MultiStepRestartLR":
        schedule = multistep_restart_lr(
            lr, sched_cfg.get("milestones", []),
            float(sched_cfg.get("gamma", 0.1)),
            sched_cfg.get("restarts", (0,)),
            sched_cfg.get("restart_weights", (1,)))
    elif kind == "CosineAnnealingRestartLR":
        schedule = cosine_annealing_restart_lr(
            lr, sched_cfg.get("periods", []),
            sched_cfg.get("restart_weights"),
            float(sched_cfg.get("eta_min", 0.0)))
    else:
        def schedule(count: int) -> float:
            return float(np.float32(lr))
    if warmup_iter > 0:
        base = schedule

        def schedule(count: int) -> float:
            return float(np.float32(base(count)) * np.float32(
                min(count / warmup_iter, 1.0)))
    return schedule


# ---------------------------------------------------------------------------
# Adam, as optax.scale_by_adam with the lr applied from the global step
# ---------------------------------------------------------------------------

@dataclass
class AdamState:
    count: int                    # updates applied so far
    mu: Dict[str, torch.Tensor]   # first moments, by parameter name
    nu: Dict[str, torch.Tensor]   # second moments

    @classmethod
    def zeros(cls, params: Dict[str, torch.Tensor]) -> "AdamState":
        return cls(0, {k: torch.zeros_like(p) for k, p in params.items()},
                   {k: torch.zeros_like(p) for k, p in params.items()})


class Adam:
    """``optax.scale_by_adam(b1, b2, eps=1e-8)``, chained with
    ``optax.add_decayed_weights(weight_decay)`` when the option dict's
    ``weight_decay`` is above 0, then ``p -= lr * u``, in the JAX
    package's order of float32 operations (training/trainer.py:144,
    167-169): the decay ``weight_decay * p`` is added to the
    bias-corrected Adam direction and scaled by the lr with it, not added
    to the gradient. Multi-tensor (``torch._foreach_*``) kernels, in
    place."""

    def __init__(self, opt_cfg: Dict[str, Any], eps: float = 1e-8):
        self.b1, self.b2 = (float(b) for b in opt_cfg.get("betas",
                                                          [0.9, 0.99]))
        self.eps = eps
        self.weight_decay = float(opt_cfg.get("weight_decay", 0.0))

    @torch.no_grad()
    def step(self, state: AdamState, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], lr: float) -> None:
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        state.count += 1
        # mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        bc1 = np.float32(1.0) - np.float32(self.b1) ** np.float32(state.count)
        bc2 = np.float32(1.0) - np.float32(self.b2) ** np.float32(state.count)
        denom = torch._foreach_div(nu, float(bc2))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, float(bc1))
        torch._foreach_div_(upd, denom)
        if self.weight_decay > 0:  # u + wd * p
            torch._foreach_add_(upd, torch._foreach_mul(p, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(p, upd)


@dataclass
class TrainState:
    step: int
    ema_g: Dict[str, torch.Tensor]
    opt_g: AdamState
    opt_m: AdamState
    opt_d: AdamState


def _strip(cfg: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """A loss option dict without its 'type' key (not changed in place)."""
    cfg = dict(cfg or {})
    cfg.pop("type", None)
    return cfg


def _cast(tree, dtype):
    """Every floating tensor of a nested dict / list / tuple in ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree


def _params(module) -> Dict[str, torch.Tensor]:
    return dict(module.named_parameters())


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A loader's batch ({'source', 'driving'}: (B, H, W, 3) float32 numpy,
    NHWC) as the (B, 3, H, W) float32 tensors on ``device`` that
    ``Trainer.train_step`` takes."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k], np.float32))
            .to(device).permute(0, 3, 1, 2).contiguous()
            for k in ("source", "driving")}


def step_generator(seed: int, iteration: int, device) -> torch.Generator:
    """The generator of one step's random draws (the TPS warp), on
    ``device``, seeded from (seed + 1000, iteration): the counterpart of
    the JAX entry point's ``fold_in(PRNGKey(seed + 1000), iteration)``, so
    a resumed run draws what an uninterrupted one draws."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed + 1000) << 32) + iteration)
    return g


def _buffers(module) -> Dict[str, torch.Tensor]:
    return {k: b.clone() for k, b in module.named_buffers()}


@torch.no_grad()
def _restore_buffers(module, saved: Dict[str, torch.Tensor]) -> None:
    for k, b in module.named_buffers():
        b.copy_(saved[k])


def _saved_ops():
    """The ops whose outputs selective remat keeps: JAX's ``conv_out``
    (convolutions, K3), ``dense_out`` (matmuls, K1 and K2) and
    ``warp_corners`` (the warps)."""
    aten, samt = torch.ops.aten, torch.ops.samt
    ops = {aten.convolution.default, aten.mm.default, aten.addmm.default,
           aten.bmm.default, aten.grid_sampler_2d.default,
           samt.conv3x3.default, samt.fused_attention_packed.default,
           samt.fused_attention.default}
    if hasattr(aten, "cudnn_grid_sampler"):
        ops.add(aten.cudnn_grid_sampler.default)
    return frozenset(ops)


def _selective_policy(saved, ctx, func, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if func in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def parse_remat(value):
    """An option file's ``train.remat``: False, True or 'selective', as
    the JAX trainer reads it (absent means False here)."""
    return value if value == "selective" else bool(value)


class Trainer:
    """Builds the networks and losses from a reference-style option dict
    (``opt['network_g']``, ``['network_motion_estimator']``,
    ``['network_d']``, ``['train']``) on ``device`` and runs
    ``train_step``. The networks get seeded random weights
    (``init_state``); ``weights.load_train_state`` loads a JAX TrainState
    instead."""

    def __init__(self, opt: Dict[str, Any], device="cuda", seed: int = 0):
        self.opt = opt
        self.device = torch.device(device)
        t = opt["train"]
        self.cri_pix = (L1Loss(**_strip(t["pixel_opt"]))
                        if t.get("pixel_opt") else None)
        self.cri_perceptual = None
        if t.get("perceptual_opt"):
            p = _strip(t["perceptual_opt"])
            self.cri_perceptual = MultiScalePyramidPerceptualLoss(
                scales=p.get("scales", (1, 0.5, 0.25, 0.125)),
                loss_weights=p.get("loss_weights", (1.0,) * 5))
        self.cri_gan = (GANLoss(**_strip(t["gan_opt"]))
                        if t.get("gan_opt") else None)
        self.w_motion_code = float(
            t.get("motion_codebook_code_opt", {}).get("loss_weight", 1.0))
        self.cri_motion_recon = (
            L1Loss(**_strip(t["motion_codebook_recon_opt"]))
            if t.get("motion_codebook_recon_opt") else None)
        self.w_app_code = float(
            t.get("app_codebook_code_opt", {}).get("loss_weight", 1.0))
        self.w_lr_list = list(
            t.get("lr_pixel_perceptual_opt", {}).get("loss_weight", []))
        self.cri_equivariance = (
            EquivarianceLoss(**_strip(t["equivariance_opt"]))
            if t.get("equivariance_opt") else None)
        self.cri_kp_distance = (
            KPDistanceLoss(**_strip(t["kp_distance_opt"]))
            if t.get("kp_distance_opt") else None)
        cd = t.get("compute_dtype")
        self.compute_dtype = (torch.bfloat16 if cd in ("bfloat16", "bf16")
                              else None)
        self.remat = parse_remat(t.get("remat", False))
        self._remat_context = (
            functools.partial(create_selective_checkpoint_contexts,
                              functools.partial(_selective_policy,
                                                _saved_ops()))
            if self.remat == "selective" else None)
        self.scale_adaptive_gan_weight = float(
            t.get("scale_adaptive_gan_weight", 0.8))
        self.net_d_start_iter = int(t.get("net_d_start_iter", 0))
        self.net_g_start_iter = int(t.get("net_g_start_iter", 0))
        self.ema_decay = float(t.get("ema_decay", 0))
        self.use_adaptive_weight = bool(t.get("use_adaptive_weight", True))
        sched = t.get("scheduler", {})
        warmup = int(t.get("warmup_iter", -1))
        opt_m = t.get("optim_motion", t["optim_g"])
        self.adam_g, self.adam_m, self.adam_d = (
            Adam(o) for o in (t["optim_g"], opt_m, t["optim_d"]))
        self.lr_g, self.lr_m, self.lr_d = (
            make_schedule(o, sched, warmup)
            for o in (t["optim_g"], opt_m, t["optim_d"]))
        self.init_state(seed)

    # ------------------------------------------------------------------
    def init_state(self, seed: int) -> None:
        """Seeded random weights for the four networks, fresh optimizer
        states, step 0; the VGG19 of the perceptual pyramid from
        ``train.vgg_weights`` when the key is set (the JAX
        ``Trainer.init_state``), loaded before the broadcast and the
        compute-dtype copy. In a process group every rank then takes rank
        0's weights (the JAX entry point's ``replicate``)."""
        g, me, d, vgg = weights.seeded_train_nets(self.opt, seed)
        vgg_path = self.opt["train"].get("vgg_weights")
        if vgg_path:
            from .checkpoint import load_vgg_weights

            state_dict = load_vgg_weights(str(vgg_path))
            try:
                vgg.load_state_dict(state_dict, strict=True)
            except RuntimeError as e:
                raise ValueError(f"train.vgg_weights={vgg_path}: {e}") from e
        self.net_g = g.to(self.device)
        self.motion_estimator = me.to(self.device).train()
        self.net_d = d.to(self.device).train()
        self.vgg = vgg.to(self.device).eval().requires_grad_(False)
        for net in (self.net_g, self.motion_estimator, self.net_d, self.vgg):
            broadcast_module(net)
        self.reset_optimizers()

    def broadcast_state(self) -> None:
        """Rank 0's weights, statistics, EMA and Adam moments in every
        rank (no-op outside a process group); after a restore."""
        for net in (self.net_g, self.motion_estimator, self.net_d, self.vgg):
            broadcast_module(net)
        if self.vgg_c is not self.vgg:
            broadcast_module(self.vgg_c)
        st = self.state
        broadcast_tensors(list(st.ema_g.values()) + [
            t for o in (st.opt_g, st.opt_m, st.opt_d)
            for t in list(o.mu.values()) + list(o.nu.values())])

    def reset_optimizers(self, step: int = 0) -> None:
        """EMA = the current generator weights, zero Adam states; also
        refreshes the compute-dtype copy of the VGG weights."""
        self.vgg_c = (copy.deepcopy(self.vgg).to(self.compute_dtype)
                      if self.compute_dtype is not None else self.vgg)
        self.state = TrainState(
            step=step,
            ema_g={k: p.detach().clone()
                   for k, p in self.net_g.named_parameters()},
            opt_g=AdamState.zeros(_params(self.net_g)),
            opt_m=AdamState.zeros(_params(self.motion_estimator)),
            opt_d=AdamState.zeros(_params(self.net_d)))

    @torch.no_grad()
    def ema_forward(self, source, driving, w: float = 1.0):
        """The evaluation forward (appmotioncomp_model.py:437-456): the
        motion estimator in eval mode, then the generator's inference
        forward on the EMA weights, in float32. (B, 3, H, W) frames in
        [-1, 1] on the trainer's device in and out. Every network's mode is
        put back afterwards: BatchNorm's mode decides the next step."""
        modes = [(m, m.training) for m in (self.net_g,
                                           self.motion_estimator,
                                           self.net_d)]
        try:
            self.motion_estimator.eval()
            self.net_g.eval()
            dense_motion = self.motion_estimator(driving, source)
            out = functional_call(self.net_g, self.state.ema_g,
                                  (source, dense_motion),
                                  {"w": w, "inference": True})
        finally:
            for m, mode in modes:
                m.train(mode)
        return out["out"]

    # ------------------------------------------------------------------
    def _g_forward(self, source, dense_motion, gt):
        """The generator's training forward, in the compute dtype on cast
        weights; outputs in float32."""
        cdt = self.compute_dtype
        if cdt is None:
            return self.net_g(source, dense_motion, w=1.0, gt=gt)
        cast = {k: p.to(cdt) for k, p in self.net_g.named_parameters()}
        out = functional_call(
            self.net_g, cast, (_cast(source, cdt), _cast(dense_motion, cdt)),
            {"w": 1.0, "gt": _cast(gt, cdt)})
        # the step reads no telemetry list: none is cast
        return _cast({k: v for k, v in out.items()
                      if k not in ("app_comp_list", "app_before_comp_list")},
                     torch.float32)

    def _percep(self, x, gt_feats):
        dt = self.compute_dtype or torch.float32
        return self.cri_perceptual.from_target_feats(
            self.vgg_c, x.to(dt), gt_feats).float()

    def _remat(self, fn, *args):
        """``fn(*args)``, rematerialized as ``remat`` says."""
        if not self.remat:
            return fn(*args)
        kw = ({} if self._remat_context is None
              else {"context_fn": self._remat_context})
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    def _probe_d_weight(self, pre_final, gt, gt_feats):
        """Adaptive GAN weight (appmotioncomp_model.py:222-228, 325-345):
        the ratio of the norms of the reconstruction loss's and the GAN
        loss's gradients with respect to the final RGB conv's kernel, each
        through that conv alone on the saved ``pre_final``, clipped to
        [0, 1]. In the compute dtype. The discriminator runs on copies of
        its BatchNorm statistics, whose train-mode updates are dropped."""
        dt = self.compute_dtype or torch.float32
        final = self.net_g.generator.blocks[-1]
        kern = final.weight.detach().to(dt).requires_grad_()
        bias = final.bias.detach().to(dt)
        h = pre_final.detach().to(dt)
        gt_c = gt.to(dt)

        def out_from(k):
            return F.conv2d(h, k, bias, padding=1)

        with torch.enable_grad():
            o = out_from(kern)
            r = 0.0
            if self.cri_perceptual is not None:
                r = r + self.cri_perceptual.from_target_feats(self.vgg_c, o,
                                                              gt_feats)
            if self.cri_pix is not None:
                r = r + self.cri_pix(o, gt_c)
            g_recon, = torch.autograd.grad(r, kern)
            d_vars = {k: v.detach().to(dt, copy=True) for k, v in
                      list(self.net_d.named_parameters())
                      + list(self.net_d.named_buffers())}
            pred = functional_call(self.net_d, d_vars, (out_from(kern),))
            g_gan, = torch.autograd.grad(
                self.cri_gan(pred, True, is_disc=False), kern)
        if in_process_group():  # the global batch's gradients, then norms
            g_recon, g_gan = all_reduce_mean(
                {"recon": g_recon.float(), "gan": g_gan.float()}).values()

        def norm(g):
            return g.float().pow(2).sum().sqrt()

        return (norm(g_recon) / (norm(g_gan) + 1e-4)).clamp(0.0, 1.0)

    # ------------------------------------------------------------------
    def train_step(self, batch: Dict[str, torch.Tensor],
                   tps=None, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` = {'source', 'driving'}: (B, 3, H, W)
        float32 frames in [-1, 1] on the trainer's device. The random TPS
        warp of the equivariance loss is ``tps`` (``ops.RandomTPSParams``)
        or drawn from ``generator``. Updates the modules and ``state`` in
        place; returns the logs as 0-d float32 tensors on the device.

        In a process group ``batch`` is this rank's slice of the global
        batch, ``tps`` (if given) the global batch's warp, and the logs are
        the global means.

        One host sync per step: whether the generator loss is finite
        decides, on the host, which updates apply. It is read after the
        discriminator's backward is queued."""
        st = self.state
        source, gt = batch["source"], batch["driving"]
        B, _, H, W = gt.shape
        rank, world = get_dist_info()
        grouped = in_process_group()
        step = st.step
        d_on = step > self.net_d_start_iter          # (:325, :414)
        g_on = step >= self.net_g_start_iter
        params_g = _params(self.net_g)
        params_m = _params(self.motion_estimator)
        params_d = _params(self.net_d)
        stats_m = _buffers(self.motion_estimator)
        stats_d = _buffers(self.net_d)
        logs: Dict[str, torch.Tensor] = {}

        gt_feats = None
        if self.cri_perceptual is not None:
            dt = self.compute_dtype or torch.float32
            gt_feats = self.cri_perceptual.target_features(self.vgg_c,
                                                           gt.to(dt))

        # ---- G phase ----
        dense_motion = self.motion_estimator(gt, source)
        out = self._remat(self._g_forward, source, dense_motion, gt)
        total = 0.0
        if self.cri_pix is not None:
            logs["l_g_pix"] = self.cri_pix(out["out"], gt)
            total = total + logs["l_g_pix"]
        if self.cri_perceptual is not None:
            logs["l_g_percep"] = self._remat(self._percep, out["out"],
                                             gt_feats)
            total = total + logs["l_g_percep"]
        if self.cri_gan is not None:
            fake_pred = self.net_d(out["out"])   # updates D's statistics
            l_g_gan = self.cri_gan(fake_pred, True, is_disc=False)
            if d_on and self.use_adaptive_weight:
                d_weight = self.scale_adaptive_gan_weight * \
                    self._probe_d_weight(out["pre_final"], gt, gt_feats)
            elif d_on:  # a fixed weight: no probe gradients (:543-553)
                d_weight = torch.full((), self.scale_adaptive_gan_weight,
                                      device=self.device)
            else:
                d_weight = torch.zeros((), device=self.device)
            total = total + d_weight * l_g_gan
            logs["d_weight"] = d_weight
            logs["l_g_gan"] = d_weight * l_g_gan
        if self.w_motion_code:
            logs["l_g_motion_codebook_code"] = sum(
                out["codebook_loss_motion_list"]) * self.w_motion_code
            total = total + logs["l_g_motion_codebook_code"]
        if self.cri_motion_recon is not None:
            hd, wd = out["deformation_list"][0].shape[1:3]
            grid = make_coordinate_grid(hd, wd, device=self.device)[None]
            l_mrecon = 0.0
            for recon, flow in zip(out["motion_recon_list"],
                                   out["deformation_list"]):
                l_mrecon = l_mrecon + self.cri_motion_recon(
                    recon, (flow - grid).detach())
            logs["l_g_motion_codebook_recon"] = l_mrecon
            total = total + l_mrecon
        for i, wlr in enumerate(self.w_lr_list):
            if self.cri_pix is not None:
                logs[f"l_g_pix_lr_{i}"] = self.cri_pix(out["out_lr"][i],
                                                       gt) * wlr
                total = total + logs[f"l_g_pix_lr_{i}"]
            if self.cri_perceptual is not None:
                logs[f"l_g_percep_lr_{i}"] = self._remat(
                    self._percep, out["out_lr"][i], gt_feats) * wlr
                total = total + logs[f"l_g_percep_lr_{i}"]
        if self.w_app_code > 0:
            logs["l_g_app_codebook_code"] = sum(
                out["codebook_loss_app_list"]) * self.w_app_code
            total = total + logs["l_g_app_codebook_code"]
        if self.cri_equivariance is not None:
            if tps is None:  # the global batch's draw
                tp = self.cri_equivariance.transform_params
                tps = sample_random_tps(generator, B * world,
                                        tp["sigma_affine"], tp["sigma_tps"],
                                        tp["points_tps"], device=self.device)
            tps = type(tps)(*(t.to(self.device) for t in tps))
            if tps.theta.shape[0] != B:  # this rank's slice of it
                tps = tps._replace(
                    theta=tps.theta[rank * B:(rank + 1) * B],
                    control_params=tps.control_params[rank * B:
                                                      (rank + 1) * B])
            transformed_frame = grid_sample(
                gt, tps_warp_frame_grid(tps, H, W), align_corners=False,
                padding_mode="reflection")
            transformed_kp = self.motion_estimator.estimate_kp(
                transformed_frame)
            l_eq_v, l_eq_j = self.cri_equivariance(
                dense_motion["kp_driving"], transformed_kp, tps)
            logs["l_equivariance_value"] = l_eq_v
            total = total + l_eq_v
            if l_eq_j is not None:
                logs["l_equivariance_jacobian"] = l_eq_j
                total = total + l_eq_j
        if self.cri_kp_distance is not None:
            logs["l_kpd"] = self.cri_kp_distance(dense_motion["kp_driving"],
                                                 dense_motion["kp_source"])
            total = total + logs["l_kpd"]
        logs["l_g_total"] = total
        grads = torch.autograd.grad(
            total, list(params_g.values()) + list(params_m.values()),
            allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in
                 zip(grads, list(params_g.values()) + list(params_m.values()))]
        grads_g = dict(zip(params_g, grads[:len(params_g)]))
        grads_m = dict(zip(params_m, grads[len(params_g):]))
        if grouped:
            red = iter(all_reduce_mean(
                {**{"g." + k: v for k, v in grads_g.items()},
                 **{"m." + k: v for k, v in grads_m.items()}}).values())
            grads_g = {k: next(red) for k in grads_g}
            grads_m = {k: next(red) for k in grads_m}

        # ---- D phase (:414-432), on the statistics the G phase left ----
        if self.cri_gan is not None:
            fake_img = out["out"].detach()
            real_pred = self.net_d(gt)
            l_d_real = self.cri_gan(real_pred, True, is_disc=True)
            fake_pred = self.net_d(fake_img)
            l_d_fake = self.cri_gan(fake_pred, False, is_disc=True)
            if d_on:  # before the onset the JAX step drops these grads
                grads_d = dict(zip(params_d, torch.autograd.grad(
                    l_d_real + l_d_fake, list(params_d.values()))))
                if grouped:
                    grads_d = all_reduce_mean(grads_d)
            logs.update(l_d_real=l_d_real, l_d_fake=l_d_fake,
                        out_d_real=real_pred.mean(),
                        out_d_fake=fake_pred.mean())

        # ---- updates ----
        if grouped:  # global means: the gate below is one for all ranks
            logs = all_reduce_mean({
                k: torch.as_tensor(v, device=self.device).detach().float()
                for k, v in logs.items()})
        finite = bool(torch.isfinite(logs["l_g_total"]))
        logs["step_skipped_nonfinite"] = torch.full(
            (), 0.0 if finite else 1.0, device=self.device)
        if g_on and finite:
            self.adam_g.step(st.opt_g, params_g, grads_g, self.lr_g(step))
            self.adam_m.step(st.opt_m, params_m, grads_m, self.lr_m(step))
        else:
            _restore_buffers(self.motion_estimator, stats_m)
        if self.ema_decay > 0:
            d = self.ema_decay
            ema = [st.ema_g[k] for k in params_g]
            with torch.no_grad():
                new = torch._foreach_mul(list(params_g.values()), 1.0 - d)
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, new)
        if self.cri_gan is not None and d_on and finite:
            self.adam_d.step(st.opt_d, params_d, grads_d, self.lr_d(step))
        else:
            _restore_buffers(self.net_d, stats_d)
        st.step += 1
        return {k: torch.as_tensor(v, device=self.device).detach().float()
                for k, v in logs.items()}

