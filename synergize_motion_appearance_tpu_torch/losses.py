"""Losses of the training step, NCHW.

Counterpart of the JAX package's losses/losses.py (reference
basicsr/losses/losses.py) for the terms its trainer builds: ``L1Loss``,
``GANLoss``, ``MultiScalePyramidPerceptualLoss``, ``EquivarianceLoss`` and
``KPDistanceLoss``; and ``LPIPSLoss``, which no shipped config reads. As
there, the perceptual loss takes its VGG as an
argument of every call, so the caller chooses its weights and dtype.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .models.dense_motion import inv2x2
from .ops import antialias_downsample, tps_jacobian, tps_warp_coordinates


class L1Loss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        if reduction not in ("mean", "sum"):
            raise NotImplementedError(f"reduction={reduction!r}")
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target):
        diff = (pred - target).abs()
        return self.loss_weight * (diff.mean() if self.reduction == "mean"
                                   else diff.sum())


class GANLoss:
    """hinge / vanilla / lsgan / wgan / wgan_softplus (losses.py:418-520).
    The discriminator's loss is not weighted; the generator's is."""

    def __init__(self, gan_type="hinge", real_label_val=1.0,
                 fake_label_val=0.0, loss_weight=1.0):
        if gan_type not in ("hinge", "vanilla", "lsgan", "wgan",
                            "wgan_softplus"):
            raise NotImplementedError(gan_type)
        self.gan_type = gan_type
        self.real_label_val = real_label_val
        self.fake_label_val = fake_label_val
        self.loss_weight = loss_weight

    def __call__(self, pred, target_is_real: bool, is_disc: bool = False):
        t = self.gan_type
        label = self.real_label_val if target_is_real else self.fake_label_val
        if t == "hinge":
            if is_disc:
                x = -pred if target_is_real else pred
                loss = F.relu(1.0 + x).mean()
            else:
                loss = -pred.mean()
        elif t == "vanilla":
            # binary cross-entropy on logits, written as the JAX package
            # writes it
            loss = (pred.clamp(min=0) - pred * label
                    + torch.log1p(torch.exp(-pred.abs()))).mean()
        elif t == "lsgan":
            loss = ((pred - label) ** 2).mean()
        elif t == "wgan":
            loss = -pred.mean() if target_is_real else pred.mean()
        else:  # wgan_softplus
            loss = F.softplus(-pred if target_is_real else pred).mean()
        return loss if is_disc else loss * self.loss_weight


class MultiScalePyramidPerceptualLoss:
    """FOMM pyramid VGG19 loss (losses.py:292-339): an anti-alias pyramid
    at ``scales``, L1 between the VGG slices of prediction and target,
    weighted per slice; the target's features carry no gradient."""

    def __init__(self, scales=(1, 0.5, 0.25, 0.125),
                 loss_weights=(1.0,) * 5):
        self.scales = tuple(scales)
        self.loss_weights = tuple(loss_weights)

    def __call__(self, vgg, pred, target):
        return self.from_target_feats(vgg, pred,
                                      self.target_features(vgg, target))

    def target_features(self, vgg, target):
        """The target's VGG slices at every scale, computed once per step
        and shared by every perceptual term of the step."""
        with torch.no_grad():
            return [vgg(antialias_downsample(target, s)) for s in self.scales]

    def from_target_feats(self, vgg, pred, target_feats):
        total = 0.0
        for scale, y_feats in zip(self.scales, target_feats):
            x_feats = vgg(antialias_downsample(pred, scale))
            for w, xf, yf in zip(self.loss_weights, x_feats, y_feats):
                total = total + w * (xf - yf.detach()).abs().mean()
        return total


class EquivarianceLoss:
    """Keypoint equivariance under a random TPS warp (losses.py:523-560):
    the value term compares the driving keypoints with the warped
    keypoints of the warped frame, the Jacobian term J_d^-1 (J_tps J_t)
    with the identity."""

    def __init__(self, loss_weight_value=1.0, loss_weight_jacobian=1.0,
                 transform_params: Optional[Dict] = None, use_value=True,
                 use_jacobian=True):
        self.use_value = use_value
        self.use_jacobian = use_jacobian
        self.loss_weight_value = loss_weight_value
        self.loss_weight_jacobian = loss_weight_jacobian
        self.transform_params = dict(transform_params or {})

    def __call__(self, kp_driving, transformed_kp, tps_params):
        l_value = 0.0
        l_jacobian = None
        if self.use_value:
            warped = tps_warp_coordinates(tps_params, transformed_kp["value"])
            l_value = self.loss_weight_value * (
                kp_driving["value"] - warped).abs().mean()
        if self.use_jacobian:
            if "jacobian" not in transformed_kp:  # a KeyError in JAX too
                raise KeyError("EquivarianceLoss(use_jacobian=True) needs "
                               "keypoint Jacobians: the detector is built "
                               "with estimate_jacobian=False")
            jac_t = tps_jacobian(tps_params, transformed_kp["value"])
            jacobian_transformed = jac_t @ transformed_kp["jacobian"]
            value = inv2x2(kp_driving["jacobian"].float()) @ \
                jacobian_transformed
            eye = torch.eye(2, device=value.device)
            l_jacobian = self.loss_weight_jacobian * (eye - value).abs().mean()
        return l_value, l_jacobian


class KPDistanceLoss:
    """Keypoints closer than 0.2 are counted (losses.py:596-616). Like the
    reference it goes through sign(), so its gradient is zero: a telemetry
    term, reproduced as it is."""

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, kp_driving, kp_source):
        def dist_loss(kp):
            d = kp[:, :, None, :] - kp[:, None, :, :]
            dist = torch.sqrt((d * d).sum(-1) + 1e-8)
            eye = torch.eye(kp.shape[1], device=kp.device) * 0.2
            return (-torch.sign(dist + eye - 0.2) + 1.0).mean()

        return self.loss_weight * (dist_loss(kp_source["value"])
                                   + dist_loss(kp_driving["value"]))


class LPIPSLoss:
    """LPIPS training loss (losses.py:389-415) on the port's LPIPS-VGG16
    (metrics/lpips.py), its weights found as the LPIPS metric finds them
    (SAMT_LPIPS_WEIGHTS / SAMT_WEIGHTS_DIR); without them construction
    raises a RuntimeError that names the file. NCHW inputs; the network is
    moved to the inputs' device and dtype at each call."""

    def __init__(self, loss_weight=1.0, use_input_norm=True,
                 range_norm=False, **_):
        from .metrics.external import lpips_net

        self.net = lpips_net("cpu").requires_grad_(False)
        self.loss_weight = loss_weight
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm

    def __call__(self, x, gt):
        # The reference's chain: optional [-1, 1] -> [0, 1], then (by
        # default) ImageNet mean/std, then lpips.LPIPS(normalize=False),
        # whose ScalingLayer runs on the already normalized input; the
        # network here applies that same ScalingLayer, so the reference's
        # double normalization is kept.
        if self.range_norm:
            x = (x + 1.0) / 2.0
            gt = (gt + 1.0) / 2.0
        if self.use_input_norm:
            mean = torch.tensor([0.485, 0.456, 0.406], dtype=x.dtype,
                                device=x.device).view(1, 3, 1, 1)
            std = torch.tensor([0.229, 0.224, 0.225], dtype=x.dtype,
                               device=x.device).view(1, 3, 1, 1)
            x = (x - mean) / std
            gt = (gt - mean) / std
        net = self.net.to(x.device, x.dtype)
        return self.loss_weight * net(x, gt.detach()).mean()
