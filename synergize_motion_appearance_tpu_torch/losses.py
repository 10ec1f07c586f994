"""Losses of the training steps, NCHW, and their registry.

Counterpart of the JAX package's losses/losses.py (reference
basicsr/losses/losses.py): its 13 losses, registered in ``LOSS_REGISTRY``
under the same names and built by ``build_loss``, and its three gradient
penalties on torch autograd. As there, the perceptual losses take their
VGG as an argument of every call, so the caller chooses its weights and
dtype; and a weight map makes the ``mean`` reduction a weighted mean.
Where the JAX package draws from a key, the port draws from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .models.dense_motion import inv2x2
from .ops import antialias_downsample, tps_jacobian, tps_warp_coordinates
from .utils.registry import LOSS_REGISTRY


def _reduce(x, reduction):
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def _weight_reduce(loss, weight, reduction):
    """weight_reduce_loss (loss_util.py:25-54), NCHW: with a weight map and
    reduction='mean' the normaliser is the weight's mass (times C for a
    1-channel map), not the element count, so masked-out pixels do not
    dilute the loss; reduction='none' returns the weighted loss."""
    if weight is not None:
        loss = loss * weight
    if weight is None or reduction == "sum":
        return _reduce(loss, reduction)
    if reduction == "mean":
        denom = weight.sum()
        if weight.shape[1] == 1 and loss.shape[1] != 1:
            denom = denom * loss.shape[1]
        return loss.sum() / denom
    return loss


@LOSS_REGISTRY.register(name="L1Loss")
class L1Loss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * _weight_reduce(
            (pred - target).abs(), weight, self.reduction)


@LOSS_REGISTRY.register(name="MSELoss")
class MSELoss:
    def __init__(self, loss_weight=1.0, reduction="mean"):
        self.loss_weight = loss_weight
        self.reduction = reduction

    def __call__(self, pred, target, weight=None):
        return self.loss_weight * _weight_reduce(
            (pred - target) ** 2, weight, self.reduction)


@LOSS_REGISTRY.register(name="CharbonnierLoss")
class CharbonnierLoss:
    def __init__(self, loss_weight=1.0, reduction="mean", eps=1e-12):
        self.loss_weight = loss_weight
        self.reduction = reduction
        self.eps = eps

    def __call__(self, pred, target, weight=None):
        diff = torch.sqrt((pred - target) ** 2 + self.eps)
        return self.loss_weight * _weight_reduce(diff, weight,
                                                 self.reduction)


@LOSS_REGISTRY.register(name="WeightedL1Loss")
class WeightedL1Loss:
    """L1 over lists of predictions and targets, item i of n weighted by
    gamma ** (n - i - 1) (losses.py:62-93)."""

    def __init__(self, loss_weight=1.0, reduction="mean", gamma=0.9):
        self.loss_weight = loss_weight
        self.reduction = reduction
        self.gamma = gamma

    def __call__(self, preds, targets, weight=None):
        n = len(preds)
        loss = 0.0
        for i in range(n):
            loss = loss + _weight_reduce(
                (preds[i] - targets[i]).abs(), weight, self.reduction
            ) * self.gamma ** (n - i - 1)
        return self.loss_weight * loss


@LOSS_REGISTRY.register(name="WeightedTVLoss")
class WeightedTVLoss:
    """Weighted total variation (losses.py:160-177): the means of the
    vertical and horizontal differences, each weighted by the map cropped
    to its shape."""

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, pred, weight=None):
        wy = None if weight is None else weight[:, :, :-1, :]
        wx = None if weight is None else weight[:, :, :, :-1]
        dy = (pred[:, :, :-1, :] - pred[:, :, 1:, :]).abs()
        dx = (pred[:, :, :, :-1] - pred[:, :, :, 1:]).abs()
        return self.loss_weight * (_weight_reduce(dx, wx, "mean")
                                   + _weight_reduce(dy, wy, "mean"))


@LOSS_REGISTRY.register(name="GANLoss")
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


@LOSS_REGISTRY.register(name="MultiScalePyramidPerceptualLoss")
class MultiScalePyramidPerceptualLoss:
    """FOMM pyramid VGG19 loss (losses.py:292-339): an anti-alias pyramid
    at ``scales``, L1 between the VGG slices of prediction and target,
    weighted per slice; the target's features carry no gradient.
    ``num_channels`` is the config's, and unused, as in the JAX loss."""

    def __init__(self, scales=(1, 0.5, 0.25, 0.125), num_channels=3,
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


@LOSS_REGISTRY.register(name="PerceptualLoss")
class PerceptualLoss:
    """Named-layer VGG perceptual loss and Gram-matrix style loss
    (losses.py:180-289) over the five taps of ``VGG19Features``, as the
    JAX loss reads them: ``relu{k}_1`` and ``conv1_2``, ``conv2_2``,
    ``conv3_4``, ``conv4_4``, ``conv5_4`` both name tap k - 1, and an
    unknown name is skipped. ``criterion`` is ``l1``, ``l2``/``mse`` or
    ``fro`` (the 2-norm of the flattened difference); the Gram matrix is
    divided by c*h*w. Returns (perceptual * perceptual_weight, style *
    style_weight, or None when style_weight is 0)."""

    _LAYER_IDX = {"relu1_1": 0, "relu2_1": 1, "relu3_1": 2,
                  "relu4_1": 3, "relu5_1": 4,
                  "conv1_2": 0, "conv2_2": 1, "conv3_4": 2,
                  "conv4_4": 3, "conv5_4": 4}

    def __init__(self, layer_weights, perceptual_weight=1.0,
                 style_weight=0.0, criterion="l1", range_norm=False, **_):
        if criterion not in ("l1", "l2", "mse", "fro"):
            raise NotImplementedError(criterion)
        self.layer_weights = dict(layer_weights)
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion = criterion
        self.range_norm = range_norm

    def _crit(self, a, b):
        if self.criterion == "l1":
            return (a - b).abs().mean()
        if self.criterion in ("l2", "mse"):
            return ((a - b) ** 2).mean()
        return torch.linalg.vector_norm((a - b).reshape(-1))

    @staticmethod
    def _gram(x):
        b, c, h, w = x.shape
        f = x.reshape(b, c, h * w)
        return f @ f.transpose(1, 2) / (c * h * w)

    def __call__(self, vgg, x, gt):
        if self.range_norm:
            x = (x + 1) / 2
            gt = (gt + 1) / 2
        xf = vgg(x)
        with torch.no_grad():
            gf = [f.detach() for f in vgg(gt)]
        percep = 0.0
        style = 0.0
        for name, w in self.layer_weights.items():
            i = self._LAYER_IDX.get(name)
            if i is None:
                continue
            if self.perceptual_weight > 0:
                percep = percep + self._crit(xf[i], gf[i]) * w
            if self.style_weight > 0:
                style = style + self._crit(self._gram(xf[i]),
                                           self._gram(gf[i])) * w
        return (percep * self.perceptual_weight,
                style * self.style_weight if self.style_weight > 0
                else None)


@LOSS_REGISTRY.register(name="TPSM_EquivarianceLoss")
class TPSM_EquivarianceLoss:
    """TPS-motion-model variant (losses.py:562-581): the value term only,
    on the ``fg_kp`` keypoints."""

    def __init__(self, loss_weight=1.0, transform_params=None):
        self.loss_weight = loss_weight
        self.transform_params = transform_params

    def __call__(self, kp_driving, transformed_kp, tps_params):
        warped = tps_warp_coordinates(tps_params, transformed_kp["fg_kp"])
        return self.loss_weight * (kp_driving["fg_kp"] - warped).abs().mean()


@LOSS_REGISTRY.register(name="TPSM_BGLoss")
class TPSM_BGLoss:
    """Background-transform consistency (losses.py:583-594): the product
    of the two 3x3 transforms against the identity."""

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, bg_param, bg_param_reverse):
        value = bg_param @ bg_param_reverse
        eye = torch.eye(3, dtype=value.dtype,
                        device=value.device).reshape(1, 1, 3, 3)
        return self.loss_weight * (eye - value).abs().mean()


def _input_grad(d, x):
    """d(sum D(x))/dx, differentiable again. ``x`` is used as it is when
    it is part of a graph, else as a new leaf."""
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    return torch.autograd.grad(d(x).sum(), x, create_graph=True)[0]


def r1_penalty(d, real_img):
    """R1 gradient penalty (losses.py:618-632): the mean over the batch of
    ||d sum D(x) / dx||^2 at the real images. ``d``: images -> logits."""
    grad = _input_grad(d, real_img)
    return (grad.reshape(grad.shape[0], -1) ** 2).sum(dim=1).mean()


def _draw_path_noise(shape, generator, device, dtype):
    """Standard normal noise of g_path_regularize."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=dtype)


def g_path_regularize(fake_img, latents_grad_fn, mean_path_length,
                      generator, decay=0.01):
    """StyleGAN2 path-length regularisation (losses.py:635-644).
    ``latents_grad_fn(noise)`` -> d sum(fake * noise) / d latents, (B, n,
    dim); the noise is drawn from ``generator`` and scaled by
    1 / sqrt(H * W). Returns (penalty, mean path length, new mean path
    length), the last two without gradient."""
    noise = _draw_path_noise(fake_img.shape, generator, fake_img.device,
                             fake_img.dtype) / math.sqrt(
        fake_img.shape[2] * fake_img.shape[3])
    grad = latents_grad_fn(noise)
    path_lengths = torch.sqrt((grad ** 2).sum(dim=2).mean(dim=1))
    path_mean = mean_path_length + decay * (
        path_lengths.mean() - mean_path_length)
    penalty = ((path_lengths - path_mean) ** 2).mean()
    return penalty, path_lengths.mean().detach(), path_mean.detach()


def _draw_alpha(n, generator, device, dtype):
    """(n, 1, 1, 1) uniform [0, 1) blend weights of gradient_penalty_loss."""
    return torch.rand((n, 1, 1, 1), generator=generator, device=device,
                      dtype=dtype)


def gradient_penalty_loss(d, real_data, fake_data, generator, weight=None):
    """WGAN-GP gradient penalty (losses.py:647-683): the mean over the
    batch of (||d sum D(x) / dx|| - 1)^2 at random blends x of real and
    fake images, the blend weights drawn from ``generator``; with a
    weight map, the gradient is weighted and the penalty divided by the
    map's mean."""
    alpha = _draw_alpha(real_data.shape[0], generator, real_data.device,
                        real_data.dtype)
    grad = _input_grad(d, alpha * real_data + (1 - alpha) * fake_data)
    if weight is not None:
        grad = grad * weight
    gp = ((torch.linalg.vector_norm(grad.reshape(grad.shape[0], -1), dim=1)
           - 1) ** 2).mean()
    if weight is not None:
        gp = gp / weight.mean()
    return gp


@LOSS_REGISTRY.register(name="EquivarianceLoss")
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


@LOSS_REGISTRY.register(name="KPDistanceLoss")
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


@LOSS_REGISTRY.register(name="LPIPSLoss")
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


def build_loss(opt: Dict[str, Any], **extra):
    """The loss named by ``opt['type']``, built from the rest of ``opt``
    and ``extra`` (losses.py:450)."""
    opt = dict(opt)
    return LOSS_REGISTRY.get(opt.pop("type"))(**opt, **extra)
