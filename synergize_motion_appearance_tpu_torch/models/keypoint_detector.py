"""Unsupervised keypoint detector (FOMM-style), NCHW.

Counterpart of the JAX package's models/keypoint_detector.py (reference
archs/keypoint_detector_arch.py:13-87): anti-alias downsample by
``scale_factor`` -> Hourglass -> 7x7 conv -> spatial softmax at
``temperature`` -> soft-argmax keypoints, plus (``estimate_jacobian``)
heatmap-weighted per-kp 2x2 Jacobians from a 7x7 conv initialised to zero
weight and identity bias: 4K channels, one map per keypoint, or with
``single_jacobian_map`` 4 channels, one map that every keypoint's heatmap
weighs. ``pad`` pads both 7x7 convs (0, as upstream, shrinks the maps by
6 pixels).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from ..ops import antialias_downsample, antialias_weight, softargmax_kp
from .motion_blocks import Hourglass


class AntiAliasInterpolation2d(nn.Module):
    """Gaussian blur + stride. Its (C, 1, k, k) kernel is a persistent
    buffer named ``weight``, as in the reference
    (motion_estimator_util.py:599-645)."""

    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.scale = scale
        self.register_buffer("weight", antialias_weight(channels, scale))

    def forward(self, x):
        return antialias_downsample(x, self.scale, self.weight)


class KPDetector(nn.Module):
    def __init__(self, block_expansion: int = 32, num_kp: int = 15,
                 num_channels: int = 3, max_features: int = 1024,
                 num_blocks: int = 5, temperature: float = 0.1,
                 estimate_jacobian: bool = True, scale_factor: float = 0.25,
                 single_jacobian_map: bool = False, pad: int = 0):
        super().__init__()
        self.num_kp = num_kp
        self.temperature = temperature
        self.scale_factor = scale_factor
        self.predictor = Hourglass(block_expansion, num_channels, num_blocks,
                                   max_features)
        self.kp = nn.Conv2d(self.predictor.out_filters, num_kp, 7,
                            padding=pad)
        if estimate_jacobian:
            self.num_jac = 1 if single_jacobian_map else num_kp
            self.jacobian = nn.Conv2d(self.predictor.out_filters,
                                      4 * self.num_jac, 7, padding=pad)
            with torch.no_grad():
                self.jacobian.weight.zero_()
                self.jacobian.bias.copy_(torch.tensor(
                    [1.0, 0.0, 0.0, 1.0] * self.num_jac))
        else:
            self.jacobian = None
        if scale_factor != 1:
            self.down = AntiAliasInterpolation2d(num_channels, scale_factor)

    def forward(self, image, pre_downsampled: bool = False
                ) -> Dict[str, torch.Tensor]:
        """image: (B, 3, H, W) in [-1, 1]. Returns {'value': (B, K, 2)},
        with ``estimate_jacobian`` also 'jacobian': (B, K, 2, 2).
        pre_downsampled=True skips the blur."""
        x = image
        if self.scale_factor != 1 and not pre_downsampled:
            x = self.down(x)
        feature_map = self.predictor(x)
        prediction = self.kp(feature_map)                  # (B, K, h, w)
        B, K, h, w = prediction.shape
        heatmap = torch.softmax(
            prediction.reshape(B, K, h * w) / self.temperature, dim=2)
        heatmap = heatmap.reshape(B, K, h, w)
        out = {"value": softargmax_kp(heatmap)}
        if self.jacobian is not None:
            jac_map = self.jacobian(feature_map).reshape(
                B, self.num_jac, 4, h, w)
            if self.num_jac == K:  # one map per keypoint
                jac = torch.einsum("bkhw,bkfhw->bkf", heatmap, jac_map)
            else:  # one map, weighed by every keypoint's heatmap
                jac = torch.einsum("bkhw,bfhw->bkf", heatmap, jac_map[:, 0])
            out["jacobian"] = jac.reshape(B, K, 2, 2)
        return out
