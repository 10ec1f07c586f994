"""Architecture utilities, NCHW: the counterpart of the JAX package's
models/arch_util.py (the reference's basicsr/archs/arch_util.py).

- ``scaled_conv_kernel_init`` (BasicSR ``default_init_weights``, :18-45):
  every conv and linear layer of a module drawn as torch's default
  (kaiming uniform, a = sqrt(5), the JAX package's
  ``torch_conv_kernel_init``), then scaled; biases filled.
- ``trunc_normal_init`` (:239-301): a normal truncated to [a, b]
  standard deviations, scaled by ``std`` and shifted by ``mean``, as the
  JAX initializer draws it, on ``torch.nn.init.trunc_normal_`` with an
  explicit generator.
- ``ResidualBlockNoBN`` (:64-92), ``Upsample`` (:95-115, a pixel-shuffle
  tower for scales 2^n and 3) and ``make_layer`` (:48-61), as BasicSR's
  ``nn.Sequential``s; the towers' shuffle reads the JAX package's
  channel order (``extended_blocks.pixel_shuffle``).
- ``flow_warp`` (:117-148) through the port's ``ops.grid_sample`` and
  ``resize_flow`` (:151-187); flows are (B, H, W, 2) in (x, y) pixels.
- ``ModulatedDeformConvPack`` and ``DCNv2Pack`` (:209-236) on
  ``ops.dcn.modulated_deform_conv2d``, with BasicSR's parameter names
  (``weight``, ``bias``, ``conv_offset``), ``conv_offset``
  zero-initialised and its third chunk a sigmoid mask.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn

from ..ops import grid_sample, resize_bilinear, resize_nearest
from ..ops.dcn import modulated_deform_conv2d
from .extended_blocks import PixelShuffle


def scaled_conv_kernel_init(module: nn.Module, scale: float = 1.0,
                            bias_fill: float = 0.0,
                            generator: Optional[torch.Generator] = None
                            ) -> nn.Module:
    """Re-draws every ``nn.Conv2d`` and ``nn.Linear`` of ``module`` (itself
    included) as torch's default init times ``scale``, its bias filled
    with ``bias_fill``; returns the module."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                         generator=generator)
                m.weight.mul_(scale)
                if m.bias is not None:
                    m.bias.fill_(bias_fill)
    return module


def trunc_normal_init(tensor: torch.Tensor, std: float = 1.0,
                      mean: float = 0.0, a: float = -2.0, b: float = 2.0,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    """Fills ``tensor`` in place with a normal truncated to [a, b] in
    units of the standard normal, then ``* std + mean``: values in
    [mean + a std, mean + b std]."""
    return nn.init.trunc_normal_(tensor, mean, std, mean + a * std,
                                 mean + b * std, generator=generator)


class ResidualBlockNoBN(nn.Module):
    """x + res_scale * conv2(relu(conv1(x))); the convs initialised at 0.1
    of the default scale unless ``pytorch_init``."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.0,
                 pytorch_init: bool = False):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.conv2 = nn.Conv2d(num_feat, num_feat, 3, padding=1)
        self.relu = nn.ReLU()
        if not pytorch_init:
            scaled_conv_kernel_init(self, 0.1)

    def forward(self, x):
        return x + self.conv2(self.relu(self.conv1(x))) * self.res_scale


class Upsample(nn.Sequential):
    """Conv and pixel shuffle per factor 2 for a scale 2^n, or one conv
    and a shuffle by 3."""

    def __init__(self, scale: int, num_feat: int):
        layers = []
        if scale & (scale - 1) == 0:  # a power of two
            for _ in range(int(math.log2(scale))):
                layers += [nn.Conv2d(num_feat, 4 * num_feat, 3, padding=1),
                           PixelShuffle(2)]
        elif scale == 3:
            layers += [nn.Conv2d(num_feat, 9 * num_feat, 3, padding=1),
                       PixelShuffle(3)]
        else:
            raise ValueError(f"scale {scale} is not supported. Supported "
                             f"scales: 2^n and 3.")
        super().__init__(*layers)


def make_layer(block: Callable[..., nn.Module], num_blocks: int,
               **kwargs) -> nn.Sequential:
    """``num_blocks`` instances of ``block(**kwargs)`` in sequence."""
    return nn.Sequential(*(block(**kwargs) for _ in range(num_blocks)))


def flow_warp(x, flow, interp_mode: str = "bilinear",
              padding_mode: str = "zeros", align_corners: bool = True):
    """Warp x (B, C, H, W) by a pixel-unit flow (B, H, W, 2) in (x, y).
    ``nearest`` samples bilinearly at the rounded pixel positions, as the
    JAX function does."""
    B, C, H, W = x.shape
    if tuple(flow.shape[1:3]) != (H, W):
        raise ValueError(f"flow {tuple(flow.shape)} does not match the "
                         f"input's {H}x{W}")
    gx = torch.arange(W, dtype=flow.dtype, device=flow.device)[None, None,
                                                               :] \
        + flow[..., 0]
    gy = torch.arange(H, dtype=flow.dtype, device=flow.device)[None, :,
                                                               None] \
        + flow[..., 1]
    gx = 2.0 * gx / max(W - 1, 1) - 1.0
    gy = 2.0 * gy / max(H - 1, 1) - 1.0
    if interp_mode == "nearest":
        if align_corners:
            gxp = torch.round((gx + 1) * 0.5 * (W - 1))
            gyp = torch.round((gy + 1) * 0.5 * (H - 1))
            gx = gxp / max(W - 1, 1) * 2 - 1
            gy = gyp / max(H - 1, 1) * 2 - 1
        else:
            gxp = torch.floor((gx + 1) * W * 0.5 - 0.5 + 0.5)
            gyp = torch.floor((gy + 1) * H * 0.5 - 0.5 + 0.5)
            gx = (2 * gxp + 1) / W - 1
            gy = (2 * gyp + 1) / H - 1
    elif interp_mode != "bilinear":
        raise ValueError(f"unsupported interp_mode {interp_mode}")
    return grid_sample(x, torch.stack([gx, gy], dim=-1),
                       align_corners=align_corners,
                       padding_mode=padding_mode)


def resize_flow(flow, size_type: str, sizes: Sequence,
                interp_mode: str = "bilinear", align_corners: bool = False):
    """Resize a (B, H, W, 2) (x, y) pixel flow to a ``ratio`` of its size
    or to a ``shape``, its values scaled with it."""
    B, H, W, _ = flow.shape
    if size_type == "ratio":
        out_h, out_w = int(H * sizes[0]), int(W * sizes[1])
    elif size_type == "shape":
        out_h, out_w = int(sizes[0]), int(sizes[1])
    else:
        raise ValueError(f"Size type should be ratio or shape, but got type "
                         f"{size_type}.")
    scaled = torch.stack([flow[..., 0] * (out_w / W),
                          flow[..., 1] * (out_h / H)], dim=1)
    if interp_mode == "bilinear":
        out = resize_bilinear(scaled, (out_h, out_w),
                              align_corners=align_corners)
    elif interp_mode == "nearest":
        out = resize_nearest(scaled, (out_h, out_w))
    else:
        raise ValueError(f"unsupported interp_mode {interp_mode}")
    return out.permute(0, 2, 3, 1)


class ModulatedDeformConvPack(nn.Module):
    """DCNv2 whose offsets and mask a zero-initialised conv predicts from
    the input itself (ops/dcn/deform_conv.py:286-342). The offset conv
    has the DCN's stride and padding and no dilation, as in the JAX
    module."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=3, stride=1, padding=1, dilation=1,
                 groups: int = 1, deformable_groups: int = 1):
        super().__init__()

        def pair(v):
            return (v, v) if isinstance(v, int) else tuple(v)

        self.kernel_size, self.stride = pair(kernel_size), pair(stride)
        self.padding, self.dilation = pair(padding), pair(dilation)
        self.groups, self.deformable_groups = groups, deformable_groups
        kh, kw = self.kernel_size
        self.weight = nn.Parameter(torch.empty(out_channels,
                                               in_channels // groups, kh, kw))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.conv_offset = nn.Conv2d(
            in_channels, deformable_groups * 3 * kh * kw, self.kernel_size,
            stride=self.stride, padding=self.padding)
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def _dcn(self, x, feat):
        o1, o2, mask = torch.chunk(self.conv_offset(feat), 3, dim=1)
        # the cat's channel c is (tap c // 2, y or x by c % 2): the
        # offset layout of ops.dcn
        return modulated_deform_conv2d(
            x, torch.cat([o1, o2], dim=1), torch.sigmoid(mask), self.weight,
            self.bias, self.stride, self.padding, self.dilation, self.groups,
            self.deformable_groups)

    def forward(self, x):
        return self._dcn(x, x)


class DCNv2Pack(ModulatedDeformConvPack):
    """The alignment DCN of EDVR: offsets and mask from a second feature
    map ``feat`` (with ``in_channels`` channels)."""

    def forward(self, x, feat):
        return self._dcn(x, feat)
