"""FOMM-style motion network blocks (Hourglass family), NCHW.

Counterpart of the JAX package's models/motion_blocks.py; module names are
the reference's (utils/motion_estimator_util.py: ResBlock2d :163-185,
UpBlock2d :214-231, DownBlock2d :363-380, SameBlock2d :383-398, Encoder
:440-459, Decoder :462-492, Hourglass :551-563). BatchNorm is
``layers.BatchNorm2d``: running statistics in eval mode, batch statistics
with the JAX package's update rule in train mode.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import avg_pool_2x, upsample_nearest
from .layers import BatchNorm2d


class ResBlock2d(nn.Module):
    def __init__(self, in_features: int, kernel_size: int = 3,
                 padding: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, in_features, kernel_size,
                               padding=padding)
        self.conv2 = nn.Conv2d(in_features, in_features, kernel_size,
                               padding=padding)
        self.norm1 = BatchNorm2d(in_features)
        self.norm2 = BatchNorm2d(in_features)

    def forward(self, x):
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out)))
        return out + x


class UpBlock2d(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, 3, padding=1)
        self.norm = BatchNorm2d(out_features)

    def forward(self, x):
        return F.relu(self.norm(self.conv(upsample_nearest(x, 2))))


class DownBlock2d(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, 3, padding=1)
        self.norm = BatchNorm2d(out_features)

    def forward(self, x):
        return avg_pool_2x(F.relu(self.norm(self.conv(x))))


class SameBlock2d(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 kernel_size: int = 3, padding: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, kernel_size,
                              padding=padding)
        self.norm = BatchNorm2d(out_features)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class HourglassEncoder(nn.Module):
    def __init__(self, block_expansion: int, in_features: int,
                 num_blocks: int = 3, max_features: int = 256):
        super().__init__()
        blocks = []
        for i in range(num_blocks):
            cin = in_features if i == 0 else min(
                max_features, block_expansion * 2 ** i)
            cout = min(max_features, block_expansion * 2 ** (i + 1))
            blocks.append(DownBlock2d(cin, cout))
        self.down_blocks = nn.ModuleList(blocks)

    def forward(self, x) -> List[torch.Tensor]:
        outs = [x]
        for block in self.down_blocks:
            outs.append(block(outs[-1]))
        return outs


class HourglassDecoder(nn.Module):
    def __init__(self, block_expansion: int, in_features: int,
                 num_blocks: int = 3, max_features: int = 256):
        super().__init__()
        blocks = []
        # channels of each stage's output, coarse to fine: the block's
        # output and the encoder skip it is concatenated with
        self.stage_channels = []
        for i in reversed(range(num_blocks)):
            cin = (1 if i == num_blocks - 1 else 2) * min(
                max_features, block_expansion * 2 ** (i + 1))
            cout = min(max_features, block_expansion * 2 ** i)
            blocks.append(UpBlock2d(cin, cout))
            self.stage_channels.append(cout + (in_features if i == 0
                                               else cout))
        self.up_blocks = nn.ModuleList(blocks)
        self.out_filters = block_expansion + in_features

    def forward(self, skips: List[torch.Tensor]) -> List[torch.Tensor]:
        """Every stage's concat output, coarse to fine (reference mode=1)."""
        skips = list(skips)
        out = skips.pop()
        outs = []
        for block in self.up_blocks:
            out = torch.cat([block(out), skips.pop()], dim=1)
            outs.append(out)
        return outs


class Hourglass(nn.Module):
    def __init__(self, block_expansion: int, in_features: int,
                 num_blocks: int = 3, max_features: int = 256):
        super().__init__()
        self.encoder = HourglassEncoder(block_expansion, in_features,
                                        num_blocks, max_features)
        self.decoder = HourglassDecoder(block_expansion, in_features,
                                        num_blocks, max_features)
        self.out_filters = self.decoder.out_filters

    def forward(self, x, mode: int = 0):
        outs = self.decoder(self.encoder(x))
        return outs if mode == 1 else outs[-1]
