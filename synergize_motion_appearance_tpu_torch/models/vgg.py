"""VGG19 feature slices of the perceptual pyramid loss, NCHW.

Counterpart of the JAX package's models/vgg.py ``VGG19Features``
(reference archs/vgg_arch.py:166-207): the frame is normalised with the
ImageNet mean and std, in its own dtype, and run through torchvision's
VGG19 ``features`` up to relu5_1, returning [relu1_1, relu2_1, relu3_1,
relu4_1, relu5_1]. ``features`` holds the layers at torchvision's indices,
so a torchvision VGG19 state_dict loads into it as it is. As in the
reference, frames in [-1, 1] go in unscaled.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

# VGG19 `features` through relu5_1: channels per conv, "M" a 2x2 max pool
_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
        512, 512, 512, 512, "M", 512]
# indices in `features` of the ReLUs whose outputs are the five slices
SLICE_ENDS = (1, 6, 11, 20, 29)
# indices in `features` of its convs
CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28)

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG19Features(nn.Module):
    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        ch = 3
        for item in _CFG:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(ch, item, 3, padding=1),
                           nn.ReLU(inplace=False)]
                ch = item
        self.features = nn.Sequential(*layers)

    def forward(self, x) -> List[torch.Tensor]:
        mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
        x = (x - mean[:, None, None]) / std[:, None, None]
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in SLICE_ENDS:
                outs.append(x)
        return outs
