"""VGG feature extractors of the perceptual losses, NCHW.

Counterpart of the JAX package's models/vgg.py ``VGG19Features``
(reference archs/vgg_arch.py:166-207): the frame is normalised with the
ImageNet mean and std, in its own dtype, and run through torchvision's
VGG19 ``features`` up to relu5_1, returning [relu1_1, relu2_1, relu3_1,
relu4_1, relu5_1]. ``features`` holds the layers at torchvision's indices,
so a torchvision VGG19 state_dict loads into it as it is. As in the
reference, frames in [-1, 1] go in unscaled.

``VGGFeatureExtractor`` is the JAX package's named-layer extractor
(reference archs/vgg_arch.py:57-164): the layers of vgg11/13/16/19 up to
the deepest requested one, in an ``nn.Sequential`` named by layer
(``vgg_net.conv1_1``, ...), so the JAX params, named by layer too, map
one to one; its forward returns ``{layer name: feature}``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

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


# layer-name sequences per VGG type (vgg_arch.py:13-36); a conv's channels
# follow its block: block 1..5 -> 64/128/256/512/512
def _names(convs_per_block):
    names = []
    for block, n in enumerate(convs_per_block, start=1):
        for i in range(1, n + 1):
            names += [f"conv{block}_{i}", f"relu{block}_{i}"]
        names.append(f"pool{block}")
    return names


VGG_NAMES = {"vgg11": _names((1, 1, 2, 2, 2)),
             "vgg13": _names((2, 2, 2, 2, 2)),
             "vgg16": _names((2, 2, 3, 3, 3)),
             "vgg19": _names((2, 2, 4, 4, 4))}
_BLOCK_CHANNELS = {1: 64, 2: 128, 3: 256, 4: 512, 5: 512}


class VGGFeatureExtractor(nn.Module):
    """The taps ``layer_name_list`` of ``vgg_type``; ``range_norm`` maps
    [-1, 1] to [0, 1] first, ``use_input_norm`` then applies the ImageNet
    mean and std (in float32, as the JAX module does), ``remove_pooling``
    drops the max pools and ``pooling_stride`` sets their stride."""

    def __init__(self, layer_name_list: Sequence[str],
                 vgg_type: str = "vgg19", use_input_norm: bool = True,
                 range_norm: bool = False, remove_pooling: bool = False,
                 pooling_stride: int = 2):
        super().__init__()
        names = VGG_NAMES[vgg_type]
        for v in layer_name_list:
            if v not in names:
                raise ValueError(f"layer {v!r} not in {vgg_type}")
        self.layer_name_list = list(layer_name_list)
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        layers = OrderedDict()
        ch = 3
        for name in names[:max(names.index(v) for v in layer_name_list) + 1]:
            if name.startswith("conv"):
                out = _BLOCK_CHANNELS[int(name[4])]
                layers[name] = nn.Conv2d(ch, out, 3, padding=1)
                ch = out
            elif name.startswith("relu"):
                layers[name] = nn.ReLU(inplace=False)
            elif not remove_pooling:
                layers[name] = nn.MaxPool2d(2, stride=pooling_stride)
        self.vgg_net = nn.Sequential(layers)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            mean = torch.tensor(_IMAGENET_MEAN, device=x.device)
            std = torch.tensor(_IMAGENET_STD, device=x.device)
            x = (x - mean[:, None, None]) / std[:, None, None]
        out = {}
        for name, layer in self.vgg_net.named_children():
            x = layer(x)
            if name in self.layer_name_list:
                out[name] = x
        return out
