"""LPIPS with the VGG-16 backbone, NCHW (counterpart of the JAX package's
metrics/lpips_jax.py; the reference scores with the lpips package's
``LPIPS(net='vgg')``, basicsr/metrics/cmp_lpips.py:24).

Inputs in [-1, 1] -> lpips' ScalingLayer -> VGG16 features at relu1_2,
relu2_2, relu3_3, relu4_3 and relu5_3 -> unit-normalized over channels
(eps 1e-10) -> squared difference -> the learned 1x1 "lin" heads (no
bias) -> spatial mean, summed over the five layers.

The modules carry the names the JAX converter reads
(``convert_lpips_weights``): torchvision's ``features.<i>`` for the
convs and lpips' ``lin<k>.model.1.weight`` for the heads. The JAX
package's ``lpips_vgg.npz`` loads through ``lpips_state_dict``, the port's
copy of that converter's key map, inverted.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn

# lpips.ScalingLayer constants (applied to [-1, 1] inputs)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# torchvision vgg16 ``features`` conv plan; "M" = 2x2 max pool
_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512]
# conv count at each tapped relu (relu1_2 ... relu5_3)
_TAPS = (2, 4, 7, 10, 13)
_LIN_CHANNELS = (64, 128, 256, 512, 512)


def _conv_indices() -> List[int]:
    """The ``features`` index of each conv (a conv and its relu take two
    places, a pool one)."""
    idx, out = 0, []
    for item in _VGG16_CFG:
        if item == "M":
            idx += 1
        else:
            out.append(idx)
            idx += 2
    return out


CONV_INDICES = _conv_indices()


class _NetLin(nn.Module):
    """lpips' NetLinLayer at eval: ``model.1`` is the 1x1 conv (``model.0``
    is its dropout, which holds nothing)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(),
                                   nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


def _unit_normalize(x, eps=1e-10):
    """lpips.normalize_tensor: x / (||x|| over channels + eps)."""
    return x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + eps)


class LPIPSVgg(nn.Module):
    """forward(x, y) with (B, 3, H, W) inputs in [-1, 1] -> (B,)
    distances."""

    def __init__(self):
        super().__init__()
        layers: List[nn.Module] = []
        cin = 3
        for item in _VGG16_CFG:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, item, 3, padding=1),
                           nn.ReLU(inplace=False)]
                cin = item
        self.features = nn.Sequential(*layers)
        for k, c in enumerate(_LIN_CHANNELS):
            setattr(self, f"lin{k}", _NetLin(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    def taps(self, x) -> List[torch.Tensor]:
        outs, n_conv = [], 0
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                n_conv += 1
                if n_conv in _TAPS:
                    outs.append(x)
        return outs

    def forward(self, x, y):
        fx = self.taps((x - self.shift) / self.scale)
        fy = self.taps((y - self.shift) / self.scale)
        total = 0.0
        for k, (a, b) in enumerate(zip(fx, fy)):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            total = total + getattr(self, f"lin{k}")(d).mean(dim=(1, 2, 3))
        return total


def lpips_distance(net: LPIPSVgg, x, y) -> torch.Tensor:
    """(B,) LPIPS distances of (B, 3, H, W) [-1, 1] image pairs."""
    return net(x, y)


def lpips_state_dict(flat: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPSVgg params ('/'-joined keys of its
    ``convert_lpips_weights`` output: ``vgg/conv<i>_kernel`` HWIO,
    ``vgg/conv<i>_bias``, ``lin<k>``) -> this module's names."""
    sd = {}
    for key, v in flat.items():
        v = np.asarray(v, np.float32)
        if key.startswith("vgg/conv"):
            i, leaf = key[len("vgg/conv"):].split("_")
            name = f"features.{CONV_INDICES[int(i)]}"
            if leaf == "kernel":
                sd[f"{name}.weight"] = torch.from_numpy(
                    np.ascontiguousarray(v.transpose(3, 2, 0, 1)))
            else:
                sd[f"{name}.bias"] = torch.from_numpy(v)
        else:
            sd[f"{key}.model.1.weight"] = torch.from_numpy(
                v.reshape(1, -1, 1, 1))
    return sd
