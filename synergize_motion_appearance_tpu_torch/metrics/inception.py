"""FID's InceptionV3 feature extractor, NCHW (counterpart of the JAX
package's metrics/inception.py; the reference vendors pytorch-fid's
InceptionV3, basicsr/metrics/pytorch_fid/inception.py:16-328).

torchvision's Inception3 with the FID patches: InceptionA and C and the
first InceptionE pool with TF's average (``count_include_pad=False``),
the second InceptionE with a max pool; no aux head, no classifier. The
features are the 2048-d final average pool ("pool3").

Inference only: BatchNorm (eps 0.001) always uses its running statistics.
The modules carry pytorch-fid's names, so its
``pt_inception-2015-12-05-6726825d.pth`` loads unconverted
(``load_inception``, which drops the classifier ``fc.*``); the JAX
package's converted ``.npz`` loads through ``inception_state_dict``, the
inverse of its ``convert_torch_inception``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interp import resize_bilinear_at


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d that normalizes with its running statistics in either
    mode (the metric networks are never trained)."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class BasicConv2d(nn.Module):
    """conv (no bias) + BatchNorm(eps 0.001) + relu."""

    def __init__(self, cin: int, cout: int, kernel_size, stride=1,
                 padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, stride, padding,
                              bias=False)
        self.bn = FrozenBatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_tf(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd,
                          self.branch_pool(_avg_pool_tf(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd,
                          self.branch_pool(_avg_pool_tf(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool='avg_tf'`` for Mixed_7b, ``'max'`` (3x3, stride 1, pad 1)
    for Mixed_7c."""

    def __init__(self, cin: int, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        pooled = (F.max_pool2d(x, 3, 1, 1) if self.pool == "max"
                  else _avg_pool_tf(x))
        return torch.cat([self.branch1x1(x), b3, bd,
                          self.branch_pool(pooled)], 1)


class FIDInceptionV3(nn.Module):
    """Blocks 0-3 of pytorch-fid's InceptionV3: (B, 3, 299, 299) in
    [-1, 1] -> (B, 2048, 1, 1) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg_tf")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                     "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                     "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3), keepdim=True)


def preprocess(images01: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) in [0, 1] -> (B, 3, 299, 299) in [-1, 1]: bilinear,
    ``align_corners=False`` (inception.py:146-153), as two products with
    interpolation matrices computed in float64 (the JAX package's
    ``resize_bilinear``; F.interpolate's float32 source coordinates are
    off by up to 3e-5 at 256 -> 299)."""
    x = images01.float()
    if tuple(x.shape[2:]) != (299, 299):
        full = np.arange(299)
        x = resize_bilinear_at(x, (299, 299), full, full,
                               align_corners=False)
    return 2.0 * x - 1.0


def extract_features(net: FIDInceptionV3, images01: torch.Tensor
                     ) -> torch.Tensor:
    """(B, 2048) pool3 features of a (B, 3, H, W) [0, 1] batch."""
    with torch.no_grad():
        return net(preprocess(images01)).flatten(1)


_BN_LEAVES = {"bn_scale": "weight", "bn_bias": "bias", "bn_mean":
              "running_mean", "bn_var": "running_var"}


def inception_state_dict(flat: Dict[str, np.ndarray]
                         ) -> Dict[str, torch.Tensor]:
    """The JAX package's converted inception params ('/'-joined keys, as
    its ``flatten_params`` writes them) -> pytorch-fid's names."""
    sd = {}
    for key, v in flat.items():
        *scope, leaf = key.split("/")
        prefix = ".".join(scope)
        if leaf == "kernel":
            sd[f"{prefix}.conv.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(v).transpose(3, 2, 0, 1)))
        else:
            sd[f"{prefix}.bn.{_BN_LEAVES[leaf]}"] = torch.from_numpy(
                np.asarray(v))
    return sd


def load_inception(state_dict: Dict[str, Any]) -> FIDInceptionV3:
    """FIDInceptionV3 with pytorch-fid's state_dict (its classifier and
    aux head dropped), loaded ``strict=True``."""
    net = FIDInceptionV3()
    net.load_state_dict({k: v for k, v in state_dict.items()
                         if k.split(".")[0] not in ("fc", "AuxLogits")},
                        strict=True)
    return net.eval()
