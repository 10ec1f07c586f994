"""OpenFace nn4.small2 face embedder, NCHW (counterpart of the JAX
package's metrics/openface.py; the reference's vendored torch port,
basicsr/metrics/OpenFacePytorch/loadOpenFace.py:154-222, which the AED
metric runs, extract.py:84-102): 96x96 BGR [0, 1] faces -> 128-d
L2-normalized embeddings.

As there: Torch7's cross-map LRN (size 5, alpha 1e-4, beta 0.75, k 1);
inception branches of unequal sizes zero-padded to the largest, centred,
before the concat; LPPool2d(2) as the square root of a 3x3/stride-3 sum
of squares; a pool branch without a reduce conv passes the pooled input
through; 128-px inputs repeated 3x and 4x4-average-pooled to 96.

The modules carry the names of the published ``openface.pth``
(``layer1``, ``layer2`` ..., ``layer14.seq_list.0.1_conv`` ...,
``layer25``), which the JAX converter ``convert_openface_weights`` reads,
so that file loads unconverted; the JAX package's converted ``.npz``
loads through ``openface_state_dict``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .inception import FrozenBatchNorm2d


def _lrn(x):
    return F.local_response_norm(x, size=5, alpha=1e-4, beta=0.75, k=1.0)


def _lp_pool2(x):
    """LPPool2d(p=2, 3, stride 3): sqrt of the window's sum of squares."""
    return torch.sqrt(torch.clamp(F.avg_pool2d(x * x, 3, 3) * 9.0, min=0.0))


def _pad_to(y, hw):
    """Zero-pad NCHW ``y`` to (H, W), centred (loadOpenFace.py:141-147)."""
    ph, pw = hw[0] - y.shape[2], hw[1] - y.shape[3]
    pt, pl = ph // 2, pw // 2
    return F.pad(y, (pl, pw - pl, pt, ph - pt))


class _Pool(nn.Module):
    def __init__(self, kind: str):
        super().__init__()
        self.kind = kind

    def forward(self, x):
        return F.max_pool2d(x, 3, 2) if self.kind == "max" else _lp_pool2(x)


def _conv_bn_relu(first: int, cin: int, cout: int, k: int = 1,
                  stride: int = 1, pad: int = 0):
    """(first)_conv, (first+1)_bn, (first+2)_relu entries."""
    return [(f"{first}_conv", nn.Conv2d(cin, cout, k, stride, pad)),
            (f"{first + 1}_bn", FrozenBatchNorm2d(cout)),
            (f"{first + 2}_relu", nn.ReLU())]


class _Inception(nn.Module):
    """One OpenFace inception block (loadOpenFace.py:62-151): a branch per
    kernel (1x1 reduce, then the kernel), a pool branch (with a 1x1 conv
    when its reduce size is given) and a reduce-only branch when given;
    ``seq_list`` indexes them in that order."""

    def __init__(self, cin: int, kernel_size: Sequence[int],
                 kernel_stride: Sequence[int], output_size: Sequence[int],
                 reduce_size: Sequence[Optional[int]], pool: str):
        super().__init__()
        seqs = []
        for i, k in enumerate(kernel_size):
            seqs.append(nn.Sequential(OrderedDict(
                _conv_bn_relu(1, cin, reduce_size[i])
                + _conv_bn_relu(4, reduce_size[i], output_size[i], k,
                                kernel_stride[i], k // 2))))
        ii = len(kernel_size)
        pool_seq = [("1_pool", _Pool(pool))]
        if ii < len(reduce_size) and reduce_size[ii] is not None:
            pool_seq += _conv_bn_relu(2, cin, reduce_size[ii])
        seqs.append(nn.Sequential(OrderedDict(pool_seq)))
        ii += 1
        if ii < len(reduce_size) and reduce_size[ii] is not None:
            seqs.append(nn.Sequential(OrderedDict(
                _conv_bn_relu(1, cin, reduce_size[ii]))))
        self.seq_list = nn.ModuleList(seqs)

    def forward(self, x):
        ys = [seq(x) for seq in self.seq_list]
        th = max(y.shape[2] for y in ys)
        tw = max(y.shape[3] for y in ys)
        return torch.cat([_pad_to(y, (th, tw)) for y in ys], dim=1)


class OpenFaceNet(nn.Module):
    """nn4.small2: (B, 3, 96, 96) BGR [0, 1] (or 128x128) -> (embedding
    (B, 128) L2-normalized, features (B, 736))."""

    def __init__(self):
        super().__init__()
        self.layer1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.layer2 = FrozenBatchNorm2d(64)
        self.layer6 = nn.Conv2d(64, 64, 1)
        self.layer7 = FrozenBatchNorm2d(64)
        self.layer9 = nn.Conv2d(64, 192, 3, 1, 1)
        self.layer10 = FrozenBatchNorm2d(192)
        self.layer14 = _Inception(192, (3, 5), (1, 1), (128, 32),
                                  (96, 16, 32, 64), "max")
        self.layer15 = _Inception(256, (3, 5), (1, 1), (128, 64),
                                  (96, 32, 64, 64), "lp")
        self.layer16 = _Inception(320, (3, 5), (2, 2), (256, 64),
                                  (128, 32, None, None), "max")
        self.layer17 = _Inception(640, (3, 5), (1, 1), (192, 64),
                                  (96, 32, 128, 256), "lp")
        self.layer18 = _Inception(640, (3, 5), (2, 2), (256, 128),
                                  (160, 64, None, None), "max")
        self.layer19 = _Inception(1024, (3,), (1,), (384,), (96, 96, 256),
                                  "lp")
        self.layer21 = _Inception(736, (3,), (1,), (384,), (96, 96, 256),
                                  "max")
        self.layer25 = nn.Linear(736, 128)

    def forward(self, x):
        if x.shape[2] == 128:
            x = x.repeat_interleave(3, dim=2).repeat_interleave(3, dim=3)
            x = F.avg_pool2d(x, 4, 4)
        x = F.relu(self.layer2(self.layer1(x)))
        x = _lrn(F.max_pool2d(x, 3, 2, 1))
        x = F.relu(self.layer7(self.layer6(x)))
        x = F.relu(self.layer10(self.layer9(x)))
        x = F.max_pool2d(_lrn(x), 3, 2, 1)
        for name in ("layer14", "layer15", "layer16", "layer17", "layer18",
                     "layer19", "layer21"):
            x = getattr(self, name)(x)
        x736 = F.avg_pool2d(x, 3, 1).flatten(1)
        e = self.layer25(x736)
        return e / torch.sqrt((e * e).sum(dim=1, keepdim=True) + 1e-6), x736


def embed_faces(net: OpenFaceNet, faces_bgr01: torch.Tensor
                ) -> torch.Tensor:
    """(B, 3, 96, 96) BGR [0, 1] faces -> (B, 128) embeddings."""
    with torch.no_grad():
        return net(faces_bgr01)[0]


_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
_STEM = {"layer1": ("layer1", "layer2"), "layer6": ("layer6", "layer7"),
         "layer9": ("layer9", "layer10")}


def _seq_index(scope: str) -> int:
    return int(scope[3:].split("_")[0])  # 'seq<i>_<kind>'


def openface_state_dict(flat: Dict[str, np.ndarray]
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's OpenFaceNet params ('/'-joined keys of its
    ``convert_openface_weights`` output) -> the names of openface.pth."""
    sd = {}

    def put(name, v, conv_weight=False):
        v = np.asarray(v, np.float32)
        if conv_weight:
            v = np.ascontiguousarray(v.transpose(3, 2, 0, 1))
        sd[name] = torch.from_numpy(v)

    for key, v in flat.items():
        parts = key.split("/")
        if parts[0] == "fc_kernel":
            put("layer25.weight", np.asarray(v).T)
        elif parts[0] == "fc_bias":
            put("layer25.bias", v)
        elif parts[0] in _STEM:
            conv, bn = _STEM[parts[0]]
            kind, leaf = parts[1].split("_", 1)
            if kind == "conv":
                put(f"{conv}.{'weight' if leaf == 'kernel' else 'bias'}", v,
                    leaf == "kernel")
            else:
                put(f"{bn}.{_BN_LEAVES[leaf]}", v)
        else:
            layer, scope, leaf = parts
            mod, attr = leaf.rsplit("_", 1)
            name = f"{layer}.seq_list.{_seq_index(scope)}.{mod}"
            if mod.endswith("conv"):
                put(f"{name}.{'weight' if attr == 'kernel' else 'bias'}", v,
                    attr == "kernel")
            else:
                put(f"{name}.{_BN_LEAVES[attr]}", v)
    return sd
