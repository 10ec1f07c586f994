"""StyleGAN2's fused bias + leaky ReLU and upfirdn2d, in PyTorch, NCHW.

Counterpart of the JAX package's ops/stylegan_ops.py (the reference's
ops/fused_act/fused_act.py:75-89 and ops/upfirdn2d/upfirdn2d.py:147+).
Both are elementwise ops and one depthwise convolution; the reference
has CUDA extensions for them only because eager torch ran them as
several kernels. The JAX ops hold no Pallas kernel, so no hand kernel is
owed.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def fused_leaky_relu(x, bias=None, negative_slope: float = 0.2,
                     scale: float = 2 ** 0.5):
    """leaky_relu(x + bias) * scale, the bias on the channel axis (dim
    1)."""
    if bias is not None:
        x = x + bias.reshape((1, -1) + (1,) * (x.dim() - 2))
    return F.leaky_relu(x, negative_slope) * scale


def upfirdn2d(x, kernel, up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)):
    """x (B, C, H, W), kernel (kh, kw) FIR filter: upsample by zero
    insertion, pad both spatial sides by pad[0] before and pad[1] after (a
    negative pad crops), correlate each channel with the flipped kernel
    (a convolution with the kernel, JAX stylegan_ops.py:47), then keep
    every ``down``-th row and column."""
    B, C, H, W = x.shape
    kh, kw = kernel.shape
    p0, p1 = pad
    if up > 1:
        z = x.new_zeros(B, C, H, up, W, up)
        z[:, :, :, 0, :, 0] = x
        x = z.reshape(B, C, H * up, W * up)
    x = F.pad(x, (max(p0, 0), max(p1, 0), max(p0, 0), max(p1, 0)))
    if p0 < 0 or p1 < 0:
        x = x[:, :, max(-p0, 0):x.shape[2] - max(-p1, 0),
              max(-p0, 0):x.shape[3] - max(-p1, 0)]
    k = torch.flip(kernel.to(x), (0, 1))[None, None].expand(C, 1, kh, kw)
    x = F.conv2d(x, k, groups=C)
    if down > 1:
        x = x[:, :, ::down, ::down]
    return x


def make_resample_kernel(k: Sequence[float]) -> torch.Tensor:
    """A 1-D filter's normalized 2-D outer product (a 2-D filter is only
    normalized), float32."""
    k = torch.as_tensor(k, dtype=torch.float32)
    if k.dim() == 1:
        k = k[None, :] * k[:, None]
    return k / k.sum()
