"""Shared building blocks (counterpart of the JAX package's models/layers.py).

The JAX package's ``Conv2d`` is ``nn.Conv2d`` here, or this module's
``Conv2d`` where a conv may run inside the decoder region (below). Its
``BatchNorm2d`` (momentum 0.1, eps 1e-5) is this module's ``BatchNorm2d``.
Its ``Dense`` with ``patch=p`` / ``transpose_patch=p`` (a stride-p conv /
transposed conv as a matmul over (p_row, p_col, C)-ordered patches) is
``PatchEmbed`` / ``PatchUnembed``: ``nn.Sequential``s that hold the
``nn.Linear`` at the index the upstream reference gives it, so its
state_dict names load. The shift+matmul conv routing is a TPU execution
strategy over the same parameters and is not ported; the remat names
(``conv_out``, ``dense_out``) become the op types that
``training.trainer``'s selective checkpoint policy saves.

The decoder region. The JAX package's ``wl_layout`` scope (layers.py:
298-340) runs the training graph's decoder convs on the Pallas 3x3 kernel,
in a (B, H, C, W) layout that only served the TPU. Here the region is a
plain flag with no layout change: inside ``decoder_region()``, every 3x3,
stride-1, pad-1, ungrouped ``Conv2d`` runs kernel K3 (``ops.conv3x3``);
every other conv stays on ``F.conv2d``.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv3x3 import conv3x3
from ..parallel.mesh import all_reduce_, get_dist_info

_DECODER_REGION = contextvars.ContextVar("samt_decoder_region",
                                         default=False)


@contextlib.contextmanager
def decoder_region(enable: bool = True):
    """Scope in which the 3x3 convs of ``Conv2d`` run kernel K3."""
    tok = _DECODER_REGION.set(enable)
    try:
        yield
    finally:
        _DECODER_REGION.reset(tok)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and names) whose 3x3, stride-1,
    pad-1, ungrouped form runs kernel K3 inside ``decoder_region()``."""

    def forward(self, x):
        if (_DECODER_REGION.get() and self.kernel_size == (3, 3)
                and self.stride == (1, 1) and self.padding == (1, 1)
                and self.dilation == (1, 1) and self.groups == 1
                and self.padding_mode == "zeros"):
            return conv3x3(x, self.weight, self.bias)
        return super().forward(x)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of a process group, in
    float32, with the backward of ``F.batch_norm`` (as ``nn.SyncBatchNorm``
    computes it): the forward all-reduces the per-channel sums, then the
    sums of squared deviations from the global mean; the backward
    all-reduces the sums of dy and of dy * (x - mean), and returns this
    rank's share of the weight and bias gradients (their sum over the ranks
    is the global gradient). Returns y and the global mean and biased
    variance."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        C = x.shape[1]
        s = torch.cat([x.sum(dim=(0, 2, 3)), x.new_tensor([x.numel() // C])])
        all_reduce_(s)
        n = s[C]
        mean = s[:C] / n
        xmu = x - mean.view(1, C, 1, 1)
        var = all_reduce_((xmu * xmu).sum(dim=(0, 2, 3))) / n
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(xmu, invstd, weight)
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        y = xmu * (invstd * weight).view(1, C, 1, 1) + bias.view(1, C, 1, 1)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        xmu, invstd, weight = ctx.saved_tensors
        C = xmu.shape[1]
        sum_dy = dy.sum(dim=(0, 2, 3))
        sum_dy_xmu = (dy * xmu).sum(dim=(0, 2, 3))
        g = all_reduce_(torch.cat([sum_dy, sum_dy_xmu])) / ctx.n
        dx = (dy - g[:C].view(1, C, 1, 1)
              - xmu * (invstd * invstd * g[C:]).view(1, C, 1, 1)) \
            * (invstd * weight).view(1, C, 1, 1)
        return dx, sum_dy_xmu * invstd, sum_dy, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (momentum 0.1, eps 1e-5, same buffers) with the
    JAX package's training rule (flax ``nn.BatchNorm``, layers.py:519-542):
    in train mode it normalises with the batch statistics and moves the
    running variance toward the *biased* batch variance, where torch's own
    module uses the unbiased one. Statistics in float32, output in the
    input's dtype.

    In a process group of more than one rank, the train-mode statistics
    are those of the global batch, as the JAX step computes them over its
    sharded batch (``_GlobalBatchNorm``; ``nn.SyncBatchNorm`` would move
    the running variance toward the unbiased variance)."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        xf = x.float()
        if get_dist_info()[1] > 1:
            y, mean, var = _GlobalBatchNorm.apply(
                xf, self.weight.float(), self.bias.float(), self.eps)
            self._update_running(mean, var)
            return y.to(x.dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), unbiased=False)
            self._update_running(mean, var)
        y = F.batch_norm(xf, None, None, self.weight.float(),
                         self.bias.float(), True, 0.0, self.eps)
        return y.to(x.dtype)

    @torch.no_grad()
    def _update_running(self, mean, var):
        m = self.momentum
        self.running_mean.copy_(
            ((1 - m) * self.running_mean.float() + m * mean)
            .to(self.running_mean.dtype))
        self.running_var.copy_(
            ((1 - m) * self.running_var.float() + m * var)
            .to(self.running_var.dtype))


def swish(x):
    return x * torch.sigmoid(x)


class GroupNorm32(nn.GroupNorm):
    """torch GroupNorm(32 groups, eps 1e-6, affine) — the vqgan
    ``normalize``. Channel counts not divisible by 32 use gcd(C, 32)
    groups (only tiny test configs reach that)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        groups = 32 if channels % 32 == 0 else math.gcd(channels, 32)
        super().__init__(groups, channels, eps=eps, affine=True)


class SpaceToDepth(nn.Module):
    """(B, C, t*p, t*p) -> (B, t*t, p*p*C) tokens, inner order
    (p_row, p_col, C) (einops 'b c (h p1) (w p2) -> b (h w) (p1 p2 c)')."""

    def __init__(self, p: int):
        super().__init__()
        self.p = p

    def forward(self, x):
        B, C, H, W = x.shape
        p = self.p
        x = x.reshape(B, C, H // p, p, W // p, p).permute(0, 2, 4, 3, 5, 1)
        return x.reshape(B, (H // p) * (W // p), p * p * C)


class DepthToSpace(nn.Module):
    """Inverse of SpaceToDepth on a square t x t token grid."""

    def __init__(self, p: int):
        super().__init__()
        self.p = p

    def forward(self, x):
        B, L, D = x.shape
        p = self.p
        t = math.isqrt(L)
        C = D // (p * p)
        x = x.reshape(B, t, t, p, p, C).permute(0, 5, 1, 3, 2, 4)
        return x.reshape(B, C, t * p, t * p)


class PatchEmbed(nn.Sequential):
    """Stride-p patch embedding: index 0 is the relayout, index 1 the
    Linear (reference name ``<module>.1``)."""

    def __init__(self, p: int, in_channels: int, dim: int):
        super().__init__(SpaceToDepth(p), nn.Linear(in_channels * p * p, dim))


class PatchUnembed(nn.Sequential):
    """Inverse patch embedding: index 0 is the Linear (reference name
    ``<module>.0``), index 1 the relayout."""

    def __init__(self, p: int, dim: int, out_channels: int):
        super().__init__(nn.Linear(dim, out_channels * p * p),
                         DepthToSpace(p))
