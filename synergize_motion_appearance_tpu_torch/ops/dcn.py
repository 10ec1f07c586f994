"""Deformable convolution v1 and v2 (modulated), in PyTorch, NCHW.

Counterpart of the JAX package's ops/dcn.py (the reference's CUDA
extension, ops/dcn/src/deform_conv_cuda_kernel.cu:85-191): each output
position's kernel taps are sampled bilinearly at the base grid plus a
learned offset, reading 0 outside the image (the JAX ``_bilinear_gather``,
:25), the samples are scaled by the v2 mask, and one matmul with the
weight gives the output. Autograd gives the backward, as the JAX
package's autodiff does.

The JAX op is a gather and an einsum, not a Pallas kernel, so no hand
kernel is owed for it; torchvision's ``deform_conv2d`` is not there, and
the gather is written here in torch, as the warps of the main path call
``grid_sample``.

Layouts, the reference's: x (B, Cin, H, W); weight (Cout, Cin / groups,
kh, kw); offset (B, dg * kh * kw * 2, Ho, Wo) with channel
((g * kh + i) * kw + j) * 2 + {0: dy, 1: dx} for deformable group g and
tap (i, j); mask (B, dg * kh * kw, Ho, Wo). The JAX package's NHWC offset
(B, Ho, Wo, dg * kh * kw * 2) is this layout with the channels last.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Pair = Tuple[int, int]


def _pair(v) -> Pair:
    return (v, v) if isinstance(v, int) else tuple(v)


def _bilinear_gather(x, ys, xs):
    """x (N, C, H, W); ys, xs (N, P) sample positions in pixels. Returns
    (N, C, P): bilinear samples, each corner outside the image read as
    0."""
    N, C, H, W = x.shape
    flat = x.reshape(N, C, H * W)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    out = 0
    for yi, xi, wgt in ((y0, x0, wy0 * wx0), (y0, x0 + 1, wy0 * wx1),
                        (y0 + 1, x0, wy1 * wx0), (y0 + 1, x0 + 1, wy1 * wx1)):
        valid = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).long()
        v = torch.gather(flat, 2, idx[:, None, :].expand(N, C, -1))
        out = out + v * (wgt * valid)[:, None, :].to(x.dtype)
    return out


def deform_conv2d(x, offset, weight, bias: Optional[torch.Tensor] = None,
                  stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                  groups: int = 1, deformable_groups: int = 1,
                  mask: Optional[torch.Tensor] = None):
    """Deformable convolution (JAX ops/dcn.py:80): x (B, Cin, H, W),
    offset (B, dg*kh*kw*2, Ho, Wo), weight (Cout, Cin/groups, kh, kw),
    with the v2 ``mask`` (B, dg*kh*kw, Ho, Wo) when given. Returns
    (B, Cout, Ho, Wo)."""
    B, Cin, H, W = x.shape
    Cout, _, kh, kw = weight.shape
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    dg = deformable_groups
    cpg = Cin // dg
    dev = x.device
    # base sampling positions (Ho, Wo, kh, kw), input pixels
    oy = torch.arange(Ho, device=dev) * sh - ph
    ox = torch.arange(Wo, device=dev) * sw - pw
    ky = torch.arange(kh, device=dev) * dh
    kx = torch.arange(kw, device=dev) * dw
    base_y = (oy[:, None, None, None] + ky[None, None, :, None]).expand(
        Ho, Wo, kh, kw).float()
    base_x = (ox[None, :, None, None] + kx[None, None, None, :]).expand(
        Ho, Wo, kh, kw).float()
    off = offset.float().reshape(B, dg, kh, kw, 2, Ho, Wo).permute(
        0, 1, 5, 6, 2, 3, 4)                        # (B, dg, Ho, Wo, kh, kw, 2)
    ys = (base_y + off[..., 0]).reshape(B * dg, -1)
    xs = (base_x + off[..., 1]).reshape(B * dg, -1)
    cols = _bilinear_gather(x.reshape(B * dg, cpg, H, W), ys, xs)
    cols = cols.reshape(B, dg, cpg, Ho, Wo, kh, kw)
    if mask is not None:
        m = mask.reshape(B, dg, kh, kw, Ho, Wo).permute(0, 1, 4, 5, 2, 3)
        cols = cols * m[:, :, None].to(cols.dtype)
    cols = cols.reshape(B, groups, Cin // groups, Ho, Wo, kh, kw)
    wg = weight.reshape(groups, Cout // groups, Cin // groups, kh, kw)
    out = torch.einsum("bgchwyx,gocyx->bgohw", cols, wg.to(cols.dtype))
    out = out.reshape(B, Cout, Ho, Wo)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


def modulated_deform_conv2d(x, offset, mask, weight,
                            bias: Optional[torch.Tensor] = None,
                            stride=(1, 1), padding=(0, 0), dilation=(1, 1),
                            groups: int = 1, deformable_groups: int = 1):
    """DCNv2 (JAX ops/dcn.py:142; ops/dcn/deform_conv.py:223-377): the
    mask, a sigmoid output, scales each sampled tap."""
    return deform_conv2d(x, offset, weight, bias, stride, padding, dilation,
                         groups, deformable_groups, mask=mask)
