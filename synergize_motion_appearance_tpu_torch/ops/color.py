"""RGB <-> YUV420 (I420) conversion on the device, BT.601 studio swing.

Counterpart of the JAX package's ops/color.py. Generated frames can leave
the device as packed I420 (1.5 bytes a pixel instead of 3), the layout
video encoders take; the host converts them back with OpenCV's
``COLOR_YUV2RGB_I420``. The coefficients are OpenCV's ``COLOR_RGB2YUV_I420``
pair (Y in [16, 235], U and V in [16, 240], chroma from the top-left pixel
of each 2x2 block), so a frame packed here unpacks there within a level.

I420 packing: (H*3/2, W) uint8 per frame. Rows [0, H) hold Y; rows
[H, H + H/4) the (H/2, W/2) U plane reflowed to W columns; the rest V.
Frames are NHWC tensors here, as they leave the generator.
"""
from __future__ import annotations

import torch

# BT.601 studio-swing forward coefficients (x256)
_YR, _YG, _YB = 65.738, 129.057, 25.064
_UR, _UG, _UB = -37.945, -74.494, 112.439
_VR, _VG, _VB = 112.439, -94.154, -18.285


def rgb_to_yuv420(rgb: torch.Tensor, model_domain: bool = True
                  ) -> torch.Tensor:
    """rgb: (F, H, W, 3) float in [-1, 1] (``model_domain``), float in
    [0, 255], or uint8. Returns packed I420 uint8 of shape (F, H*3/2, W)."""
    F_, H, W, _ = rgb.shape
    if H % 4 or W % 2:  # the (H/2, W/2) planes reflow to (H/4, W) rows
        raise ValueError(f"I420 packing needs H % 4 == 0 and even W, got "
                         f"{H}x{W}")
    if rgb.dtype == torch.uint8:
        x = rgb.float()
    elif model_domain:
        x = (rgb.float().clamp(-1.0, 1.0) + 1.0) * 127.5
    else:
        x = rgb.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16.0 + (_YR * r + _YG * g + _YB * b) * (1.0 / 256.0)
    rs, gs, bs = r[:, ::2, ::2], g[:, ::2, ::2], b[:, ::2, ::2]
    u = 128.0 + (_UR * rs + _UG * gs + _UB * bs) * (1.0 / 256.0)
    v = 128.0 + (_VR * rs + _VG * gs + _VB * bs) * (1.0 / 256.0)

    def q(p):
        return torch.round(p).clamp(0.0, 255.0).to(torch.uint8)

    return torch.cat([q(y), q(u).reshape(F_, H // 4, W),
                      q(v).reshape(F_, H // 4, W)], dim=1)


def yuv420_to_rgb(yuv: torch.Tensor, model_domain: bool = True
                  ) -> torch.Tensor:
    """yuv: (F, H*3/2, W) packed I420. Returns (F, H, W, 3) float: in
    [-1, 1] when ``model_domain``, else in [0, 255]. Chroma is upsampled
    by repetition, as OpenCV does."""
    F_, H15, W = yuv.shape
    H = (H15 * 2) // 3
    x = yuv.float()
    y = x[:, :H]
    u = x[:, H:H + H // 4].reshape(F_, H // 2, W // 2)
    v = x[:, H + H // 4:].reshape(F_, H // 2, W // 2)
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    c = 1.164383 * (y - 16.0)
    d = u - 128.0
    e = v - 128.0
    rgb = torch.stack([c + 1.596027 * e,
                       c - 0.391762 * d - 0.812968 * e,
                       c + 2.017232 * d], dim=-1).clamp(0.0, 255.0)
    if model_domain:
        return rgb * (2.0 / 255.0) - 1.0
    return rgb
