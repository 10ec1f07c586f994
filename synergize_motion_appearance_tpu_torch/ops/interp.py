"""Resampling ops on the reenactment path, in PyTorch.

Counterpart of the parts of ``synergize_motion_appearance_tpu/ops/
interp.py`` that inference reaches, and of its ``resize_nearest``
(``models.extended_blocks.SPADE``). The JAX package writes its warps as
XLA gathers and its resizes as small matmuls; here the warps are
``F.grid_sample`` and the resizes ``F.interpolate`` or the same small
matmuls. Images are NCHW; grids and flows are (B, H, W, 2) with (x, y) in
[-1, 1], the layout ``F.grid_sample`` takes.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def grid_sample(img, grid, align_corners=True, padding_mode="zeros"):
    """Bilinear backward warp: img (B or 1, C, H, W), grid (Bg, Hg, Wg, 2)
    -> (Bg, C, Hg, Wg) in img's dtype. A batch-1 image is read by every
    grid without being copied. Sampling runs in float32, because a
    bfloat16 grid position is off by up to half a pixel at 256 pixels."""
    Bg = grid.shape[0]
    src = img.float()
    if src.shape[0] == 1 and Bg > 1:
        src = src.expand(Bg, -1, -1, -1)
    out = F.grid_sample(src, grid.float(), mode="bilinear",
                        padding_mode=padding_mode,
                        align_corners=align_corners)
    return out.to(img.dtype)


def grid_sample_grouped(img, grids, align_corners=False,
                        padding_mode="zeros"):
    """K-way warp of one image: img (1 or B, C, H, W), grids
    (B, K, Hg, Wg, 2) -> (B, K*C, Hg, Wg), channel k*C + c being
    grid_sample(img, grids[:, k]) channel c."""
    B, K, Hg, Wg, _ = grids.shape
    _, C, H, W = img.shape
    src = img
    if img.shape[0] != 1:
        src = img[:, None].expand(B, K, C, H, W).reshape(B * K, C, H, W)
    out = grid_sample(src, grids.reshape(B * K, Hg, Wg, 2), align_corners,
                      padding_mode)
    return out.reshape(B, K * C, Hg, Wg)


@functools.lru_cache(maxsize=256)
def _linear_resize_matrix(in_size: int, out_size: int, align_corners: bool):
    """(out_size, in_size) 1-D linear interpolation matrix with
    F.interpolate(mode='bilinear')'s source-coordinate math (numpy)."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    for o in range(out_size):
        if align_corners:
            src = 0.0 if out_size == 1 else o * (in_size - 1) / (out_size - 1)
        else:
            src = (o + 0.5) * in_size / out_size - 0.5
            src = min(max(src, 0.0), in_size - 1.0)
        lo = int(np.floor(src))
        hi = min(lo + 1, in_size - 1)
        w = src - lo
        m[o, lo] += 1.0 - w
        m[o, hi] += w
    return m


@functools.lru_cache(maxsize=256)
def resize_tap_plan(in_size: int, out_size: int, align_corners: bool = True):
    """Compact form of the resize matrix: indices ``idx`` (2*out_size,)
    into the input axis and weights ``w`` (out_size, 2*out_size) with
    ``w @ x[idx] == matrix @ x``; each bilinear output reads two taps."""
    full = _linear_resize_matrix(in_size, out_size, align_corners)
    idx = np.zeros(2 * out_size, dtype=np.int64)
    w = np.zeros((out_size, 2 * out_size), dtype=np.float32)
    for o in range(out_size):
        nz = np.nonzero(full[o])[0]
        lo, hi = int(nz[0]), int(nz[-1])
        idx[2 * o] = lo
        idx[2 * o + 1] = hi
        w[o, 2 * o] = full[o, lo]
        w[o, 2 * o + 1] = full[o, hi] if hi != lo else 0.0
    return idx, w


def _separable(x, mh, mw):
    """Apply (h, H) and (w, W) matrices to NCHW ``x``: f32 inputs in f32,
    bf16/f16 inputs in their own dtype, as the JAX package does."""
    dt = x.dtype
    low = dt in (torch.bfloat16, torch.float16)
    cd = dt if low else torch.float32
    mh = torch.as_tensor(mh, dtype=cd, device=x.device)
    mw = torch.as_tensor(mw, dtype=cd, device=x.device)
    y = torch.einsum("oh,bchw->bcow", mh, x.to(cd))
    y = torch.einsum("ow,bchw->bcho", mw, y)
    return y.to(dt)


def resize_bilinear_at(x, out_hw, rows, cols, align_corners=True):
    """``resize_bilinear(x, out_hw)[:, :, rows][:, :, :, cols]`` without
    the full resize (NCHW)."""
    _, _, H, W = x.shape
    h, w = out_hw
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if (H, W) == (h, w):
        ri = torch.as_tensor(rows, device=x.device)
        ci = torch.as_tensor(cols, device=x.device)
        return x.index_select(2, ri).index_select(3, ci)
    mh = _linear_resize_matrix(H, h, align_corners)[rows]
    mw = _linear_resize_matrix(W, w, align_corners)[cols]
    return _separable(x, mh, mw)


def tap_reduce(x, wy, wx):
    """(B, C, 2h, 2w) taps gathered at `resize_tap_plan` positions ->
    (B, C, h, w) with the plan's weights."""
    return _separable(x, wy, wx)


def resize_bilinear(x, out_hw, align_corners=True):
    """(B, C, H, W) -> (B, C, h, w), F.interpolate(mode='bilinear').
    bf16/f16 inputs resize in their dtype; others in float32."""
    h, w = out_hw
    if tuple(x.shape[2:]) == (h, w):
        return x
    dt = x.dtype
    cd = dt if dt in (torch.bfloat16, torch.float16) else torch.float32
    y = F.interpolate(x.to(cd), size=(h, w), mode="bilinear",
                      align_corners=align_corners)
    return y.to(dt)


def interpolate_flow(flow, out_hw):
    """Resize a (B, H, W, 2) flow field, bilinear with align_corners=True."""
    if tuple(flow.shape[1:3]) == tuple(out_hw):
        return flow
    return resize_bilinear(flow.permute(0, 3, 1, 2), out_hw,
                           True).permute(0, 2, 3, 1)


def upsample_nearest(x, factor=2):
    """F.interpolate(scale_factor=factor), nearest, on NCHW."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


def resize_nearest(x, out_hw):
    """(B, C, H, W) -> (B, C, h, w), nearest: rows floor(i * H / h) and
    columns floor(j * W / w), as F.interpolate(mode='nearest') picks them
    (the JAX ``resize_nearest``, interp.py:488-497); the identity when
    the size is unchanged."""
    _, _, H, W = x.shape
    h, w = out_hw
    if (H, W) == (h, w):
        return x
    iy = torch.from_numpy(np.floor(np.arange(h) * H / h).astype(np.int64))
    ix = torch.from_numpy(np.floor(np.arange(w) * W / w).astype(np.int64))
    return x[:, :, iy.to(x.device)][:, :, :, ix.to(x.device)]


def avg_pool_2x(x):
    """nn.AvgPool2d(2) on NCHW."""
    return F.avg_pool2d(x, 2)
