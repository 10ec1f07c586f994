"""Coordinate grids, keypoint gaussians, soft-argmax, anti-alias downsample
(on the device, and its host versions in numpy and OpenCV) and the
convex-hull area, in PyTorch.

Counterpart of ``synergize_motion_appearance_tpu/ops/coords.py``. Images
are NCHW here; grids are (h, w, 2) with (x, y) in [-1, 1].
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def make_coordinate_grid(h: int, w: int, dtype=torch.float32, device=None):
    """(h, w, 2) meshgrid of (x, y) in [-1, 1], computed in ``dtype`` as
    2 * (arange / (n - 1)) - 1 (the reference's form, whose rounding the
    JAX package keeps)."""
    x = 2.0 * (torch.arange(w, dtype=dtype, device=device) / (w - 1)) - 1.0
    y = 2.0 * (torch.arange(h, dtype=dtype, device=device) / (h - 1)) - 1.0
    xx = x[None, :].expand(h, w)
    yy = y[:, None].expand(h, w)
    return torch.stack([xx, yy], dim=-1)


def kp2gaussian(kp_value, spatial_size, kp_variance):
    """(..., K, 2) keypoints -> (..., K, h, w) isotropic gaussians."""
    h, w = spatial_size
    grid = make_coordinate_grid(h, w, kp_value.dtype, kp_value.device)
    lead = kp_value.shape[:-1]
    grid = grid.reshape((1,) * len(lead) + (h, w, 2))
    mean = kp_value.reshape(lead + (1, 1, 2))
    diff = grid - mean
    return torch.exp(-0.5 * (diff ** 2).sum(-1) / kp_variance)


def softargmax_kp(heatmap):
    """(B, K, H, W) normalized heatmaps -> (B, K, 2) keypoints."""
    _, _, H, W = heatmap.shape
    grid = make_coordinate_grid(H, W, heatmap.dtype, heatmap.device)
    return torch.einsum("bkhw,hwc->bkc", heatmap, grid)


@functools.lru_cache(maxsize=32)
def _gaussian_kernel(scale: float):
    """(2-D kernel (k, k) float32, ka, kb, stride) of the reference's
    AntiAliasInterpolation2d (motion_estimator_util.py:599-645)."""
    sigma = (1.0 / scale - 1.0) / 2.0
    kernel_size = 2 * round(sigma * 4) + 1
    ka = kernel_size // 2
    kb = ka - 1 if kernel_size % 2 == 0 else ka
    ax = np.arange(kernel_size, dtype=np.float32)
    mean = (kernel_size - 1) / 2.0
    k1 = np.exp(-((ax - mean) ** 2) / (2.0 * sigma ** 2))
    k2 = np.outer(k1, k1)
    k2 = (k2 / k2.sum()).astype(np.float32)
    return k2, ka, kb, int(round(1.0 / scale))


def antialias_weight(channels: int, scale: float) -> torch.Tensor:
    """The fixed depthwise blur buffer (channels, 1, k, k)."""
    k2 = _gaussian_kernel(scale)[0]
    return torch.from_numpy(np.tile(k2[None, None], (channels, 1, 1, 1)))


def antialias_downsample(x, scale: float, weight=None):
    """Gaussian blur + stride on NCHW ``x``: pad (ka, kb) each side,
    depthwise conv, keep every s-th row and column. ``weight`` is the
    (C, 1, k, k) blur buffer; computed from ``scale`` when omitted."""
    if scale == 1.0:
        return x
    _, ka, kb, s = _gaussian_kernel(scale)
    if weight is None:
        weight = antialias_weight(x.shape[1], scale)
    weight = weight.to(device=x.device, dtype=x.dtype)
    out = F.pad(x, (ka, kb, ka, kb))
    out = F.conv2d(out, weight, groups=x.shape[1])
    return out[:, :, ::s, ::s]


def _strided_blur_matrix(n: int, k1: np.ndarray, ka: int, s: int
                         ) -> np.ndarray:
    """(n/s, n) matrix of a zero-padded 1-D gaussian blur followed by
    stride-s subsampling: row i holds the kernel centred at i*s."""
    m = np.zeros((n // s, n), dtype=np.float32)
    for i in range(n // s):
        for t, kv in enumerate(k1):
            j = i * s + t - ka
            if 0 <= j < n:
                m[i, j] = kv
    return m


def _separable_kernel(scale: float):
    """(1-D factor of the blur kernel, ka, kb, stride)."""
    k2, ka, kb, s = _gaussian_kernel(scale)
    return (k2[ka] / np.sqrt(k2[ka, ka])).astype(np.float32), ka, kb, s


def antialias_downsample_host(frames: np.ndarray, scale: float
                              ) -> np.ndarray:
    """``antialias_downsample`` on the host, in numpy: the same kernel, pad
    and stride on (F, H, W, C) float32 frames (already normalized), as two
    matrix products over the whole batch. Returns (F, H/s, W/s, C)."""
    if scale == 1.0:
        return frames
    k1, ka, _, s = _separable_kernel(scale)
    F_, H, W, C = frames.shape
    A = _strided_blur_matrix(H, k1, ka, s)            # (H/s, H)
    Bm = _strided_blur_matrix(W, k1, ka, s)           # (W/s, W)
    x = frames.transpose(1, 0, 2, 3).reshape(H, F_ * W * C)
    y = (A @ x).reshape(H // s, F_, W, C)             # vertical pass
    y = y.transpose(2, 1, 0, 3).reshape(W, F_ * (H // s) * C)
    z = (Bm @ y).reshape(W // s, F_, H // s, C)       # horizontal pass
    return np.ascontiguousarray(z.transpose(1, 2, 0, 3))


def blur_stride_u8(frames: np.ndarray, scale: float) -> np.ndarray:
    """The same downsample on (F, H, W, C) uint8 frames with OpenCV's
    separable filter and a mid-gray border (128 is the float path's zero
    pad in [-1, 1]): uint8 out, within one level of
    ``antialias_downsample_host``. Needs OpenCV; raises a RuntimeError
    that says so without it."""
    if scale == 1.0:
        return frames
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("blur_stride_u8 needs OpenCV (cv2), which is "
                           "not installed; pass float frames to use "
                           "antialias_downsample_host") from e
    k1, ka, kb, s = _separable_kernel(scale)
    k1 = k1.reshape(-1, 1)
    F_, H, W, C = frames.shape
    out = np.empty((F_, H // s, W // s, C), np.uint8)
    for i, f in enumerate(frames):
        p = cv2.copyMakeBorder(f, ka, kb, ka, kb, cv2.BORDER_CONSTANT,
                               value=(128, 128, 128))
        b = cv2.sepFilter2D(p, -1, k1, k1)
        out[i] = b[ka:-kb or None, ka:-kb or None][::s, ::s]
    return out


def convex_hull_area(points):
    """Area of the convex hull of (K, 2) points, without leaving the
    device: the directed edge i->j is a hull edge iff every point lies on
    its left; the area is half the sum of cross(p_i, p_j) over hull edges
    (the JAX package's O(K^3) form, ops/coords.py:171)."""
    pts = points.float()
    K = pts.shape[0]
    pi = pts[:, None, :]
    pj = pts[None, :, :]
    d1 = pj - pi                                        # (K, K, 2)
    d2 = pts[None, None, :, :] - pi[:, :, None, :]      # (K, K, K, 2)
    cross = d1[..., None, 0] * d2[..., 1] - d1[..., None, 1] * d2[..., 0]
    eps = 1e-9
    all_left = (cross >= -eps).all(dim=-1)
    not_self = ~torch.eye(K, dtype=torch.bool, device=pts.device)
    nonzero = (d1 ** 2).sum(-1) > eps
    is_edge = all_left & not_self & nonzero
    edge_cross = pi[..., 0] * pj[..., 1] - pi[..., 1] * pj[..., 0]
    return 0.5 * torch.where(is_edge, edge_cross,
                             torch.zeros_like(edge_cross)).sum()
