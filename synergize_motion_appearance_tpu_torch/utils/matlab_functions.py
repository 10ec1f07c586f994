"""MATLAB's bicubic imresize (antialiased when downscaling) and its YCbCr
conversions (the reference's utils/matlab_functions.py:86-347; the port's
copy of the JAX package's). They exist for metrics comparable with
published numbers that used MATLAB's conventions. Host numpy in float64.
"""
from __future__ import annotations

import numpy as np


def cubic(x):
    """Matlab cubic interpolation kernel (a = -0.5)."""
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return ((1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1)
            + (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2)
            * ((absx > 1) & (absx <= 2)))


def _contributions(in_length, out_length, scale, kernel_width,
                   antialiasing=True):
    """MATLAB calculate_weights_indices (reference
    utils/matlab_functions.py:17-83): 1-based tap indices that may run
    past either end — the caller extends the image SYMMETRICALLY
    (MATLAB boundary), not by clamping. Returns (weights, 0-based
    indices into the sym-extended image, pad_start, pad_end)."""
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale
    x = np.arange(1, out_length + 1).astype(np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p)[None, :]  # 1-based
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * cubic(dist * scale)
    else:
        weights = cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)
    # trim only the first/last column when all-zero (reference :70-76)
    zero_cols = np.sum(weights == 0, axis=0)
    if not np.isclose(zero_cols[0], 0):
        indices = indices[:, 1:p - 1]
        weights = weights[:, 1:p - 1]
    elif not np.isclose(zero_cols[-1], 0):
        indices = indices[:, 0:p - 2]
        weights = weights[:, 0:p - 2]
    sym_len_s = int(-indices.min() + 1)
    sym_len_e = int(indices.max() - in_length)
    indices = (indices + sym_len_s - 1).astype(np.int64)
    return weights, indices, max(sym_len_s, 0), max(sym_len_e, 0)


def _sym_extend(arr, pad_s, pad_e, axis):
    """MATLAB 'symmetric' boundary (reflect INCLUDING the edge pixel,
    reference imresize :118-136)."""
    if pad_s == 0 and pad_e == 0:
        return arr
    return np.pad(
        arr,
        [(pad_s, pad_e) if a == axis else (0, 0) for a in range(arr.ndim)],
        mode="symmetric",
    )


def imresize(img: np.ndarray, scale: float,
             antialiasing: bool = True) -> np.ndarray:
    """MATLAB-style bicubic imresize (reference
    utils/matlab_functions.py:86-166): symmetric boundary extension,
    antialiased when downscaling. HWC (or HW) float/uint8."""
    img = np.asarray(img)
    in_dtype = img.dtype
    imgf = img.astype(np.float64)
    if imgf.ndim == 2:
        imgf = imgf[..., None]
    h, w, c = imgf.shape
    out_h = int(np.ceil(h * scale))
    out_w = int(np.ceil(w * scale))

    wts_h, idx_h, hs, he = _contributions(h, out_h, scale, 4.0,
                                          antialiasing)
    wts_w, idx_w, ws, we = _contributions(w, out_w, scale, 4.0,
                                          antialiasing)
    ext = _sym_extend(imgf, hs, he, axis=0)
    # rows: ext[idx_h] has shape (out_h, taps, w, c)
    tmp = np.einsum("op,opwc->owc", wts_h, ext[idx_h])
    tmp = _sym_extend(tmp, ws, we, axis=1)
    # cols: tmp[:, idx_w] has shape (out_h, out_w, taps, c)
    out = np.einsum("op,hopc->hoc", wts_w, tmp[:, idx_w])
    if in_dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    if img.ndim == 2:
        out = out[..., 0]
    return out


def rgb2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    """RGB -> YCbCr, matlab convention; img float [0,1] or uint8."""
    img = np.asarray(img)
    in_uint8 = img.dtype == np.uint8
    imgf = img.astype(np.float64) / (255.0 if in_uint8 else 1.0)
    if y_only:
        out = np.dot(imgf, [65.481, 128.553, 24.966]) + 16.0
    else:
        out = np.matmul(imgf, np.array([
            [65.481, -37.797, 112.0],
            [128.553, -74.203, -93.786],
            [24.966, 112.0, -18.214],
        ])) + [16, 128, 128]
    if in_uint8:
        return out.round().astype(np.uint8)
    return out / 255.0


def bgr2ycbcr(img: np.ndarray, y_only: bool = False) -> np.ndarray:
    img = np.asarray(img)[..., ::-1]
    return rgb2ycbcr(img, y_only)


def ycbcr2rgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    in_uint8 = img.dtype == np.uint8
    imgf = img.astype(np.float64) / (255.0 if in_uint8 else 1.0) * 255.0
    mat = np.array([
        [0.00456621, 0.00456621, 0.00456621],
        [0, -0.00153632, 0.00791071],
        [0.00625893, -0.00318811, 0],
    ]) * 255.0
    out = np.matmul(imgf, mat) + [-222.921, 135.576, -276.836]
    out /= 255.0
    if in_uint8:
        return np.clip(out * 255.0, 0, 255).round().astype(np.uint8)
    return out
