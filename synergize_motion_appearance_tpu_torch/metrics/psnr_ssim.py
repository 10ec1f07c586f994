"""PSNR / SSIM / L1 (the reference's metrics/psnr_ssim.py; the port's copy
of the JAX package's metrics/psnr_ssim.py).

numpy and scipy on uint8-range images, as the reference's protocol runs
them: HWC (or CHW), an optional crop_border, optionally the Y channel.
"""
from __future__ import annotations

import numpy as np

from ..utils.registry import METRIC_REGISTRY


def _reorder(img, input_order):
    if input_order == "CHW":
        return img.transpose(1, 2, 0)
    return img


def _to_y(img):
    """BGR uint8-range -> Y channel of YCbCr (matlab convention),
    metrics/metric_util.py via utils/matlab_functions.py:169."""
    img = img.astype(np.float64) / 255.0
    y = (np.dot(img[..., ::-1], [65.481, 128.553, 24.966]) + 16.0)
    return y[..., None]


def _prep(img1, img2, crop_border, input_order, test_y_channel=False):
    assert img1.shape == img2.shape, \
        f"Image shapes differ: {img1.shape} vs {img2.shape}"
    img1 = _reorder(np.asarray(img1), input_order).astype(np.float64)
    img2 = _reorder(np.asarray(img2), input_order).astype(np.float64)
    if crop_border != 0:
        img1 = img1[crop_border:-crop_border, crop_border:-crop_border, ...]
        img2 = img2[crop_border:-crop_border, crop_border:-crop_border, ...]
    if test_y_channel:
        img1, img2 = _to_y(img1), _to_y(img2)
    return img1, img2


@METRIC_REGISTRY.register()
def calculate_psnr(img1, img2, crop_border=0, input_order="HWC",
                   test_y_channel=False, **kwargs):
    img1, img2 = _prep(img1, img2, crop_border, input_order, test_y_channel)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20.0 * np.log10(255.0 / np.sqrt(mse))


@METRIC_REGISTRY.register()
def calculate_l1(img1, img2, crop_border=0, input_order="HWC", **kwargs):
    img1, img2 = _prep(img1, img2, crop_border, input_order)
    return float(np.mean(np.abs(img1 - img2)))


def _gaussian_window_11():
    """cv2.getGaussianKernel(11, 1.5) outer product."""
    ax = np.arange(11) - 5.0
    k = np.exp(-(ax ** 2) / (2 * 1.5 ** 2))
    k = k / k.sum()
    return np.outer(k, k)


def _filter2d_same(img, window):
    """cv2.filter2D(ddepth=-1, borderType=REFLECT_101 default) equivalent."""
    from scipy.ndimage import correlate

    return correlate(img, window, mode="mirror")


def _ssim_single(img1, img2):
    C1 = (0.01 * 255) ** 2
    C2 = (0.03 * 255) ** 2
    window = _gaussian_window_11()
    mu1 = _filter2d_same(img1, window)[5:-5, 5:-5]
    mu2 = _filter2d_same(img2, window)[5:-5, 5:-5]
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter2d_same(img1 ** 2, window)[5:-5, 5:-5] - mu1_sq
    sigma2_sq = _filter2d_same(img2 ** 2, window)[5:-5, 5:-5] - mu2_sq
    sigma12 = _filter2d_same(img1 * img2, window)[5:-5, 5:-5] - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )
    return ssim_map.mean()


@METRIC_REGISTRY.register()
def calculate_ssim(img1, img2, crop_border=0, input_order="HWC",
                   test_y_channel=False, **kwargs):
    img1, img2 = _prep(img1, img2, crop_border, input_order, test_y_channel)
    return float(np.mean([
        _ssim_single(img1[..., i], img2[..., i])
        for i in range(img1.shape[2])
    ]))
