"""Image <-> array converters and image files (the reference's
utils/img_util.py:13-155; the port's copy of the JAX package's
utils/img_util.py). Frames are NHWC / HWC numpy arrays here: the data
pipeline runs on the host, and the trainer moves batches to the device.

OpenCV is imported when present; a call that needs it raises an
ImportError that names it when it is not.
"""
from __future__ import annotations

import os
from typing import Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - OpenCV is absent
    cv2 = None


def _cv2(what: str):
    if cv2 is None:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not "
                          f"installed")
    return cv2


def img2arr(img: np.ndarray, bgr2rgb: bool = True,
            mean: float = 0.5, std: float = 0.5) -> np.ndarray:
    """HWC uint8 or float [0, 1] image -> HWC float32 RGB normalized
    ((x - mean) / std; the defaults give [-1, 1])."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    if bgr2rgb and img.shape[2] == 3:
        img = img[..., ::-1]
    return (img - mean) / std


def arr2img(arr: np.ndarray, rgb2bgr: bool = True,
            min_max: Tuple[float, float] = (-1, 1)) -> np.ndarray:
    """NHWC (the first image) or HWC float RGB -> HWC uint8, BGR by
    default (tensor2img, img_util.py:42-98)."""
    arr = np.asarray(arr, dtype=np.float32)
    if arr.ndim == 4:
        arr = arr[0]
    arr = np.clip(arr, *min_max)
    arr = (arr - min_max[0]) / (min_max[1] - min_max[0])
    if rgb2bgr and arr.shape[-1] == 3:
        arr = arr[..., ::-1]
    return (arr * 255.0).round().astype(np.uint8)


def imread(path: str, float32: bool = False) -> np.ndarray:
    """An image file as BGR HWC (OpenCV's convention); float32 in [0, 1]
    when asked."""
    img = _cv2("imread").imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    if float32:
        img = img.astype(np.float32) / 255.0
    return img


def imwrite(img: np.ndarray, file_path: str, auto_mkdir: bool = True):
    """Write a BGR uint8 image, creating its directory
    (img_util.py:139-155)."""
    if auto_mkdir:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)),
                    exist_ok=True)
    if not _cv2("imwrite").imwrite(file_path, img):
        raise IOError(f"Failed to write image: {file_path}")
