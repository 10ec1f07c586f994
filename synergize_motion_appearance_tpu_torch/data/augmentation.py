"""Clip-level video augmentation (the reference's data/augmentation.py:
1-398; the port's copy of the JAX package's): flip, rotate, resize, crop,
colour jitter and zoom, each drawn once per clip from Python's ``random``
and applied alike to every frame, and AllAugmentationTransform, which
chains them. Frames are HWC float numpy arrays in [0, 1], on the host.

The flagship training config augments with ``transforms.augment_video``;
this module serves the configs of the FOMM-style pipeline. Resize, rotate,
zoom and hue need OpenCV, imported when they run: without it they raise a
RuntimeError that names it.
"""
from __future__ import annotations

import random
from typing import List

import numpy as np

from ..utils.misc import require

Clip = List[np.ndarray]  # HWC float frames in [0, 1]


class RandomFlip:
    def __init__(self, time_flip: bool = False, horizontal_flip: bool = True):
        self.time_flip = time_flip
        self.horizontal_flip = horizontal_flip

    def __call__(self, clip: Clip) -> Clip:
        if random.random() < 0.5 and self.time_flip:
            clip = clip[::-1]
        if random.random() < 0.5 and self.horizontal_flip:
            clip = [np.ascontiguousarray(img[:, ::-1]) for img in clip]
        return clip


class RandomResize:
    """Every frame scaled by one factor drawn from ``ratio``, with
    ``interpolation`` "nearest" (else bilinear)."""

    def __init__(self, ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation: str = "nearest"):
        self.ratio = ratio
        self.interpolation = interpolation

    def __call__(self, clip: Clip) -> Clip:
        cv2 = require("cv2", "RandomResize")
        interp = (cv2.INTER_NEAREST if self.interpolation == "nearest"
                  else cv2.INTER_LINEAR)
        scale = random.uniform(self.ratio[0], self.ratio[1])
        h, w = clip[0].shape[:2]
        nh, nw = int(scale * h), int(scale * w)
        return [cv2.resize(img, (nw, nh), interpolation=interp)
                for img in clip]


class RandomCrop:
    def __init__(self, size):
        self.size = size  # (h, w)

    def __call__(self, clip: Clip) -> Clip:
        ch, cw = self.size
        h, w = clip[0].shape[:2]
        if ch > h or cw > w:
            raise ValueError("crop size larger than frame")
        y = random.randint(0, h - ch)
        x = random.randint(0, w - cw)
        return [img[y:y + ch, x:x + cw] for img in clip]


class RandomRotation:
    """Every frame rotated about its centre by one angle drawn from
    ``degrees`` ((-d, d) for a number), zeros outside."""

    def __init__(self, degrees):
        if isinstance(degrees, (int, float)):
            degrees = (-degrees, degrees)
        self.degrees = degrees

    def __call__(self, clip: Clip) -> Clip:
        cv2 = require("cv2", "RandomRotation")
        angle = random.uniform(*self.degrees)
        h, w = clip[0].shape[:2]
        mat = cv2.getRotationMatrix2D((w / 2, h / 2), angle, 1.0)
        return [cv2.warpAffine(img, mat, (w, h)) for img in clip]


class ColorJitter:
    """Brightness, contrast and saturation factors and a hue shift, drawn
    once per clip; a factor of 0 leaves its property alone."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue

    def _params(self):
        def factor(amount):
            return (random.uniform(max(0, 1 - amount), 1 + amount)
                    if amount > 0 else 1.0)

        b = factor(self.brightness)
        c = factor(self.contrast)
        s = factor(self.saturation)
        h = random.uniform(-self.hue, self.hue) if self.hue > 0 else 0.0
        return b, c, s, h

    def __call__(self, clip: Clip) -> Clip:
        b, c, s, h = self._params()
        out = []
        for img in clip:
            x = img.astype(np.float32) * b
            mean = x.mean(axis=(0, 1), keepdims=True)
            x = (x - mean) * c + mean
            gray = x.mean(axis=2, keepdims=True)
            x = (x - gray) * s + gray
            if h != 0:
                cv2 = require("cv2", "ColorJitter's hue")
                hsv = cv2.cvtColor(np.clip(x, 0, 1), cv2.COLOR_RGB2HSV)
                hsv[..., 0] = (hsv[..., 0] + h * 360.0) % 360.0
                x = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
            out.append(np.clip(x, 0, 1))
        return out


class RandomZoom:
    """Every frame scaled by one factor drawn from ``zoom_range``, then
    centre-cropped (zoom in) or edge-padded (zoom out) to its size."""

    def __init__(self, zoom_range=(0.9, 1.1)):
        self.zoom_range = zoom_range

    def __call__(self, clip: Clip) -> Clip:
        cv2 = require("cv2", "RandomZoom")
        z = random.uniform(*self.zoom_range)
        h, w = clip[0].shape[:2]
        nh, nw = int(h * z), int(w * z)
        out = []
        for img in clip:
            scaled = cv2.resize(img, (nw, nh),
                                interpolation=cv2.INTER_LINEAR)
            if z >= 1:
                y0, x0 = (nh - h) // 2, (nw - w) // 2
                out.append(scaled[y0:y0 + h, x0:x0 + w])
            else:
                py, px = (h - nh) // 2, (w - nw) // 2
                out.append(np.pad(
                    scaled, ((py, h - nh - py), (px, w - nw - px), (0, 0)),
                    mode="edge"))
        return out


class AllAugmentationTransform:
    """flip -> rotate -> resize -> crop -> jitter, each stage present when
    its parameter dict is given (augmentation.py:372-398)."""

    def __init__(self, resize_param=None, rotation_param=None,
                 flip_param=None, crop_param=None, jitter_param=None):
        stages = ((RandomFlip, flip_param), (RandomRotation, rotation_param),
                  (RandomResize, resize_param), (RandomCrop, crop_param),
                  (ColorJitter, jitter_param))
        self.transforms = [cls(**param) for cls, param in stages
                           if param is not None]

    def __call__(self, clip: Clip) -> Clip:
        for t in self.transforms:
            clip = t(clip)
        return clip
